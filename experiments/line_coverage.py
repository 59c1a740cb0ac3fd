"""Line coverage for qoaudio_tpu under pytest (no external deps).

The environment ships no coverage.py/pytest-cov; Python 3.12's
sys.monitoring provides cheap LINE events instead.  Executable lines
come from the compiled code objects' co_lines tables.  Expected-zero
files on the CPU-forced suite: the GPU kernels' grid plumbing in
ops/pallas_* (gpu-marked tests), utils/timing.py (bench-only),
parallel/mesh.py mostly (exercised in the uninstrumented 8-device
subprocess dryrun).

Round-4 sweep results: 78.6% -> 81.8% -> 84.2% total after two rounds of
gap-driven test additions (test_error_paths.py, test_edge_coverage.py);
the first round also surfaced a real bug (the play command's format
handling at segment boundaries).  At 84.2% the remaining gaps are the
expected-zero files above plus the GPU-only corpus branches.
Usage: python experiments/line_coverage.py
"""
import os
import sys

import os as _os
sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

PKG = _os.path.join(sys.path[0], "qoaudio_tpu")
hits = {}  # filename -> set of lines

TOOL = sys.monitoring.PROFILER_ID
sys.monitoring.use_tool_id(TOOL, "qoacov")


def on_line(code, line):
    fn = code.co_filename
    if fn.startswith(PKG):
        hits.setdefault(fn, set()).add(line)
    else:
        return sys.monitoring.DISABLE  # stop monitoring this code object


sys.monitoring.register_callback(
    TOOL, sys.monitoring.events.LINE, on_line
)
sys.monitoring.set_events(TOOL, sys.monitoring.events.LINE)

import pytest  # noqa: E402

rc = pytest.main(["-q", "-x", _os.path.join(sys.path[0], "tests"), "-p", "no:cacheprovider"])

sys.monitoring.set_events(TOOL, 0)

# executable lines per file from code objects
import ast  # noqa: E402

report = {}
for root, _, files in os.walk(PKG):
    if "__pycache__" in root:
        continue
    for f in sorted(files):
        if not f.endswith(".py"):
            continue
        path = os.path.join(root, f)
        src = open(path).read()
        code = compile(src, path, "exec")
        exe = set()
        stack = [code]
        while stack:
            c = stack.pop()
            for start, _end, line in c.co_lines():
                if line is not None:
                    exe.add(line)
            for const in c.co_consts:
                if hasattr(const, "co_lines"):
                    stack.append(const)
        got = hits.get(path, set())
        missing = sorted(exe - got)
        report[path] = (len(exe), len(exe - got), missing)

print("\n=== coverage report (package lines) ===")
tot_e = tot_m = 0
for path, (n_exe, n_miss, missing) in sorted(report.items()):
    tot_e += n_exe
    tot_m += n_miss
    pct = 100.0 * (n_exe - n_miss) / max(n_exe, 1)
    print(f"{path[len(PKG)+1:]:32s} {pct:5.1f}%  missing {n_miss}/{n_exe}")
print(f"TOTAL {100.0*(tot_e-tot_m)/max(tot_e,1):.1f}%  missing {tot_m}/{tot_e}")

import json  # noqa: E402

with open("/tmp/cov_missing.json", "w") as f:
    json.dump({p: m for p, (_, _, m) in report.items()}, f)
print("missing-line detail -> /tmp/cov_missing.json")
sys.exit(rc)
