"""chip_smoke.py's contract and phase functions, at a tiny size on the CPU.

On the card the script runs the GPU encode kernel; here the phase
functions run with the XLA encode kernel, which checks their comparisons
and control flow.  ``main`` itself must
fail (non-zero, no result line) wherever JAX finds no GPU, and the script
alone, without the package, must fail too.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from qoaudio_tpu import codec
from qoaudio_tpu.ops.encode import encode_frames
from qoaudio_tpu.types import QoaDesc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

from conftest import make_noise  # noqa: E402


def _run_script(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("QOA_TEST_GPU", None)
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def _no_result(stdout):
    for line in stdout.splitlines():
        try:
            if "ok" in json.loads(line):
                return False
        except (ValueError, TypeError):
            continue
    return True


def test_main_exits_nonzero_without_gpu():
    proc = _run_script(ROOT, "chip_smoke.py")
    assert proc.returncode != 0
    assert "needs an NVIDIA GPU" in proc.stderr + proc.stdout
    assert _no_result(proc.stdout)


def test_script_alone_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    proc = _run_script(str(tmp_path), "chip_smoke.py")
    assert proc.returncode != 0
    assert _no_result(proc.stdout)


def _tiny_source():
    pcm = make_noise(9000, 2, seed=5, amplitude=12000)
    return pcm, 2, 9000


def test_build_corpus_is_seeded_and_shaped():
    pcm, ch, spc = _tiny_source()
    a = chip_smoke.build_corpus(pcm, ch, spc, seed=3, n_full=2, n_clips=5,
                                full_samples=6000, clip_seconds=(0.01, 0.05))
    b = chip_smoke.build_corpus(pcm, ch, spc, seed=3, n_full=2, n_clips=5,
                                full_samples=6000, clip_seconds=(0.01, 0.05))
    c = chip_smoke.build_corpus(pcm, ch, spc, seed=4, n_full=2, n_clips=5,
                                full_samples=6000, clip_seconds=(0.01, 0.05))
    assert len(a) == 7
    assert all(np.array_equal(x, y) and d == e for (x, d), (y, e) in zip(a, b))
    assert not all(np.array_equal(x, y) for (x, _), (y, _) in zip(a, c))
    for pcm_i, d in a:
        assert pcm_i.dtype == np.int16 and pcm_i.size == d.samples * d.channels
    assert all(d == QoaDesc(2, 44100, 6000) for _, d in a[:2])
    for _, d in a[2:]:
        assert d.channels in (1, 2) and d.sample_rate in (22050, 44100, 48000)
        assert int(0.01 * d.sample_rate) <= d.samples <= int(0.05 * d.sample_rate)


def test_phase_kernels_tiny_cpu():
    from qoaudio_tpu.bitstream import parse_file_arrays
    from qoaudio_tpu.parallel import corpus

    pcm, ch, spc = _tiny_source()
    files = chip_smoke.build_corpus(pcm, ch, spc, seed=1, n_full=1, n_clips=2,
                                    full_samples=6000, clip_seconds=(0.01, 0.03))
    streams = chip_smoke.host_encode(files)
    parsed = [parse_file_arrays(s) for s in streams]
    offs = np.cumsum([0] + [p.n_frames * p.channels for p in parsed])
    words_be, dstate = corpus._stage_words(
        parsed, offs[:-1], max(p.max_windows for p in parsed), int(offs[-1])
    )
    res = chip_smoke.phase_kernels(
        encode_frames, pcm, ch, spc, words_be, dstate,
        n_chains=4, frames=2, runs=1,
    )
    assert all(res[k] > 0 for k in ("encode_kernel_s", "encode_xla_s", "decode_xla_s"))


def test_phase_kernels_reports_mismatch():
    pcm, ch, spc = _tiny_source()

    @jax.jit
    def broken(state, samples, lens):
        st, snaps, hi, lo = encode_frames(state, samples, lens)
        return st, snaps, hi ^ 1, lo

    with pytest.raises(AssertionError, match="mismatches"):
        chip_smoke.phase_kernels(
            broken, pcm, ch, spc, None, None, n_chains=2, frames=1, runs=1
        )


def test_phase_transcode_tiny_cpu(capsys):
    pcm, ch, spc = _tiny_source()
    files = chip_smoke.build_corpus(pcm, ch, spc, seed=2, n_full=1, n_clips=3,
                                    full_samples=5500, clip_seconds=(0.01, 0.03))
    streams = chip_smoke.host_encode(files)
    assert streams == [codec.encode_all(p, d) for p, d in files]
    res = chip_smoke.phase_transcode(files, streams, cli_files=2, warm=1)
    out = capsys.readouterr().out
    assert "cli transcode --hbm: 2 outputs byte-identical" in out
    for step in ("encode", "transcode"):
        assert f"batch_{step} (device)" in out and f"batch_{step} (xla)" in out
        assert res[f"batch_{step}_device_s"] > 0 and res[f"batch_{step}_xla_s"] > 0
    assert "batch_decode (device)" in out and "batch_decode (host engine)" in out
    assert res["batch_decode_host_s"] > 0
    assert res["total_samples"] == sum(d.samples * d.channels for _, d in files)


def test_expect_equal_names_the_differences():
    with pytest.raises(AssertionError, match="1 of 3 outputs differ"):
        chip_smoke.expect_equal("x", [b"a", b"b", b"c"], [b"a", b"B", b"c"])


def test_dispatch_cost_measures_a_fused_handle():
    assert chip_smoke.dispatch_cost(runs=2) > 0


def test_encode_marginal_cost_is_a_slope_per_lane_frame():
    pcm, ch, spc = _tiny_source()
    cost = chip_smoke.encode_marginal_cost(
        encode_frames, pcm, ch, spc, widths=(2, 4), frames=1, runs=1
    )
    assert np.isfinite(cost)
