#!/usr/bin/env python
"""Bring-up check of the device transcode on NVIDIA GPUs, end to end.

    python chip_smoke.py [--seed N]        # one GPU: phases 0-3
    python chip_smoke.py --four-cards      # four GPUs: the mesh path only

Everything runs in this one process; any failure propagates and the exit
code is non-zero.  Phases:

0. Device: the platform must be ``gpu``; prints the card, its power limit,
   JAX, the host CPU and native build tier, and the compile cache.
1. Kernels at real widths: the GPU encode kernel against the plain XLA
   kernel, and the device decoder (XLA) against the native engine: zero
   mismatched elements, median times, compile times and
   ``memory_analysis()``.
2. An audio bank generated from ``--seed`` out of the in-repo fixture
   (96 full-length stereo variants + 64 clips) through the public entry
   points: ``batch_encode``, ``batch_decode``, ``batch_transcode`` and the
   CLI's ``transcode --hbm``, each byte-compared with the host engine.
3. The ``gpu``-marked tests (``pytest -m gpu``) in this process.

The last stdout line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from qoaudio_tpu import codec  # noqa: E402
from qoaudio_tpu.types import QoaDesc  # noqa: E402

FIXTURE = os.path.join(ROOT, "tests", "fixtures", "julien_baker_sprained_ankle.qoa")
EXACT = "int32/uint32 throughout: zero mismatched elements required, no float or TF32 path"


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ set-up


def load_fixture():
    """(interleaved int16 PCM, channels, samples per channel)."""
    with open(FIXTURE, "rb") as f:
        out = codec.decode_all(f.read())
    return out.samples, out.num_channels, out.samples_per_channel


def build_corpus(pcm, channels, spc, seed, n_full=96, n_clips=64,
                 full_samples=None, clip_seconds=(0.25, 8.0)):
    """Audio bank from the fixture: ``n_full`` stereo variants of
    ``full_samples`` (default: the whole fixture) samples/ch, each with its
    own gain, circular offset and channel swap, then ``n_clips`` clips of
    ``clip_seconds`` at 22.05/44.1/48 kHz, mono or stereo."""
    rng = np.random.default_rng(seed)
    stereo = np.asarray(pcm).reshape(spc, channels)
    full = full_samples or spc
    files = []
    for _ in range(n_full):
        gain = rng.uniform(0.3, 1.0)
        start = int(rng.integers(0, spc))
        idx = (start + np.arange(full)) % spc
        x = stereo[idx]
        if rng.random() < 0.5:
            x = x[:, ::-1]
        x = np.clip(np.rint(x * gain), -32768, 32767).astype(np.int16)
        files.append((x.reshape(-1), QoaDesc(2, 44100, full)))
    for _ in range(n_clips):
        rate = int(rng.choice([22050, 44100, 48000]))
        ch = int(rng.integers(1, 3))
        n = max(1, int(rng.uniform(*clip_seconds) * rate))
        start = int(rng.integers(0, spc))
        idx = (start + np.arange(n)) % spc
        gain = rng.uniform(0.3, 1.0)
        x = np.clip(np.rint(stereo[idx, :ch] * gain), -32768, 32767)
        files.append((x.astype(np.int16).reshape(-1), QoaDesc(ch, rate, n)))
    return files


def host_map(fn, items):
    """``[fn(x) for x in items]`` on a thread pool (the native engine runs
    outside the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as ex:
        return list(ex.map(fn, items))


def host_encode(files):
    """Host-engine streams of ``files`` (``codec.encode_all_batch``)."""
    groups = [files[i : i + 4] for i in range(0, len(files), 4)]
    return [s for g in host_map(codec.encode_all_batch, groups) for s in g]


def host_pair(decoded):
    """Host re-encode of decoded streams: the host decode->encode pair."""
    return host_encode(
        [
            (o.samples, QoaDesc(o.num_channels, o.sample_rate, o.samples_per_channel))
            for o in decoded
        ]
    )


def expect_equal(name, got, want):
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    if len(got) != len(want) or bad:
        raise AssertionError(
            f"{name}: {len(bad)} of {len(want)} outputs differ (first {bad[:5]})"
        )
    log(f"  {name}: {len(want)} outputs byte-identical to the host engine")


def expect_same_pcm(name, got, want):
    bad = [
        i for i, (g, w) in enumerate(zip(got, want))
        if g.num_channels != w.num_channels
        or g.sample_rate != w.sample_rate
        or not np.array_equal(g.samples, w.samples)
    ]
    if len(got) != len(want) or bad:
        raise AssertionError(f"{name}: {len(bad)} of {len(want)} files differ")
    log(f"  {name}: {len(want)} files sample-identical to the host engine")


# ----------------------------------------------------------------- phase 0


def phase_device(expect_count):
    """Device check and identity lines; returns the device record."""
    import jax

    from qoaudio_tpu import native
    from qoaudio_tpu.utils.device import (
        device_record,
        enable_compile_cache,
        nvidia_smi,
        require_gpu,
    )

    cache = enable_compile_cache()
    devices = require_gpu()
    if len(devices) < expect_count:
        raise SystemExit(f"needs {expect_count} GPUs, JAX found {len(devices)}")
    rec = device_record(devices[:expect_count])
    log(f"device: {rec['kind']} x{rec['count']} (platform {rec['platform']})")
    log(f"nvidia-smi name, power.limit: {nvidia_smi()}")
    log(f"jax {jax.__version__}")
    tier = (
        "AVX-512 fused kernels" if native.has_fused_interleaved() else "portable kernels"
    ) if native.available() else "unavailable"
    log(f"host cpu: {native.cpu_model()} ({os.cpu_count()} cpus); native engine: {tier}")
    log(f"compile cache: {cache}")
    return rec, cache


# ----------------------------------------------------------------- phase 1


def timed(fn, args, runs=5, **static):
    """AOT-compile ``fn`` (a jitted function) for ``args``; returns (output,
    compile seconds, median seconds of ``runs`` after a warm-up, compiled)."""
    import jax

    t0 = time.perf_counter()
    compiled = fn.lower(*args, **static).compile()
    compile_s = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))
    ts = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        ts.append(time.perf_counter() - t0)
    return out, compile_s, statistics.median(ts), compiled


def mismatches(a, b) -> int:
    import jax.numpy as jnp

    return sum(int(jnp.sum(x != y)) for x, y in zip(a, b))


def _memory(compiled) -> str:
    m = compiled.memory_analysis()
    return (
        f"args {m.argument_size_in_bytes/1e6:.1f} MB, out "
        f"{m.output_size_in_bytes/1e6:.1f} MB, temp {m.temp_size_in_bytes/1e6:.1f} MB"
    )


def phase_kernels(encode, pcm, channels, spc, words_be, dstate,
                  n_chains=2048, frames=16, runs=5):
    """The encode kernel against the XLA kernel, and the device decoder
    against the native engine, at real widths.

    Encode: ``frames`` frames of the fixture over ``n_chains`` chains, full
    windows and a masked case (short final slice, zero-length windows).
    Decode: ``words_be``/``dstate`` (the audio bank's staged chains).
    Returns the timings (seconds)."""
    import jax

    from qoaudio_tpu import native
    from qoaudio_tpu.ops.decode import decode_chains, words_u32
    from qoaudio_tpu.ops.encode import encode_frames, initial_encoder_state

    log(f"  exactness: {EXACT}")
    x, lens, F = codec.layout_pcm(pcm, channels, spc)
    F_use = min(frames, F)
    xs = np.repeat(x[:F_use], n_chains // channels, axis=3)
    ls = np.repeat(lens[:F_use, :, None], n_chains, axis=2)
    state = jax.device_put(initial_encoder_state(channels, n_chains))
    res = {}
    # masked: a short final slice, then zero-length windows
    xm, lm = xs.copy(), ls.copy()
    lm[-1, 199], lm[-1, 200:] = 7, 0
    xm[-1, 199, 7:] = 0
    xm[-1, 200:] = 0
    for case, (xx, ll) in (("full", (xs, ls)), ("masked", (xm, lm))):
        args = (state, jax.device_put(xx), jax.device_put(ll))
        want, cx, tx, cmp_x = timed(encode_frames, args, runs)
        got, ck, tk, cmp_k = timed(encode, args, runs)
        bad = mismatches(got, want)
        log(
            f"  encode {case} {F_use} frames x {n_chains} chains: kernel "
            f"{tk*1e3:.3f} ms (compile {ck:.1f} s), xla {tx*1e3:.3f} ms "
            f"(compile {cx:.1f} s), {bad} mismatched elements"
        )
        if bad:
            raise AssertionError(f"encode kernel != xla ({case}): {bad} mismatches")
        if case == "full":
            log(f"    kernel memory: {_memory(cmp_k)}; xla memory: {_memory(cmp_x)}")
            res.update(encode_kernel_s=tk, encode_xla_s=tx)

    args = (jax.device_put(dstate), jax.device_put(words_u32(words_be)))
    got, cx, tx, cmp_x = timed(decode_chains, args, runs)
    t0 = time.perf_counter()
    want = native.decode_chains(words_be, dstate) if native.available() else None
    t_native = time.perf_counter() - t0
    bad = -1 if want is None else int(np.sum(np.asarray(got) != want))
    W, N = words_be.shape
    log(
        f"  decode {W} windows x {N} chains: device (xla) {tx*1e3:.3f} ms "
        f"(compile {cx:.1f} s, {W*20*N/tx/1e9:.1f} Gsamples/s), native engine "
        f"{t_native*1e3:.1f} ms; {bad} mismatched vs native"
    )
    log(f"    device memory: {_memory(cmp_x)}")
    if bad:
        raise AssertionError(f"device decode != native engine: {bad} mismatches")
    res.update(decode_xla_s=tx)
    return res


# ----------------------------------------------------------------- phase 2


@contextlib.contextmanager
def xla_kernels():
    """Run the corpus paths with the XLA encode kernel on the GPU (the
    plain version the GPU kernel is measured against)."""
    import qoaudio_tpu.ops as ops
    from qoaudio_tpu.parallel import corpus

    real = ops.encode_kernel
    ops.encode_kernel = lambda platform: real("cpu")
    corpus._TRANSCODE_FUSED_CACHE.clear()
    try:
        yield
    finally:
        ops.encode_kernel = real
        corpus._TRANSCODE_FUSED_CACHE.clear()


@contextlib.contextmanager
def host_engine():
    """Run the corpus paths as on a CPU backend (``batch_decode`` takes
    the native host engine): the host tier the device path competes with."""
    from qoaudio_tpu.parallel import corpus

    real = corpus._jax_platform
    corpus._jax_platform = lambda: "cpu"
    try:
        yield
    finally:
        corpus._jax_platform = real


def _repeat(fn, warm):
    """(result, first-call seconds, seconds of each of ``warm`` more calls)."""
    t0 = time.perf_counter()
    out = fn()
    first = time.perf_counter() - t0
    ts = []
    for _ in range(warm):
        t0 = time.perf_counter()
        out = fn()
        ts.append(time.perf_counter() - t0)
    return out, first, ts


def phase_transcode(files, streams, steps=("encode", "decode", "transcode"),
                    compare_xla=True, mesh=None, cli_files=4, warm=3):
    """The audio bank through the public entry points, each output
    byte-compared with the host engine (``streams`` are its host-engine
    encodes).  Returns per-step seconds."""
    from qoaudio_tpu.parallel import batch_decode, batch_encode, batch_transcode

    total = sum(d.samples * d.channels for _, d in files)
    t0 = time.perf_counter()
    decoded = host_map(codec.decode_all, streams)
    pair = host_pair(decoded)
    log(
        f"  audio bank: {len(files)} files, {total/1e6:.1f} Msamples "
        f"({2*total/1e9:.2f} GB int16 PCM), {sum(map(len, streams))/1e6:.1f} MB "
        f"QOA; host references {time.perf_counter()-t0:.1f} s"
    )
    runs = {
        "encode": (lambda: batch_encode(files, mesh=mesh), streams, expect_equal),
        "decode": (lambda: batch_decode(streams, mesh=mesh), decoded, expect_same_pcm),
        "transcode": (lambda: batch_transcode(streams, mesh=mesh), pair, expect_equal),
    }
    res = {"total_samples": total}
    for step in steps:
        run, want, check = runs[step]
        name = f"batch_{step}"
        variants = [("device", contextlib.nullcontext)]
        if compare_xla:
            variants.append(("xla", xla_kernels) if step != "decode" else
                            ("host engine", host_engine))
        for label, ctx in variants:
            with ctx():
                out, first, ts = _repeat(run, warm)
            check(f"{name} ({label})", out, want)
            med = statistics.median(ts)
            log(
                f"  {name} ({label}): first call {first:.2f} s (set-up+compile "
                f"{first - med:.2f} s); end to end median {med:.4f} s of {warm} "
                f"[{min(ts):.4f}-{max(ts):.4f}] = {total/med/1e6:.1f} Msamples/s"
            )
            res[f"{name}_{label.split()[0]}_s"] = med
    if cli_files and mesh is None:
        res["cli_s"] = _cli_transcode(streams[:cli_files], pair[:cli_files])
    return res


def _cli_transcode(streams, want):
    from qoaudio_tpu import cli

    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for i, s in enumerate(streams):
            p = os.path.join(tmp, f"in{i}.qoa")
            with open(p, "wb") as f:
                f.write(s)
            paths.append(p)
        out_dir = os.path.join(tmp, "out")
        t0 = time.perf_counter()
        rc = cli.main(["transcode", "--hbm", *paths, "--out-dir", out_dir])
        dt = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"cli transcode --hbm exited {rc}")
        got = []
        for i in range(len(streams)):
            with open(os.path.join(out_dir, f"in{i}.qoa"), "rb") as f:
                got.append(f.read())
    expect_equal("cli transcode --hbm", got, want)
    return dt


def encode_marginal_cost(encode, pcm, channels, spc, widths=(16384, 65536),
                         frames=4, runs=3):
    """Seconds per padded lane-frame that the encode kernel adds where its
    time grows with the chain count: the slope between two widths (what
    the length-bucketing model charges per lane-frame)."""
    import jax

    from qoaudio_tpu.ops.encode import initial_encoder_state

    x, lens, _ = codec.layout_pcm(pcm, channels, spc)
    ts = []
    for n in widths:
        args = (
            jax.device_put(initial_encoder_state(channels, n)),
            jax.device_put(np.repeat(x[:frames], n // channels, axis=3)),
            jax.device_put(np.repeat(lens[:frames, :, None], n, axis=2)),
        )
        ts.append(timed(encode, args, runs)[2])
    return (ts[1] - ts[0]) / (frames * (widths[1] - widths[0]))


def dispatch_cost(runs=20):
    """Seconds of one fused transcode dispatch on a one-clip corpus (the
    fixed cost a length bucket adds)."""
    import jax

    from qoaudio_tpu.parallel import batch_transcode

    pcm = (np.arange(2000) % 200 - 100).astype(np.int16)
    stream = codec.encode_all(pcm, QoaDesc(1, 44100, 2000))
    _, handle = batch_transcode([stream], return_fused_handle=True)
    jax.block_until_ready(handle())
    ts = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(handle())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


# ----------------------------------------------------------------- phase 3


def phase_tests():
    import pytest

    os.environ["QOA_TEST_GPU"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider", os.path.join(ROOT, "tests")])
    if rc != 0:
        raise AssertionError(f"pytest -m gpu exited {int(rc)}")


# -------------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU mesh path and its comparison")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four_cards else 1

    log("phase 0: device")
    rec, cache = phase_device(n_cards)
    import jax

    from qoaudio_tpu.ops import encode_kernel
    from qoaudio_tpu.parallel import corpus
    from qoaudio_tpu.parallel.mesh import make_mesh

    pcm, channels, spc = load_fixture()
    files = build_corpus(pcm, channels, spc, args.seed)
    streams = host_encode(files)

    if args.four_cards:
        log("four cards: batch_decode and batch_transcode on a 4-device mesh")
        phase_transcode(files, streams, steps=("decode", "transcode"),
                        compare_xla=False, mesh=make_mesh(4), cli_files=0)
    else:
        encode, _ = encode_kernel(rec["platform"])
        log("phase 1: kernels at real widths")
        from qoaudio_tpu.bitstream import parse_file_arrays

        parsed = [parse_file_arrays(s) for s in streams]
        offs = np.cumsum([0] + [p.n_frames * p.channels for p in parsed])
        words_be, dstate = corpus._stage_words(
            parsed, offs[:-1], max(p.max_windows for p in parsed), int(offs[-1])
        )
        phase_kernels(encode, pcm, channels, spc, words_be, dstate)
        del words_be, dstate, parsed

        log("phase 2: audio-bank transcode through the public entry points")
        phase_transcode(files, streams)
        per_lane_frame = encode_marginal_cost(encode, pcm, channels, spc)
        fixed = dispatch_cost()
        log(
            f"  bucket cost model: encode {per_lane_frame*1e9:.2f} ns per added "
            f"padded lane-frame (4 frames, 16384 -> 65536 chains), one fused "
            f"dispatch {fixed*1e3:.3f} ms = {fixed/per_lane_frame:.0f} lane-frames"
        )
        stats = jax.devices()[0].memory_stats() or {}
        log(f"  peak_bytes_in_use: {stats.get('peak_bytes_in_use', 'n/a')}")

        log("phase 3: gpu-marked tests")
        phase_tests()

    from qoaudio_tpu.utils.device import cache_stats

    n, size = cache_stats(cache)
    log(f"compile cache {cache}: {n} entries, {size/1e6:.1f} MB")
    print(json.dumps({"ok": True, "device": {
        "platform": rec["platform"], "kind": rec["kind"], "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
