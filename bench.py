#!/usr/bin/env python
"""Headline benchmark: bit-exact QOA transcode throughput.

Primary metric (the JSON line's value): batched encode on one GPU via the
Pallas kernel — real music PCM (the reference fixture) replicated across
the chain axis, device-resident working set, LMS state chained across
repeated kernel launches (BASELINE.json config 5, the deployment shape).
The same JSON object carries the secondary metrics the reference also
benches (see /root/reference/benches/qoa_benchmarks.rs): full-fixture
decode and single-file encode, both END-TO-END on the host path (bytes in,
bytes/PCM out — the native engine), plus the XLA-kernel encode number.

Baselines (BASELINE.md, Apple M-series):
  Rust encode ~41.3 Msamples/s, Rust decode ~191.5 Msamples/s.
North star (BASELINE.json): >= 50x Rust encode ~ 2.07 Gsamples/s/chip.

Device timings chain K launches, sync once on a scalar fetch and fit the
slope over K.  The device sections need an NVIDIA GPU and fail without
one; the JSON line names the device and the card's power limit, and the
process exits non-zero when a device section fails or lands no metric.

Set QOA_BENCH_TRACE=<dir> to wrap the device region in a jax.profiler
trace.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from qoaudio_tpu.utils.device import nvidia_smi  # noqa: E402
from qoaudio_tpu.utils.timing import Stopwatch, profiler_trace  # noqa: E402

FIXTURE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "tests", "fixtures", "julien_baker_sprained_ankle.qoa",
)
RUST_ENCODE_MSPS = 41.3
RUST_DECODE_MSPS = 191.5

N_CHAINS = 2048  # 1024 stereo streams
BENCH_FRAMES = 16  # frames per stream in the device-resident working set

# The 1-core shared VM degrades host timings by 35-50% under load (r03's
# capture measured decode at 180 Msps where the same binary does 287+ idle).
# Floors = 0.8x the best KNOWN-idle measurement of each metric; landing
# below one triggers one spaced retry of the whole host section and the
# per-metric best of the two runs is reported.
HOST_FLOORS = {
    # decode floors raised after the register-resident fused decode kernel
    # (experiments/cpp_decode_fused.py).  NOTE: floors are 0.8x the best
    # known-idle capture IN THE BENCH PROCESS — with jax loaded the
    # same binary runs ~10-15% slower than a bare-python host measurement
    # (decode_all ~435-440 in-bench vs ~495-590 standalone).
    # all four re-raised to 0.8x the 2026-08-17 truly-idle in-bench
    # capture (nothing else on the VM): decode 1518.5,
    # stream 1648.4 (uncapped whole-run slab), mono 1320.0, encode 108.4
    # (mono16/fast16 + straggler-hybrid encoder)
    "decode_e2e_msps": 1210.0,
    "decode_stream_msps": 1310.0,
    "encode_single_file_e2e_msps": 86.0,
    "decode_mono_e2e_msps": 1050.0,
}


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def load_pcm():
    from qoaudio_tpu import codec

    if os.path.exists(FIXTURE):
        with open(FIXTURE, "rb") as f:
            data = f.read()
        out = codec.decode_all(data)
        return data, out.samples, out.num_channels, out.samples_per_channel
    log("fixture missing; synthesizing 54-s stereo signal")
    rng = np.random.default_rng(0)
    n = 2_394_122
    t = np.arange(n) / 44100.0
    sig = (
        np.sin(2 * np.pi * 220 * t) * 9000
        + np.sin(2 * np.pi * 3313 * t) * 3000
        + rng.normal(0, 500, n)
    )
    pcm = np.stack([sig, np.roll(sig, 7)], -1).reshape(-1).astype(np.int16)
    from qoaudio_tpu.types import QoaDesc

    data = codec.encode_all(pcm, QoaDesc(2, 44100, n))
    return data, pcm, 2, n


def bench_host_paths(data, pcm, channels, spc):
    """End-to-end host-path numbers on the native engine."""
    from qoaudio_tpu import codec, native
    from qoaudio_tpu.types import QoaDesc

    out = {}
    if not native.available():
        log("native engine unavailable; skipping host-path metrics")
        return out

    total = len(pcm)
    best = float("inf")
    for _ in range(10):
        with Stopwatch() as sw:
            codec.decode_all(data, backend="native")
        best = min(best, sw.elapsed)
    out["decode_e2e_msps"] = round(total / best / 1e6, 1)
    log(f"host decode end-to-end: {best*1e3:.1f} ms = {out['decode_e2e_msps']} Msps"
        f" (Rust {RUST_DECODE_MSPS})")

    # one-shot attribution of the decode path (VERDICT r03 #8): best-of-3
    # per stage so future host work targets the dominant term
    from qoaudio_tpu import bitstream as qbs

    t_parse = t_kernel = t_inter = t_fused = t_raw = float("inf")
    fused = native.has_fused_interleaved()
    for _ in range(3):
        with Stopwatch() as sw:
            pa = qbs.parse_file_arrays(data)
        t_parse = min(t_parse, sw.elapsed)
        with Stopwatch() as sw:
            dec = native.decode_chains(pa.words_be, pa.state)
        t_kernel = min(t_kernel, sw.elapsed)
        with Stopwatch() as sw:
            native.interleave_trim(
                dec, pa.n_frames, pa.channels, int(pa.samples_per_frame.sum())
            )
        t_inter = min(t_inter, sw.elapsed)
        if fused and pa.channels == 2:
            with Stopwatch() as sw:
                native.decode_interleaved_stereo(pa.words_be, pa.state)
            t_fused = min(t_fused, sw.elapsed)
            geo = qbs.parse_file_geometry(data)
            if geo is not None:
                from qoaudio_tpu import format as qfmt

                with Stopwatch() as sw:
                    native.decode_interleaved_stereo_raw(
                        data, qfmt.QOA_HEADER_SIZE, geo.F_full,
                        geo.frame_bytes, geo.W0,
                    )
                t_raw = min(t_raw, sw.elapsed)
    log(
        f"decode attribution: parse {t_parse*1e3:.1f} ms, kernel "
        f"{t_kernel*1e3:.1f} ms, interleave {t_inter*1e3:.1f} ms"
        + (f", fused kernel+interleave {t_fused*1e3:.1f} ms"
           if t_fused < float("inf") else "")
        + (f", raw-bytes kernel {t_raw*1e3:.1f} ms"
           if t_raw < float("inf") else "")
    )

    # streaming-iterator path (batched readahead + the slab bulk parse;
    # file-like sources additionally pipeline the next batch's read+decode
    # on a prefetch worker)
    from qoaudio_tpu.streaming import QoaDecoder

    best = float("inf")
    for _ in range(6):
        dec = QoaDecoder(data)
        with Stopwatch() as sw:
            n = len(dec.decode_pending())
        assert n == total
        best = min(best, sw.elapsed)
    out["decode_stream_msps"] = round(total / best / 1e6, 1)
    log(
        f"host streaming decode: {best*1e3:.1f} ms = "
        f"{out['decode_stream_msps']} Msps"
    )

    # mono decode e2e (the raw mono kernel path): the fixture's left
    # channel re-encoded mono, decoded one-shot.  No Rust baseline (the
    # reference benchmarks its stereo fixture only) — recorded so driver
    # captures track the C == 1 fast path too.
    if channels == 2 and native.has_fused_interleaved():
        mono_pcm = np.ascontiguousarray(pcm.reshape(-1, 2)[:, 0])
        mono_data = codec.encode_all(
            mono_pcm, QoaDesc(1, 44100, spc), backend="native"
        )
        best = float("inf")
        for _ in range(8):
            with Stopwatch() as sw:
                codec.decode_all(mono_data, backend="native")
            best = min(best, sw.elapsed)
        out["decode_mono_e2e_msps"] = round(spc / best / 1e6, 1)
        log(
            f"host mono decode end-to-end: {best*1e3:.1f} ms = "
            f"{out['decode_mono_e2e_msps']} Msps"
        )

    desc = QoaDesc(channels, 44100, spc)
    best = float("inf")
    for _ in range(12):  # single-core host: min-of-many rides out scheduler noise
        with Stopwatch() as sw:
            codec.encode_all(pcm, desc, backend="native")
        best = min(best, sw.elapsed)
    out["encode_single_file_e2e_msps"] = round(total / best / 1e6, 1)
    log(
        f"host single-file encode end-to-end: {best*1e3:.0f} ms = "
        f"{out['encode_single_file_e2e_msps']} Msps (Rust {RUST_ENCODE_MSPS})"
    )
    return out


def chain_launches(fn, state0, x, lens, reps):
    """Chain reps kernel launches through the carried state; returns after
    one tiny D2H fetch (the only sync that works reliably here)."""
    st = state0
    for _ in range(reps):
        if lens is None:
            st, snaps, hi, lo = fn(st, x)
        else:
            st, snaps, hi, lo = fn(st, x, lens)
    return int(np.asarray(st[0, 0]))


def fit_launch_slope(chain, Ks, min_slope, name, min_r2=0.985, tries=3):
    """Self-validating device timing (the round-4 calibration rule, now a
    gate): time K chained launches for each K, fit time = slope*K + icept,
    and accept the slope ONLY if the fit is linear (R^2 >= min_r2), the
    slope is positive and above the per-kernel plausibility floor, and the
    intercept is non-garbage: a timing loop that returns wildly-off or
    even NEGATIVE slopes is rejected, not reported.

    Returns (per_launch_seconds | None, rtt_inclusive_bound_seconds): the
    bound is the whole-chain average at the largest K, a defensible floor
    (it still contains the dispatch+fetch RTT) for when every rep is
    rejected."""
    ks = np.asarray(Ks, float)
    bound = None
    for rep in range(tries):
        ts = np.array([chain(int(k)) for k in Ks], float)
        bound_rep = ts[-1] / ks[-1]
        bound = min(bound, bound_rep) if bound is not None else bound_rep
        slope, icept = np.polyfit(ks, ts, 1)
        pred = slope * ks + icept
        ss_tot = float(((ts - ts.mean()) ** 2).sum())
        r2 = 1.0 - float(((ts - pred) ** 2).sum()) / ss_tot if ss_tot > 0 else 0.0
        log(
            f"{name} rep{rep}: "
            + " ".join(f"K={int(k)}:{t*1e3:.1f}ms" for k, t in zip(ks, ts))
            + f" -> slope {slope*1e3:.2f} ms, icept {icept*1e3:.1f} ms, "
            f"R^2 {r2:.4f}"
        )
        if slope >= min_slope and r2 >= min_r2 and icept > -abs(slope) * ks[-1]:
            return slope, bound
        log(f"{name} rep{rep}: fit rejected (non-linear/implausible); re-rep")
    log(f"{name}: every rep rejected — only the RTT-inclusive bound is safe")
    return None, bound


def bench_device(fn, name, state0, x, lens, total_samples):
    """Linearity-gated encode-kernel rate.  Returns (msps | None, floor):
    msps from the accepted per-launch slope, floor the RTT-inclusive
    whole-chain bound (always available)."""
    chain_launches(fn, state0, x, lens, 1)  # warm / compile

    def chain(K):
        t0 = time.perf_counter()
        chain_launches(fn, state0, x, lens, K)
        return time.perf_counter() - t0

    per, bound = fit_launch_slope(chain, (2, 6, 12), 2e-3, name)
    floor = total_samples / bound / 1e6
    if per is None:
        log(f"{name}: REJECTED; floor {floor/1e3:.2f} Gsamples/s")
        return None, floor
    msps = total_samples / per / 1e6
    log(f"{name}: {per*1e3:.1f} ms/launch = {msps/1e3:.2f} Gsamples/s")
    return msps, floor


def bench_decode(data):
    """Batched device-resident decode: the fixture's slice words replicated
    across the chain axis, the device decoder, linearity-gated
    chained-launch timing.  Returns (msps | None, whole-chain floor msps)."""
    import jax

    from qoaudio_tpu import bitstream as bs
    from qoaudio_tpu import native
    from qoaudio_tpu.ops.decode import decode_chains as decode, words_u32

    pa = bs.parse_file_arrays(data)
    W0, N0 = pa.words_be.shape
    Wp = min(256, W0)
    N = 32768  # replicate the fixture's chains
    idx = np.arange(N) % N0
    words_be = np.ascontiguousarray(pa.words_be[:Wp][:, idx])
    state = np.ascontiguousarray(pa.state[:, idx])
    words_d = jax.device_put(words_u32(words_be))
    st_d = jax.device_put(state)

    def chain(K):
        """K launches, ONE sync at the end."""
        t0 = time.perf_counter()
        o = None
        for _ in range(K):
            o = decode(st_d, words_d)
        int(np.asarray(o[0, 0, 0]))
        return time.perf_counter() - t0

    # --- parity gate: the decode kernel must match the native host engine
    # on the real device before any timing (the first 256 chains)
    if native.available():
        got = np.asarray(decode(st_d, words_d)[:, :, :256])
        want = native.decode_chains(words_be[:, :256], state[:, :256])
        if not np.array_equal(got, want):
            raise SystemExit("PARITY FAILURE: device decode != native engine on fixture")
        log("parity gate: device decode bit-exact vs native engine")
    total = Wp * 20 * N
    per, bound = fit_launch_slope(chain, (2, 8, 16, 24), 3e-4, "batched decode")
    floor = total / bound / 1e6
    if per is None:
        return None, floor
    msps = total / per / 1e6
    log(f"batched decode: {per*1e3:.2f} ms = {msps/1e3:.2f} Gsamples/s")
    return msps, floor


RUST_TRANSCODE_MSPS = 1.0 / (1.0 / RUST_DECODE_MSPS + 1.0 / RUST_ENCODE_MSPS)


def bench_transcode_hbm(pcm, channels, emit):
    """North-star deployment shape (BASELINE.json config 5): batched
    multi-file transcode with PCM device-resident between the decode and
    encode kernels.  Corpus: 32 files, mixed channels / sample rates /
    lengths, real-music PCM tiled from the fixture.  Parity-gated
    byte-for-byte against the host decode->encode pair before timing;
    the timed number is honest end-to-end (bytes in -> bytes out,
    including host parse and stream assembly).  Each metric flushes
    through ``emit`` the moment it exists, so a later hang cannot
    discard it."""
    from qoaudio_tpu import codec
    from qoaudio_tpu.parallel.corpus import batch_transcode
    from qoaudio_tpu.types import QoaDesc

    stereo = np.asarray(pcm).reshape(-1, channels)
    n_src = stereo.shape[0]
    files = []
    pos = 0
    for i in range(32):
        spc_i = (64, 128, 256)[i % 3] * 5120
        ch = (2, 1, 2, 1)[i % 4]
        rate = (44100, 22050, 48000)[i % 3]
        idx = (pos + np.arange(spc_i)) % n_src
        blk = stereo[idx][:, :ch]  # mono files take the left channel
        files.append(
            (np.ascontiguousarray(blk).reshape(-1), QoaDesc(ch, rate, spc_i))
        )
        pos = (pos + spc_i + 9973) % n_src
    streams = [codec.encode_all(p, d, backend="native") for p, d in files]
    total = sum(d.samples * d.channels for _, d in files)
    log(
        f"transcode corpus: {len(streams)} files, {total/1e6:.1f} Msamples, "
        f"{sum(len(s) for s in streams)/1e6:.1f} MB compressed"
    )

    # warmup (compiles) — this run's output also feeds the gate;
    # the returned handle keeps the staged pipeline device-resident for
    # the chip-rate timing below (explicit API, VERDICT r04 #6)
    got, fused = batch_transcode(streams, return_fused_handle=True)
    for s, g in zip(streams, got):
        out = codec.decode_all(s, backend="native")
        want = codec.encode_all(
            out.samples,
            QoaDesc(out.num_channels, out.sample_rate, out.samples_per_channel),
            backend="native",
        )
        if g != want:
            raise SystemExit(
                "PARITY FAILURE: batch_transcode != host decode->encode pair"
            )
    log("parity gate: batch_transcode byte-identical to host pair (32 files)")

    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        batch_transcode(streams)
        best = min(best, time.perf_counter() - t0)
    msps = total / best / 1e6
    log(
        f"device-resident batch transcode: {best*1e3:.0f} ms = {msps:.1f} Msps "
        f"(Rust decode+encode pair {RUST_TRANSCODE_MSPS:.1f})"
    )
    emit(
        transcode_hbm_msps=round(msps, 1),
        transcode_hbm_vs_baseline=round(msps / RUST_TRANSCODE_MSPS, 2),
    )

    # device-side rate of the same fused pipeline (decode -> relayout ->
    # encode -> packing), chained launches, no host staging or fetch:
    # how much of the e2e number is host work and transfers
    if fused is not None:

        def tchain(K):
            t0 = time.perf_counter()
            o = None
            for _ in range(K):
                o = fused()
            int(np.asarray(o[0][0]))
            return time.perf_counter() - t0

        tchain(1)  # warm the fetch path
        per, bound = fit_launch_slope(
            tchain, (2, 4, 8), 1e-3, "transcode chip pipeline"
        )
        if per is not None:
            device_msps = total / per / 1e6
            log(
                f"  chip-side pipeline rate: {per*1e3:.1f} ms/corpus = "
                f"{device_msps:.0f} Msps (e2e gap = host work and transfers)"
            )
            emit(transcode_chip_msps=round(device_msps, 1))
        else:
            emit(
                transcode_chip_msps_rejected=True,
                transcode_chip_msps_floor=round(total / bound / 1e6, 1),
            )


def bench_transcode_saturated(pcm, channels, emit):
    """Uniform-length transcode: 128 stereo files = 256 encode chains,
    tight F_pad — no padding between files.  Parity is
    spot-checked (4 files vs the host pair; the full 32-file corpus gate
    runs in the transcode section), then the chip rate times the fused
    handle with the linearity gate."""
    from qoaudio_tpu import codec
    from qoaudio_tpu.parallel.corpus import batch_transcode
    from qoaudio_tpu.types import QoaDesc

    stereo = np.asarray(pcm).reshape(-1, channels)
    if channels != 2:
        log("saturated section needs the stereo fixture; skipping")
        return
    n_src = stereo.shape[0]
    files = []
    pos = 0
    for i in range(128):
        spc_i = 64 * 5120
        idx = (pos + np.arange(spc_i)) % n_src
        files.append(
            (
                np.ascontiguousarray(stereo[idx]).reshape(-1),
                QoaDesc(2, (44100, 48000)[i % 2], spc_i),
            )
        )
        pos = (pos + spc_i + 9973) % n_src
    streams = [codec.encode_all(p, d, backend="native") for p, d in files]
    total = sum(d.samples * d.channels for _, d in files)
    log(
        f"saturated corpus: {len(streams)} files, {total/1e6:.1f} Msamples, "
        f"{sum(len(s) for s in streams)/1e6:.1f} MB compressed"
    )

    t0 = time.perf_counter()
    got, fused = batch_transcode(streams, return_fused_handle=True)
    log(f"saturated warmup (compile + staging): {time.perf_counter()-t0:.0f} s")
    for i in (0, 42, 85, 127):
        out = codec.decode_all(streams[i], backend="native")
        want = codec.encode_all(
            out.samples,
            QoaDesc(out.num_channels, out.sample_rate, out.samples_per_channel),
            backend="native",
        )
        if got[i] != want:
            raise SystemExit(
                "PARITY FAILURE: saturated batch_transcode != host pair"
            )
    log("parity gate: saturated transcode spot-check (4 files) bit-exact")

    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        batch_transcode(streams)
        best = min(best, time.perf_counter() - t0)
    msps = total / best / 1e6
    log(f"saturated e2e: {best*1e3:.0f} ms = {msps:.1f} Msps")
    emit(transcode_saturated_msps=round(msps, 1))

    if fused is not None:

        def tchain(K):
            t0 = time.perf_counter()
            o = None
            for _ in range(K):
                o = fused()
            int(np.asarray(o[0][0]))
            return time.perf_counter() - t0

        tchain(1)
        per, bound = fit_launch_slope(
            tchain, (2, 4, 8), 1e-3, "saturated chip pipeline"
        )
        if per is not None:
            device_msps = total / per / 1e6
            log(
                f"  saturated chip rate: {per*1e3:.1f} ms/corpus = "
                f"{device_msps:.0f} Msps (256 uniform chains)"
            )
            emit(transcode_saturated_chip_msps=round(device_msps, 1))
        else:
            emit(
                transcode_saturated_chip_rejected=True,
                transcode_saturated_chip_floor=round(total / bound / 1e6, 1),
            )


def main():
    # NO jax in this process: one process per card, and the device
    # sections' children run one after another (a JAX process reserves
    # most of the card's memory).  All device work happens in the
    # --device-json child.
    data, pcm, channels, spc = load_pcm()
    extra = bench_host_paths(data, pcm, channels, spc)
    low = [k for k, f in HOST_FLOORS.items() if extra.get(k, float("inf")) < f]
    if low:
        log(
            f"host metrics below known-idle floors: {low} — shared-VM load; "
            "retrying the host section once in 45 s"
        )
        time.sleep(45)
        second = bench_host_paths(data, pcm, channels, spc)
        for k, v in second.items():
            extra[k] = max(extra.get(k, 0.0), v)
        log("host section best-of-two: " + ", ".join(
            f"{k}={extra[k]}" for k in sorted(second)
        ))

    # The device sections each run in their OWN subprocess with their own
    # hard timeout.  Children flush each metric as its own JSON line the
    # moment it exists, and the parent salvages flushed fragments even
    # from a child it had to kill.  The parent ALWAYS prints the one JSON
    # line, then exits non-zero if any device section failed or landed
    # no metric.
    _FAILED_SECTIONS.clear()
    headline, dev_extra = _run_device_sections()
    for k, v in dev_extra.items():
        extra[k] = v
    try:
        name, power_limit = nvidia_smi().splitlines()[0].split(", ")
        extra.update(gpu_name=name, gpu_power_limit=power_limit)
    except Exception as e:  # no card: the device sections failed as well
        extra["gpu_name"] = f"unavailable ({type(e).__name__})"

    print(
        json.dumps(
            {
                "metric": "encode_msamples_per_sec_per_chip",
                "value": round(headline, 1),
                "unit": "Msamples/s",
                "vs_baseline": round(headline / RUST_ENCODE_MSPS, 2),
                **extra,
                "decode_vs_baseline": round(
                    extra.get("decode_e2e_msps", 0.0) / RUST_DECODE_MSPS, 2
                ),
            }
        )
    )
    missing = [
        name for name, _, key, _ in DEVICE_SECTIONS
        if (headline if key == "_headline" else extra.get(key, 0.0)) <= 0
    ]
    if _FAILED_SECTIONS or missing:
        log(f"device sections failed: {sorted(set(_FAILED_SECTIONS))}; "
            f"without their metric: {missing}")
        sys.exit(1)


# ---------------------------------------------------------------------------
# Device-section orchestration (parent side)
# ---------------------------------------------------------------------------
# Each section is one child process (`bench.py --device-json <name>`) with
# its own timeout, ordered cheapest-compile-first.  `key` is the metric
# that decides whether a section's attempt looked healthy; below
# `retry_below`, the parent queues ONE spaced retry of just that section.

DEVICE_SECTIONS = (
    # (name, timeout_s, key, retry_below)
    ("decode", 420, "decode_batched_msps", 20000.0),
    ("transcode", 540, "transcode_hbm_msps", RUST_TRANSCODE_MSPS),
    ("encode", 700, "_headline", 1000.0),
    ("saturated", 420, "transcode_saturated_chip_msps", 1500.0),
)


def _parse_fragments(stdout_bytes):
    """Every stdout line that parses as a JSON object is a metric fragment."""
    frags = []
    for line in (stdout_bytes or b"").decode(errors="replace").splitlines():
        line = line.strip()
        if line.startswith("{"):
            try:
                frags.append(json.loads(line))
            except Exception:
                pass
    return frags


_FAILED_SECTIONS: list = []


def _device_subprocess(section, timeout):
    """Run ONE device section in a child with a hard wall-clock cap.
    Returns the list of flushed metric fragments — INCLUDING those a
    timed-out child managed to flush before it was killed.  A timed-out
    or failed child is recorded in ``_FAILED_SECTIONS``."""
    import subprocess

    log(f"--- device section '{section}' (timeout {timeout:.0f}s) ---")
    try:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--device-json",
             section],
            stdout=subprocess.PIPE,
            timeout=timeout,
        )
    except subprocess.TimeoutExpired as e:
        log(f"device section '{section}' timed out; "
            "salvaging any flushed fragments")
        _FAILED_SECTIONS.append(section)
        return _parse_fragments(e.stdout)
    if proc.returncode != 0:
        log(f"device section '{section}' exited rc={proc.returncode}")
        _FAILED_SECTIONS.append(section)
    return _parse_fragments(proc.stdout)


def _run_device_sections():
    """Run every device section, merging fragments per-metric (numbers keep
    the best across attempts — a transient dip can hit one attempt only);
    retry unhealthy sections once each, spaced, within the overall device
    budget.  Returns (headline, extra)."""
    budget = float(os.environ.get("QOA_BENCH_DEVICE_BUDGET", "2600"))
    t0 = time.monotonic()
    headline = 0.0
    extra = {}
    attempts = {name: 0 for name, *_ in DEVICE_SECTIONS}
    queue = [(name, t, key, low) for name, t, key, low in DEVICE_SECTIONS]
    while queue:
        name, timeout, key, low = queue.pop(0)
        remaining = budget - (time.monotonic() - t0)
        if remaining < 90:
            log(f"device budget exhausted; skipping section '{name}'")
            continue
        if attempts[name] > 0:
            pause = min(60.0, max(0.0, remaining - timeout))
            log(f"spacing {pause:.0f}s before retrying '{name}'")
            time.sleep(pause)
            remaining = budget - (time.monotonic() - t0)
        cap = float(os.environ.get("QOA_BENCH_DEVICE_TIMEOUT", timeout))
        frags = _device_subprocess(name, min(cap, remaining))
        attempts[name] += 1
        for d in frags:
            for k, v in d.items():
                if k == "_headline":
                    headline = max(headline, float(v))
                elif isinstance(v, bool):
                    extra[k] = extra.get(k, False) or v
                elif isinstance(v, (int, float)):
                    extra[k] = max(extra.get(k, 0.0), v)
                else:
                    extra.setdefault(k, v)
        val = headline if key == "_headline" else extra.get(key, 0.0)
        if val < low and attempts[name] < 2:
            log(f"section '{name}': {key}={val:.1f} below par ({low:.1f}); "
                "queueing one retry")
            queue.append((name, timeout, key, low))
    return headline, extra


# ---------------------------------------------------------------------------
# Device-section bodies (child side): each metric prints as its own JSON
# line on stdout the moment it exists (stderr carries the logs), so the
# parent can salvage completed measurements from a child that later hangs.
# ---------------------------------------------------------------------------


def _emit(**metrics):
    print(json.dumps(metrics), flush=True)


def _section_decode(data, pcm, channels, spc):
    msps, floor = bench_decode(data)
    if msps is not None:
        _emit(decode_batched_msps=round(msps, 1))
    else:
        _emit(
            decode_batched_msps_rejected=True,
            decode_batched_msps_floor=round(floor, 1),
        )


def _section_transcode(data, pcm, channels, spc):
    bench_transcode_hbm(pcm, channels, _emit)


def _section_saturated(data, pcm, channels, spc):
    bench_transcode_saturated(pcm, channels, _emit)


def _section_encode(data, pcm, channels, spc):
    import jax
    import jax.numpy as jnp

    from qoaudio_tpu import codec
    from qoaudio_tpu.ops import encode_kernel
    from qoaudio_tpu.ops.encode import encode_frames, initial_encoder_state

    encode, _ = encode_kernel(jax.devices()[0].platform)
    x, lens, F = codec.layout_pcm(pcm, channels, spc)
    F_use = min(BENCH_FRAMES, F)
    reps = N_CHAINS // channels
    xp = jax.device_put(np.repeat(x[:F_use], reps, axis=3))
    lp = jax.device_put(
        np.repeat(lens[:F_use, :, None].astype(np.int32), N_CHAINS, axis=2)
    )
    state0 = jax.device_put(initial_encoder_state(channels, N_CHAINS))
    total = F_use * 5120 * N_CHAINS

    # --- parity gate: the encode kernel must match the XLA kernel
    # word-for-word on the real working set BEFORE any timing (same
    # shapes as the timed runs; the comparison reduces on device)
    ex = encode_frames(state0, xp, lp)
    bad = sum(
        int(np.asarray(jnp.sum((a != b).astype(jnp.int32))))
        for a, b in zip(ex, encode(state0, xp, lp))
    )
    if bad:
        raise SystemExit(
            f"PARITY FAILURE: encode kernel != xla kernel ({bad} mismatched elements)"
        )
    log("parity gate: encode kernel bit-exact vs xla kernel")

    msps, floor = bench_device(encode, "encode kernel", state0, xp, lp, total)
    if msps is not None:
        _emit(_headline=round(msps, 1))
    else:
        _emit(headline_rejected=True, headline_floor_msps=round(floor, 1))
    msps, _ = bench_device(encode_frames, "xla encode", state0, xp, lp, total)
    if msps is not None:
        _emit(encode_xla_msps=round(msps, 1))


def _device_main(section):
    """Child entry: run ONE device section, flushing each metric as its
    own JSON line (see the section bodies above).  Fails without a GPU."""
    from qoaudio_tpu.utils.device import (
        device_record,
        enable_compile_cache,
        require_gpu,
    )

    enable_compile_cache()
    rec = device_record(require_gpu())
    log(f"devices: {rec}")
    _emit(platform=rec["platform"], device_kind=rec["kind"],
          device_count=rec["count"])
    data, pcm, channels, spc = load_pcm()
    body = {
        "decode": _section_decode,
        "transcode": _section_transcode,
        "encode": _section_encode,
        "saturated": _section_saturated,
    }[section]
    with profiler_trace(os.environ.get("QOA_BENCH_TRACE")):
        body(data, pcm, channels, spc)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--device-json":
        _device_main(sys.argv[2] if len(sys.argv) > 2 else "encode")
    else:
        main()
