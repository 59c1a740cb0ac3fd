"""High-level one-shot codec API: ``decode_all`` / ``encode_all`` /
``decode_range``.

Mirrors the reference convenience layer (/root/reference/src/lib.rs:706-763)
with the framework's two-tier execution model (``backend="auto"``):

* **native** (default when the C++ engine builds): the host/IO tier —
  single-file transcode is latency-bound, so it runs on the chain-vector
  SIMD kernels in ``native/`` with zero staging copies.
* **jax**: the batched device tier — every frame carries its own LMS seed,
  so ``decode_all`` is ONE kernel launch over frames x channels
  (SURVEY.md §3.2), and ``encode_all`` streams frame chunks through
  ``ops.encode.encode_frames`` with device-resident carried state; all 16
  scalefactor candidates evaluate as vector lanes.  (The Pallas variants
  serve the multi-file corpus paths in ``parallel/``.)
* **numpy**: the pure-host oracle-backed fallback.
"""

from __future__ import annotations

import numpy as np

from . import bitstream as bs
from . import format as fmt
from .errors import (
    InvalidChannels,
    InvalidSampleRate,
    InvalidSamples,
    NoSamples,
)
from .types import DecodedQoa, QoaDesc

# Canonical kernel shapes: every encode call pads its inputs to one of a
# tiny fixed ladder of shapes so the whole process (and test suite) shares
# a handful of XLA compilations instead of one per input size.  The chain
# axis is always padded to QOA_MAX_CHANNELS (8): padded lanes carry
# ``lens == 0`` which passes LMS state through unchanged and their output
# words are sliced away on device.
_CANON_CHAINS = 8
_CHUNK_LADDER = (1, 8, 64)


def _canon_chunk(n_frames: int) -> int:
    for c in _CHUNK_LADDER:
        if n_frames <= c:
            return c
    return _CHUNK_LADDER[-1]


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def initial_encoder_state(channels: int, n_chains: int | None = None) -> np.ndarray:
    """Fresh per-channel LMS state: history 0, weights (0,0,-2^13,2^14).

    Reference: QoaEncoder::new, /root/reference/src/lib.rs:346-352.
    Lives here (pure numpy) so the native host path never imports jax.
    """
    n = n_chains if n_chains is not None else channels
    state = np.zeros((8, n), dtype=np.int32)
    for i, wv in enumerate(fmt.QOA_INITIAL_WEIGHTS):
        state[4 + i, :] = wv
    return state


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def decode_all(data: bytes, backend: str = "auto") -> DecodedQoa:
    """Decode a complete QOA stream.

    ``backend="auto"`` uses the native host engine when available (the
    host/IO path — one shot, latency-bound), falling back to the batched
    JAX device kernel.  Raises IncompatibleFrame if channels/sample-rate
    change mid-stream (reference: src/lib.rs:735-739), NoSamples on an
    empty stream.
    """
    if backend not in ("auto", "native", "numpy", "jax"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend in ("auto", "native"):
        from . import native

        if native.available():
            return _decode_all_native(data)
        if backend == "native":
            raise RuntimeError("native engine unavailable")
        backend = "jax"

    parsed = bs.parse_file(data)
    if not parsed.frames:
        raise NoSamples()
    batch = bs.stack_frames(parsed.frames)

    if backend == "numpy":
        from .reference import decode_batch_np

        pcm = decode_batch_np(batch)
    elif backend == "jax":
        from .ops.decode import decode_batch

        pcm = decode_batch(
            batch,
            pad_chains_to=max(8, _next_pow2(batch.n_frames * batch.channels)),
            pad_windows_to=_next_pow2(batch.max_windows),
        )

    # trim each frame to its true sample count and concatenate
    spf = batch.samples_per_frame
    if np.all(spf[:-1] == batch.max_windows * fmt.QOA_SLICE_LEN):
        # fast path: only the final frame is short
        flat = pcm.reshape(-1, batch.channels)
        full = (batch.n_frames - 1) * batch.max_windows * fmt.QOA_SLICE_LEN
        samples = np.concatenate(
            [flat[:full], pcm[-1, : spf[-1]]]
        ).reshape(-1)
    else:
        samples = np.concatenate(
            [pcm[i, : spf[i]] for i in range(batch.n_frames)]
        ).reshape(-1)

    return DecodedQoa(
        num_channels=batch.channels,
        sample_rate=batch.sample_rate,
        samples=samples.astype(np.int16, copy=False),
    )


def _decode_tail_fused(t, C: int) -> np.ndarray:
    """Decode a short tail FrameRecord through the array kernel.

    Returns the untrimmed (n_windows*20, C) int16 frame; callers slice
    to ``t.samples_per_channel`` rows.
    """
    from . import native

    tstate = np.empty((8, C), dtype=np.int32)
    tstate[0:4] = t.lms_history.T
    tstate[4:8] = t.lms_weights.T
    twords = np.ascontiguousarray(t.slice_words.astype(">u8").view(np.uint64))
    return native.decode_interleaved(twords, tstate, C)


def _decode_all_native(data: bytes) -> DecodedQoa:
    """One-shot decode on the native chain-vector engine.

    Uses the O(1)-per-frame arithmetic parse when the stream is uniform,
    the general frame walk otherwise (streaming mode, non-uniform frames).
    """
    from . import native

    geo = bs.parse_file_geometry(data)
    if (
        geo is not None
        and geo.channels in (1, 2)
        and geo.spc0 == geo.W0 * fmt.QOA_SLICE_LEN
        and native.has_fused_interleaved()
    ):
        # raw-bytes fused path: the kernel reads slice words + LMS straight
        # from the file buffer (no chain-array gather, no staging — deletes
        # ~25% of e2e, experiments/cpp_decode_raw.py) and stores interleaved
        # PCM at final positions.  Window-aligned full frames make the
        # untrimmed rows contiguous-exact; only the short tail (if any)
        # decodes through the array kernel.
        C = geo.channels
        rows_full = geo.F_full * geo.spc0
        tail_rows = geo.tail.samples_per_channel if geo.tail is not None else 0
        out = np.empty((rows_full + tail_rows, C), dtype=np.int16)
        native.decode_interleaved_raw(
            data, fmt.QOA_HEADER_SIZE, geo.F_full, geo.frame_bytes, geo.W0,
            C, out=out[:rows_full],
        )
        if geo.tail is not None:
            out[rows_full:] = _decode_tail_fused(geo.tail, C)[:tail_rows]
        return DecodedQoa(
            num_channels=C,
            sample_rate=geo.sample_rate,
            samples=out.reshape(-1),
        )

    pa = bs.parse_file_arrays(data)
    if pa is None:
        # general walk (still native kernels, frames stacked the slow way)
        parsed = bs.parse_file(data)
        if not parsed.frames:
            raise NoSamples()
        batch = bs.stack_frames(parsed.frames)
        F, C = batch.n_frames, batch.channels
        words_be, state = bs.batch_chain_arrays(batch)
        spf = batch.samples_per_frame
        rate = batch.sample_rate
    else:
        F = pa.n_frames
        C = pa.channels
        words_be, state = pa.words_be, pa.state
        spf = pa.samples_per_frame
        rate = pa.sample_rate

    W20 = words_be.shape[0] * fmt.QOA_SLICE_LEN
    aligned = bool(np.all(spf[:-1] == W20))
    if C in (1, 2) and native.has_fused_interleaved():
        # fused decode->interleaved: no (W, 20, N) intermediate round trip
        full = native.decode_interleaved(words_be, state, C)
        if aligned:
            samples = full[: int(spf.sum())].reshape(-1)
        else:
            pcm = full.reshape(F, W20, C)
            samples = np.concatenate(
                [pcm[i, : spf[i]] for i in range(F)]
            ).reshape(-1)
    elif aligned:
        # uniform-except-last: transpose + trim fused in native code
        dec = native.decode_chains(words_be, state)
        total = int(spf.sum())
        samples = native.interleave_trim(dec, F, C, total).reshape(-1)
    else:
        dec = native.decode_chains(words_be, state)
        pcm = native.interleave_trim(dec, F, C, F * W20).reshape(F, W20, C)
        samples = np.concatenate(
            [pcm[i, : spf[i]] for i in range(F)]
        ).reshape(-1)
    return DecodedQoa(
        num_channels=C,
        sample_rate=rate,
        samples=samples,
    )


def open_and_decode_all(path, backend: str = "auto") -> DecodedQoa:
    """Open a file and decode it (reference: src/lib.rs:750-754)."""
    with open(path, "rb") as f:
        return decode_all(f.read(), backend=backend)


def decode_range(
    data: bytes, start: int, end: int, backend: str = "auto"
) -> DecodedQoa:
    """Random-access decode of samples [start, end) per channel.

    QOA frames are self-contained (every header carries the full LMS
    state, reference src/lib.rs:271-281), so a range decode touches ONLY
    the frames covering it — O(range), not O(file).  The reference has no
    such API; it falls out of the same property the batched kernels
    exploit.  Falls back to a full decode for non-uniform streams.
    """
    if start < 0 or end < start:
        raise ValueError("need 0 <= start <= end")

    if backend in ("auto", "native"):
        from . import native

        geo = bs.parse_file_geometry(data)
        if (
            geo is not None
            and geo.channels in (1, 2)
            and geo.spc0 == geo.W0 * fmt.QOA_SLICE_LEN
            and native.available()
            and native.has_fused_interleaved()
        ):
            # O(range) for real: the geometry probe is O(F) header words
            # (no gather), and the raw kernel decodes ONLY the covered
            # frames straight from the file bytes at their byte offset.
            C = geo.channels
            spc0 = geo.spc0
            tail_spc = (
                geo.tail.samples_per_channel if geo.tail is not None else 0
            )
            total = geo.F_full * spc0 + tail_spc
            start = min(start, total)
            end = min(end, total)
            if end <= start:
                return DecodedQoa(
                    num_channels=C,
                    sample_rate=geo.sample_rate,
                    samples=np.empty(0, np.int16),
                )
            F = geo.F_full + (1 if geo.tail is not None else 0)
            f0 = start // spc0
            f1 = min(max(f0 + 1, -(-end // spc0)), F)
            nfull = max(0, min(f1, geo.F_full) - f0)
            rows_full = nfull * spc0
            tail_in = f1 > geo.F_full
            pcm = np.empty(
                (rows_full + (tail_spc if tail_in else 0), C), np.int16
            )
            if nfull:
                native.decode_interleaved_raw(
                    data,
                    fmt.QOA_HEADER_SIZE + f0 * geo.frame_bytes,
                    nfull,
                    geo.frame_bytes,
                    geo.W0,
                    C,
                    out=pcm[:rows_full],
                )
            if tail_in:
                pcm[rows_full:] = _decode_tail_fused(geo.tail, C)[:tail_spc]
            lo = start - f0 * spc0
            hi = lo + (end - start)
            return DecodedQoa(
                num_channels=C,
                sample_rate=geo.sample_rate,
                samples=np.ascontiguousarray(pcm[lo:hi]).reshape(-1),
            )

    pa = bs.parse_file_arrays(data)
    if pa is None or backend not in ("auto", "native"):
        out = decode_all(data, backend=backend)
        lo = min(start, out.samples_per_channel)
        hi = min(end, out.samples_per_channel)
        return DecodedQoa(
            num_channels=out.num_channels,
            sample_rate=out.sample_rate,
            samples=out.samples.reshape(-1, out.num_channels)[lo:hi].reshape(-1),
        )

    from . import native

    if not native.available():
        if backend == "native":
            raise RuntimeError("native engine unavailable")
        return decode_range(data, start, end, backend="jax")

    C = pa.channels
    total = int(pa.samples_per_frame.sum())
    start = min(start, total)
    end = min(end, total)
    if end <= start:
        return DecodedQoa(
            num_channels=C,
            sample_rate=pa.sample_rate,
            samples=np.empty(0, np.int16),
        )
    # frame stride comes from the PARSED uniform frame size, not the 5120
    # maximum — the format allows any uniform samples-per-channel and
    # parse_file_arrays accepts it (reference reads spc from each header,
    # src/lib.rs:217-225)
    spc0 = int(pa.samples_per_frame[0])
    f0 = start // spc0
    f1 = min(max(f0 + 1, -(-end // spc0)), pa.n_frames)

    words = np.ascontiguousarray(pa.words_be[:, f0 * C : f1 * C])
    st = np.ascontiguousarray(pa.state[:, f0 * C : f1 * C])
    W20 = pa.max_windows * fmt.QOA_SLICE_LEN
    nf = f1 - f0
    if C in (1, 2) and native.has_fused_interleaved():
        full = native.decode_interleaved(words, st, C)
    else:
        dec = native.decode_chains(words, st)
        full = native.interleave_trim(dec, nf, C, nf * W20)
    if spc0 == W20 or nf == 1:
        # frames are window-aligned (or there is only one): the untrimmed
        # layout is contiguous-exact; slice off the short-tail pad rows
        pcm = full[: int(pa.samples_per_frame[f0:f1].sum())]
    else:
        # short final window inside non-final frames (spc0 % 20 != 0):
        # drop each frame's pad rows from the padded layout
        full = full.reshape(nf, W20, C)
        pcm = np.concatenate(
            [full[i, : int(pa.samples_per_frame[f0 + i])] for i in range(nf)]
        )
    lo = start - f0 * spc0
    hi = lo + (end - start)
    return DecodedQoa(
        num_channels=C,
        sample_rate=pa.sample_rate,
        samples=np.ascontiguousarray(pcm[lo:hi]).reshape(-1),
    )


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

def _encode_all_native(sample_data, desc: QoaDesc) -> bytes:
    """One-shot encode on the native 16-scalefactor-lane engine.

    Zero staging copies (the kernel reads the interleaved PCM in place —
    (W*20, C) row-major IS the interleaved layout; short final windows are
    bounded by ``lens``, reference src/lib.rs:470,484-487), one native call
    for all frames, and fully vectorized frame-byte assembly.
    """
    from . import native

    C = desc.channels
    T = desc.samples
    R = desc.sample_rate
    pcm = np.ascontiguousarray(
        np.asarray(sample_data, dtype=np.int16).reshape(T, C)
    )
    F = -(-T // fmt.QOA_FRAME_LEN)
    WPF = fmt.QOA_SLICES_PER_FRAME
    Wtot = F * WPF
    n_windows_total = -(-T // fmt.QOA_SLICE_LEN)

    lens = np.zeros(Wtot, np.int32)
    lens[:n_windows_total] = fmt.QOA_SLICE_LEN
    lens[n_windows_total - 1] = (
        T - (n_windows_total - 1) * fmt.QOA_SLICE_LEN
    )

    state = np.ascontiguousarray(initial_encoder_state(C))
    words, snaps = native.encode_file(pcm, lens, Wtot, WPF, state)
    # vectorized whole-stream assembly (headers + LMS + slice words as one
    # big-endian blob dump — see bitstream.assemble_stream_bytes)
    return bs.assemble_stream_bytes(C, R, T, snaps, words.reshape(F, WPF, C))

def _validate_desc(desc: QoaDesc) -> None:
    """Mirror QoaEncoder::new's validation (src/lib.rs:336-344).  The
    reference's u8/u32 field types make negative or >u32 values
    unrepresentable, so those reject with the same typed errors here
    (otherwise the backends diverge: raw OverflowError vs corrupt
    streams)."""
    if not 1 <= desc.channels <= fmt.QOA_MAX_CHANNELS:
        raise InvalidChannels()
    if not 1 <= desc.sample_rate <= 0xFFFFFFFF:
        raise InvalidSampleRate()
    if not 1 <= desc.samples <= 0xFFFFFFFF:
        raise InvalidSamples()


def layout_pcm(
    sample_data: np.ndarray, channels: int, samples: int
):
    """Interleaved PCM -> kernel layout.

    Returns (samples (F, 256, 20, C) int16, lens (F, 256) int32, F).
    """
    T = samples
    C = channels
    F = -(-T // fmt.QOA_FRAME_LEN)
    pcm = np.asarray(sample_data).astype(np.int16).reshape(T, C)
    padded = np.zeros((F * fmt.QOA_FRAME_LEN, C), dtype=np.int16)
    padded[:T] = pcm
    x = padded.reshape(F, fmt.QOA_SLICES_PER_FRAME, fmt.QOA_SLICE_LEN, C)

    lens = np.full((F, fmt.QOA_SLICES_PER_FRAME), fmt.QOA_SLICE_LEN, np.int32)
    flat = lens.reshape(-1)
    n_windows_total = -(-T // fmt.QOA_SLICE_LEN)
    tail = T - (n_windows_total - 1) * fmt.QOA_SLICE_LEN
    flat[n_windows_total - 1] = tail
    flat[n_windows_total:] = 0
    return x, lens, F


def encode_all(sample_data, desc: QoaDesc, backend: str = "auto") -> bytes:
    """One-shot encode of interleaved 16-bit PCM to QOA bytes.

    Bit-exact with the reference encoder (same search, same tie-breaks).
    ``backend="auto"``: native host engine when available (the sequential
    LMS chain of a single file is latency-bound — a host-path workload),
    else the batched JAX device kernel.
    """
    _validate_desc(desc)
    sample_data = np.asarray(sample_data)
    if sample_data.size != desc.samples * desc.channels:
        raise InvalidSamples()

    if backend in ("auto", "native"):
        from . import native

        if native.available():
            return _encode_all_native(sample_data, desc)
        if backend == "native":
            raise RuntimeError("native engine unavailable")
        backend = "jax"

    if backend == "numpy":
        from .reference import encode_all_py

        return encode_all_py(
            sample_data, desc.channels, desc.sample_rate, desc.samples
        )
    if backend != "jax":
        raise ValueError(f"unknown backend {backend!r}")

    from .ops.encode import encode_frames

    C = desc.channels
    T = desc.samples
    x, lens, F = layout_pcm(sample_data, C, T)

    chunk = _canon_chunk(F)
    Np = _CANON_CHAINS
    state = initial_encoder_state(C, Np)

    # Phase 1 — dispatch every chunk to the device.  The carried LMS state
    # never leaves the device between chunks, and jax dispatch is async, so
    # chunk k+1 computes while chunk k's outputs transfer (the host-IO /
    # device-compute pipeline axis from SURVEY.md §2.2).
    staged = []  # (f0, fc, snaps_dev, hi_dev, lo_dev)
    for f0 in range(0, F, chunk):
        fc = min(chunk, F - f0)
        cx = np.zeros(
            (chunk, fmt.QOA_SLICES_PER_FRAME, fmt.QOA_SLICE_LEN, Np), np.int16
        )
        cl = np.zeros((chunk, fmt.QOA_SLICES_PER_FRAME, Np), np.int32)
        cx[:fc, :, :, :C] = x[f0 : f0 + fc]
        cl[:fc, :, :C] = lens[f0 : f0 + fc, :, None]
        state, snaps, hi, lo = encode_frames(state, cx, cl)
        # slice device-side to the real channels before any transfer
        staged.append((f0, fc, snaps[:, :, :C], hi[:, :, :C], lo[:, :, :C]))

    # Phase 2 — fetch results and assemble the stream in one vectorized
    # blob dump (the former per-frame build_frame_bytes loop dominated
    # multi-frame epilogues; byte-identity with the native path is pinned
    # by the cross-backend equality tests).
    snaps_all = np.concatenate([np.asarray(s)[:fc] for _, fc, s, _, _ in staged])
    words_all = np.concatenate(
        [
            (np.asarray(h)[:fc].astype(np.uint64) << np.uint64(32))
            | np.asarray(l)[:fc].astype(np.uint64)
            for _, fc, _, h, l in staged
        ]
    )  # (F, 256, C) logical slice words
    return bs.assemble_stream_bytes(C, desc.sample_rate, T, snaps_all, words_all)


# ---------------------------------------------------------------------------
# Host-tier batch encode (mono pairing)
# ---------------------------------------------------------------------------

# Pairwise fallback events per paired window above which pairing two mono
# files stops paying against two straggler-free mono16 passes.  Measured
# breakeven ~1.5 (experiments/cpp_encode_dual_mono.py: fixture music 0.40
# -> 1.37x win, synthetic music 1.24 -> 1.24x win, noisy 1.77 / random
# 1.99 -> 0.76-0.79x loss).
_DUAL_MONO_BAIL = 1.5
# The pairing decision is made ONCE, from a 16-frame paired probe, then
# the rest of the pair runs unmonitored in one native call per mode.
# Finer-grained adaptive controllers were built and measured first
# (per-frame gate, 8-frame blocks with retry, EWMA + exponential-backoff
# probing): every one lost 7-10% on BOTH sides — monitoring block loops
# tax the kernel ~3-18% in per-call overhead, single-block rate spikes
# bail on music whose mean is far below breakeven (10.5% of fixture
# frames exceed 1.5 around a 0.403 mean), and probe/recovery lag bleeds
# on noise.  The one-shot probe keeps real music at the full paired rate
# and caps the adversarial downside at the probe's ~2 blocks
# (experiments/cpp_encode_dual_mono.py).
_DUAL_MONO_PROBE_FRAMES = 16


def _encode_two_mono_native(a, da: QoaDesc, b, db: QoaDesc) -> tuple[bytes, bytes]:
    """Encode two mono files as one pairwise C==2 chain, adaptively.

    Mono encode is structurally ~half the stereo rate: one file has no
    second independent work stream to fill the 512-bit chain's other
    half (the reference encodes channels of ONE stream together,
    src/lib.rs:470-607 — it has no cross-file axis at all).  Two mono
    files do: the pairwise kernel's channels make fully independent
    decisions, so interleaving the files' common full-window prefix as a
    fake stereo signal and splitting the per-channel words/LMS snaps is
    byte-identical to encoding each alone at up to 2x the aggregate rate.

    Adaptivity: the pairwise path re-admits the scalar straggler work
    that mono16 structurally lacks, which on noise-like content outweighs
    the shared chain (0.76-0.79x measured).  The first
    ``_DUAL_MONO_PROBE_FRAMES`` frames therefore run paired while
    watching the native engine's exact fallback counter: a probe rate
    above ``_DUAL_MONO_BAIL`` per window sends the rest of both files
    down the per-file mono16 path.  Byte-identity holds on either path,
    so the switch is purely a throughput policy — and it is
    deterministic: the counter depends only on the input bytes.
    """
    from . import native

    SL = fmt.QOA_SLICE_LEN
    WPF = fmt.QOA_SLICES_PER_FRAME

    flat_a = np.ascontiguousarray(np.asarray(a, dtype=np.int16).reshape(-1))
    flat_b = np.ascontiguousarray(np.asarray(b, dtype=np.int16).reshape(-1))

    def grid(T):
        F = -(-T // fmt.QOA_FRAME_LEN)
        W = F * WPF
        nw = -(-T // SL)
        lens = np.zeros(W, np.int32)
        lens[:nw] = SL
        lens[nw - 1] = T - (nw - 1) * SL
        return lens, W, F

    lens_a, Wa, Fa = grid(da.samples)
    lens_b, Wb, Fb = grid(db.samples)
    words_a = np.zeros(Wa, np.uint64)
    words_b = np.zeros(Wb, np.uint64)
    snaps_a = np.zeros((Fa, 8), np.int32)
    snaps_b = np.zeros((Fb, 8), np.int32)
    state2 = np.ascontiguousarray(initial_encoder_state(2))

    # paired prefix: only full-20 windows can share the kernel's per-window
    # lens, and a partial window only ever ends a file
    wp = min(da.samples // SL, db.samples // SL)
    inter = np.empty((wp * SL, 2), np.int16)
    inter[:, 0] = flat_a[: wp * SL]
    inter[:, 1] = flat_b[: wp * SL]
    lens_full = np.full(wp, SL, np.int32)

    # 16-frame paired probe (the whole prefix if shorter), then ONE
    # unmonitored native call for the rest in the chosen mode.  Probe and
    # rest both start frame-aligned, so encode_file's interval-relative
    # snaps land exactly on frame indices.
    w = min(wp, _DUAL_MONO_PROBE_FRAMES * WPF)
    f0 = native.encode_fallbacks()
    if w:
        w2, s2 = native.encode_file(
            inter[: w * SL], lens_full[:w], w, WPF, state2
        )
        words_a[:w] = w2[:, 0]
        words_b[:w] = w2[:, 1]
        snaps_a[: s2.shape[0]] = s2[:, :, 0]
        snaps_b[: s2.shape[0]] = s2[:, :, 1]
    paired = native.encode_fallbacks() - f0 <= _DUAL_MONO_BAIL * max(w, 1)

    if paired and w < wp:
        w2, s2 = native.encode_file(
            inter[w * SL :], lens_full[w:], wp - w, WPF, state2
        )
        words_a[w:wp] = w2[:, 0]
        words_b[w:wp] = w2[:, 1]
        fr = w // WPF
        snaps_a[fr : fr + s2.shape[0]] = s2[:, :, 0]
        snaps_b[fr : fr + s2.shape[0]] = s2[:, :, 1]
        w = wp

    st_a = np.ascontiguousarray(state2[:, 0:1])
    st_b = np.ascontiguousarray(state2[:, 1:2])
    if not paired and w < wp:
        # straggler-heavy content: each file's remaining full windows run
        # mono16 in one call per file
        fr = w // WPF
        for flat, words, snaps, st in (
            (flat_a, words_a, snaps_a, st_a),
            (flat_b, words_b, snaps_b, st_b),
        ):
            w2, s2 = native.encode_file(
                flat[w * SL : wp * SL].reshape(-1, 1),
                lens_full[w:], wp - w, WPF, st,
            )
            words[w:wp] = w2[:, 0]
            snaps[fr : fr + s2.shape[0]] = s2[:, :, 0]
        w = wp

    # per-file mono16 finish: the longer file's surplus full windows, any
    # partial final window, and the zero-length padding windows of the
    # final frame (state passes through those).  Two native calls per
    # file: the head finishes the frame wp sits in (whose snap is already
    # recorded above), then one whole-tail encode_file.
    for flat, T, W, lens, words, snaps, st in (
        (flat_a, da.samples, Wa, lens_a, words_a, snaps_a, st_a),
        (flat_b, db.samples, Wb, lens_b, words_b, snaps_b, st_b),
    ):
        if wp >= W:
            continue
        tail = np.zeros((W - wp) * SL, np.int16)
        n_valid = max(0, T - wp * SL)
        tail[:n_valid] = flat[wp * SL : wp * SL + n_valid]
        ww = wp
        head = min(W, -(-ww // WPF) * WPF) - ww
        if head:
            words[ww : ww + head] = native.encode_windows(
                tail[: head * SL].reshape(-1, 1), lens[ww : ww + head],
                head, st,
            )[:, 0]
            ww += head
        if ww < W:
            w2, s2 = native.encode_file(
                tail[(ww - wp) * SL :].reshape(-1, 1), lens[ww:],
                W - ww, WPF, st,
            )
            words[ww:] = w2[:, 0]
            snaps[ww // WPF :] = s2[:, :, 0]

    return (
        bs.assemble_stream_bytes(
            1, da.sample_rate, da.samples,
            snaps_a.reshape(Fa, 8, 1), words_a.reshape(Fa, WPF, 1),
        ),
        bs.assemble_stream_bytes(
            1, db.sample_rate, db.samples,
            snaps_b.reshape(Fb, 8, 1), words_b.reshape(Fb, WPF, 1),
        ),
    )


def encode_all_batch(
    files, backend: str = "auto"
) -> list:
    """Host-tier batch encode: many files, mono files paired.

    ``files`` is a sequence of ``(interleaved_pcm, QoaDesc)``.  Returns
    the QOA byte stream per file, in input order, each byte-identical to
    ``encode_all`` on that file alone.

    On the native backend, mono files pair up into the C==2 chain
    (nearest full-window counts pair together to maximize the shared
    prefix) for up to 2x aggregate mono throughput on real audio — see
    ``_encode_two_mono_native``.  Everything else (stereo+, non-native
    backends, an odd mono leftover) encodes per file.  For the batched
    DEVICE path (device-resident corpus encode on a GPU) use
    ``parallel.corpus.batch_encode`` instead — this is the latency-bound
    host sibling.
    """
    from . import native

    files = list(files)
    out: list = [None] * len(files)
    mono_idx = []
    for i, (pcm, desc) in enumerate(files):
        _validate_desc(desc)
        if np.asarray(pcm).size != desc.samples * desc.channels:
            raise InvalidSamples()
        if (
            desc.channels == 1
            and backend in ("auto", "native")
            and native.available()
        ):
            mono_idx.append(i)
        else:
            out[i] = encode_all(pcm, desc, backend=backend)

    # nearest window counts pair together: sort by full-window count so
    # adjacent pairs share the longest possible paired prefix
    mono_idx.sort(key=lambda i: files[i][1].samples // fmt.QOA_SLICE_LEN)
    for k in range(0, len(mono_idx) - 1, 2):
        ia, ib = mono_idx[k], mono_idx[k + 1]
        out[ia], out[ib] = _encode_two_mono_native(
            files[ia][0], files[ia][1], files[ib][0], files[ib][1]
        )
    if len(mono_idx) % 2:
        i = mono_idx[-1]
        out[i] = encode_all(files[i][0], files[i][1], backend=backend)
    return out
