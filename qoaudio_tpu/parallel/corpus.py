"""Batched multi-file corpus transcode (the new top layer, SURVEY.md §1).

Packs the channels of many files into one chain axis so a whole corpus
encodes in a handful of kernel launches: files are padded to a common
frame count with zero-length slices (which pass LMS state through
unchanged), and the chain axis optionally shards over a device mesh.
The encode kernel is the platform's (:func:`qoaudio_tpu.ops.encode_kernel`):
the Pallas kernel on a GPU, the XLA kernel elsewhere; decode is the XLA
kernel everywhere.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional, Sequence

import numpy as np

from .. import bitstream as bs
from .. import codec
from .. import format as fmt
from ..types import DecodedQoa, QoaDesc


@dataclasses.dataclass
class CorpusFile:
    path: str
    desc: QoaDesc
    pcm: np.ndarray  # interleaved int16


@dataclasses.dataclass
class TranscodeReport:
    files: List[str]
    total_samples: int
    encode_seconds: float
    decode_seconds: float
    results: List[dict]
    ok: bool = True

    def lines(self) -> List[str]:
        out = []
        for r in self.results:
            out.append(
                f"{r['path']}: {r['samples']} samples, "
                f"compression {r['ratio']:.2f}x, rms {r['rms']:.1f}"
                + (", bit-exact re-decode" if r["exact"] else "")
            )
        msps_enc = self.total_samples / self.encode_seconds / 1e6
        msps_dec = self.total_samples / self.decode_seconds / 1e6
        out.append(
            f"corpus: {len(self.files)} files, {self.total_samples} samples; "
            f"decode {msps_dec:.1f} Msamples/s, encode {msps_enc:.1f} Msamples/s"
        )
        return out


def _jax_platform():
    """The active jax platform, or None when no backend can initialize
    (e.g. a clobbered environment) — callers degrade to the host engine."""
    try:
        import jax

        return jax.devices()[0].platform
    except Exception:
        return None


def _encode_kernel(mesh):
    """(encode fn, chain multiple) for the default device or a mesh."""
    from ..ops import encode_kernel

    if mesh is not None:
        from .mesh import encode_frames_sharded, encode_multiple

        return (
            lambda st, cx, cl: encode_frames_sharded(mesh, st, cx, cl),
            encode_multiple(mesh),
        )
    return encode_kernel(_jax_platform())


def batch_encode(
    files: Sequence[tuple[np.ndarray, QoaDesc]],
    mesh=None,
    chunk_frames: int = 64,
) -> List[bytes]:
    """Encode many PCM streams in one batched chain axis.

    Returns QOA bytes per file, each bit-exact with single-file encoding
    (chains are independent lanes; padding slices are inert).  On a GPU
    the Pallas kernel runs the hot loop (chains padded to its block).
    """
    from ..codec import initial_encoder_state

    if not files:
        return []
    for pcm, desc in files:
        codec._validate_desc(desc)
        if np.asarray(pcm).size != desc.samples * desc.channels:
            from ..errors import InvalidSamples

            raise InvalidSamples()

    if mesh is None and _jax_platform() is None:
        # no usable jax backend (e.g. a clobbered environment): the host
        # engine still delivers the same bit-exact streams — with mono
        # files paired into the C==2 chain (codec._encode_two_mono_native)
        return codec.encode_all_batch(files)

    layouts = [codec.layout_pcm(pcm, d.channels, d.samples) for pcm, d in files]
    F_max = max(F for _, _, F in layouts)
    chunk = min(chunk_frames, codec._next_pow2(F_max))
    F_pad = -(-F_max // chunk) * chunk

    # Scan only the windows the corpus actually has: any multi-frame file
    # forces full 256-window frames, but a corpus of sub-frame clips scans
    # just ceil(max samples / 20) windows (trailing zero-length windows
    # pass LMS state through unchanged, so dropping them is bit-identical).
    W_use = max(
        fmt.QOA_SLICES_PER_FRAME
        if F > 1
        else -(-d.samples // fmt.QOA_SLICE_LEN)
        for (_, d), (_, _, F) in zip(files, layouts)
    )

    # chain offsets per file
    offsets = []
    n = 0
    for _, d in files:
        offsets.append(n)
        n += d.channels
    N = n

    kernel, n_multiple = _encode_kernel(mesh)
    N = -(-N // n_multiple) * n_multiple  # pad chains for kernel/mesh tiles

    state = initial_encoder_state(0, N)  # same init weights for every chain

    # Chunked scan; the carried state stays on device between chunks.
    # Memory model: the chain-wide staging array is assembled PER CHUNK
    # (never the whole corpus — peak host staging is chunk x 256 x 20 x N
    # int16), and completed chunks drain through a 2-deep staging window,
    # so chunk k-2's results transfer while chunk k computes (async
    # dispatch) and peak device memory for outputs is 3 chunks, not the
    # corpus.  The per-file layouts (~2x the input PCM) are the only
    # corpus-sized host allocation.
    from collections import deque

    words_parts = []
    snaps_parts = []
    staged = deque()

    def _drain_one():
        snaps_d, hi_d, lo_d = staged.popleft()
        snaps_parts.append(np.asarray(snaps_d))
        words_parts.append(
            (np.asarray(hi_d).astype(np.uint64) << np.uint64(32))
            | np.asarray(lo_d).astype(np.uint64)
        )

    for f0 in range(0, F_pad, chunk):
        cx = np.zeros((chunk, W_use, fmt.QOA_SLICE_LEN, N), np.int16)
        cl = np.zeros((chunk, W_use, N), np.int32)
        for (pcm, d), (xf, lf, F), off in zip(files, layouts, offsets):
            k = min(F - f0, chunk)
            if k > 0:
                cx[:k, :, :, off : off + d.channels] = xf[f0 : f0 + k, :W_use]
                cl[:k, :, off : off + d.channels] = lf[
                    f0 : f0 + k, :W_use, None
                ]
        state, snaps, hi, lo = kernel(state, cx, cl)
        staged.append((snaps, hi, lo))
        while len(staged) > 2:
            _drain_one()
    while staged:
        _drain_one()
    snaps = np.concatenate(snaps_parts)  # (F_pad, 8, N)
    words = np.concatenate(words_parts)  # (F_pad, 256, N)

    out: List[bytes] = []
    for (pcm, d), (xf, lf, F), off in zip(files, layouts, offsets):
        C = d.channels
        out.append(
            bs.assemble_stream_bytes(
                C,
                d.sample_rate,
                d.samples,
                np.ascontiguousarray(snaps[:, :, off : off + C]),
                np.ascontiguousarray(words[:, :, off : off + C]),
            )
        )
    return out


def _stage_words(parsed, offs, W: int, Np: int):
    """Stage per-file raw big-endian slice words and frame-start LMS into
    dense (words_be (W, Np) uint64, state (8, Np) int32) chain arrays —
    the one staging format of every decode path (the device kernels take
    ``ops.decode.words_u32(words_be)``, the native engine the u64s)."""
    words_be = np.zeros((W, Np), np.uint64)
    state = np.zeros((8, Np), np.int32)
    for p, off in zip(parsed, offs):
        k = p.n_frames * p.channels
        words_be[: p.max_windows, off : off + k] = p.words_be
        state[:, off : off + k] = p.state
    return words_be, state


def _interleave_file(dec_sub, p) -> np.ndarray:
    """One file's chain-layout decode -> flat interleaved trimmed PCM.

    Uses the native fused interleave+trim when every non-final frame is
    window-aligned (its single trailing trim is only valid then); any
    non-aligned uniform geometry trims per frame instead — the same
    guard decode_all's host path applies (codec.py)."""
    from .. import native

    F, C = p.n_frames, p.channels
    W20 = p.max_windows * fmt.QOA_SLICE_LEN
    spf = p.samples_per_frame
    total = int(spf.sum())
    if native.available():
        if bool(np.all(spf[:-1] == W20)):
            return native.interleave_trim(dec_sub, F, C, total).reshape(-1)
        arr = native.interleave_trim(dec_sub, F, C, F * W20).reshape(F, W20, C)
    else:
        arr = (
            dec_sub.reshape(p.max_windows, fmt.QOA_SLICE_LEN, F, C)
            .transpose(2, 0, 1, 3)
            .reshape(F, W20, C)
        )
    return np.concatenate([arr[i, : spf[i]] for i in range(F)]).reshape(-1)


def batch_decode(streams: Sequence[bytes], mesh=None) -> List[DecodedQoa]:
    """Decode many QOA byte streams in ONE batched kernel launch.

    Decode has no cross-frame state (every frame header carries its LMS
    seed, reference src/lib.rs:271-281), so the chains of ALL files —
    frames x channels each — concatenate into one chain axis: the device
    decoder on a GPU, the native engine on a CPU backend; with ``mesh``
    the chain axis shards over the devices (the decoder under shard_map —
    no cross-device communication).  Streams the fast arithmetic parser
    rejects fall back to per-file decoding; the REST of the corpus still
    batches.
    """
    from .. import native
    from ..bitstream import parse_file_arrays

    if not streams:
        return []
    parsed = [parse_file_arrays(d) for d in streams]
    if any(p is None for p in parsed):
        # decode the rejected streams per-file; everything else batches
        good = [(i, d) for i, (d, p) in enumerate(zip(streams, parsed)) if p]
        outs: List[Optional[DecodedQoa]] = [None] * len(streams)
        for i, (d, p) in enumerate(zip(streams, parsed)):
            if p is None:
                outs[i] = codec.decode_all(d)
        for (i, _), out in zip(
            good, batch_decode([d for _, d in good], mesh=mesh)
        ):
            outs[i] = out
        return outs

    W = max(p.max_windows for p in parsed)
    offs = []
    n = 0
    for p in parsed:
        offs.append(n)
        n += p.n_frames * p.channels
    N = n

    from ..ops.decode import decode_chains, words_u32

    if mesh is not None:
        from .mesh import decode_chains_sharded, round_up

        words_be, state = _stage_words(parsed, offs, W, round_up(N, mesh.size))
        dec = np.asarray(
            decode_chains_sharded(mesh, state, words_u32(words_be))
        )
    else:
        words_be, state = _stage_words(parsed, offs, W, N)
        if _jax_platform() != "gpu" and native.available():
            # CPU backend (or none): the host engine is the fast decoder
            dec = native.decode_chains(words_be, state)
        else:
            dec = np.asarray(decode_chains(state, words_u32(words_be)))

    outs = []
    for p, off in zip(parsed, offs):
        k = p.n_frames * p.channels
        sub = np.ascontiguousarray(dec[: p.max_windows, :, off : off + k])
        outs.append(
            DecodedQoa(
                num_channels=p.channels,
                sample_rate=p.sample_rate,
                samples=_interleave_file(sub, p).astype(np.int16, copy=False),
            )
        )
    return outs


def _transcode_lens(samples_i32, F_pad: int, W_enc: int):
    """lens[f, w, j] = clip(min(samples_j - f*5120, 5120) - w*20, 0, 20)."""
    import jax.numpy as jnp

    f_i = jnp.arange(F_pad, dtype=jnp.int32)[:, None, None]
    w_i = jnp.arange(W_enc, dtype=jnp.int32)[None, :, None]
    spc = jnp.clip(
        samples_i32[None, None, :] - f_i * fmt.QOA_FRAME_LEN,
        0,
        fmt.QOA_FRAME_LEN,
    )
    return jnp.clip(spc - w_i * fmt.QOA_SLICE_LEN, 0, fmt.QOA_SLICE_LEN)


# Length-bucketing cost model (batch_transcode): one extra fused dispatch
# costs about this many padded lane-frames of encode work, and a
# partition must beat the single launch by at least 1/MIN_GAIN before the
# extra dispatches are worth it.  Derived on an NVIDIA H100 80GB HBM3 at a
# 700 W power limit (chip_smoke.py): one fused dispatch of a one-clip
# corpus 2.088 ms over the 288.9 ns that each added padded lane-frame
# costs the encode kernel (4 frames, 16,384 -> 65,536 chains) = 7,227.
_BUCKET_OVERHEAD = 7227.0
_BUCKET_MIN_GAIN = 0.75


def _length_buckets(frame_counts, chans, e_mult, chunk_frames):
    """Partition files into frame-count buckets minimizing padded encode
    work.

    The encode kernel's cost is F_pad x Nep padded lane-frames per launch
    (every chain runs every frame step: chains are indivisible and cannot
    stop early), so a mixed-length corpus with more than one block of
    chains wastes whole blocks on the short files' padding.  Exact DP over
    the length-sorted order:
    cost(bucket) = F_pad * ceil(Ne/e_mult)*e_mult + _BUCKET_OVERHEAD, the
    optimal partition is contiguous in sorted order.  Returns a list of
    index lists (original input order within each bucket), or ``None``
    when one launch is within ``_BUCKET_MIN_GAIN`` of the optimum (the
    <=1-block case always lands here).
    """
    n = len(frame_counts)
    if n < 2:
        return None
    order = sorted(range(n), key=lambda i: (frame_counts[i], i))
    f_sorted = [frame_counts[i] for i in order]

    def fpad(fmax):
        chunk = min(chunk_frames, codec._next_pow2(int(fmax)))
        return -(-int(fmax) // chunk) * chunk

    fpads = np.asarray([fpad(f) for f in f_sorted], np.float64)
    csum = np.zeros(n + 1, np.float64)
    csum[1:] = np.cumsum([chans[i] for i in order])
    best = np.full(n + 1, np.inf)
    best[0] = 0.0
    cut = np.zeros(n + 1, np.int32)
    for i in range(1, n + 1):
        nep = np.ceil((csum[i] - csum[:i]) / e_mult) * e_mult
        cost = best[:i] + fpads[i - 1] * nep + _BUCKET_OVERHEAD
        j = int(np.argmin(cost))
        best[i], cut[i] = cost[j], j
    single = fpads[-1] * np.ceil(csum[n] / e_mult) * e_mult + _BUCKET_OVERHEAD
    if not best[n] < _BUCKET_MIN_GAIN * single:
        return None
    segs, i = [], n
    while i > 0:
        j = int(cut[i])
        segs.append(sorted(order[j:i]))
        i = j
    segs.reverse()
    return segs


class _CompositeFusedHandle:
    """Fused handles of every length bucket of one ``batch_transcode``
    call.  Calling it re-dispatches each bucket's pipeline in order and
    returns the LAST bucket's outputs — single-device launches execute
    in submission order, so syncing the returned arrays covers every
    bucket."""

    __slots__ = ("handles",)

    def __init__(self, handles):
        self.handles = handles

    def __call__(self):
        r = None
        for h in self.handles:
            r = h()
        return r


_TRANSCODE_FUSED_CACHE: dict = {}


class TranscodeFusedHandle:
    """Explicit handle onto a ``batch_transcode`` call's staged device
    pipeline, returned by ``batch_transcode(..., return_fused_handle=True)``.

    Holds the jitted fused pipeline (decode -> relayout -> lens -> encode ->
    tight packing) and its DEVICE-RESIDENT arguments, which pins the staged
    corpus in device memory for the handle's lifetime — drop the handle to
    free it.  Calling the handle re-dispatches the whole pipeline in one
    launch with no host staging; ``bench.py`` uses this to time the
    device-side rate of the deployment pipeline (the e2e number minus
    host staging and transfers)."""

    __slots__ = ("fn", "args")

    def __init__(self, fn, args):
        self.fn = fn
        self.args = args

    def __call__(self):
        return self.fn(*self.args)


def _relayout_encode_input(decT, metas, W_enc: int, F_pad: int, Ne: int,
                           Nep: int):
    """Decode-chain layout -> encoder frame layout, (F_pad, W_enc, 20, Nep).

    decT: (Nd, W_enc, 20) transposed decode output.  ONE take along the
    chain (major) axis with a precomputed (F_pad*Nep,) row index, then a
    single majors-only transpose.  Invalid slots (f >= F_i, or pad lanes
    past Ne) point at row 0 — their ``lens`` are 0, so the encode kernel
    passes state through and their words/snaps are sliced away by the
    per-file packing; the values never matter.

    Shared by the fused jit pipeline and the mesh branch (eager on the
    global array) so the two cannot diverge.
    """
    import jax.numpy as jnp

    idx = np.zeros((F_pad, Nep), np.int32)
    for F_i, C, doff, eoff in metas:
        for c in range(C):
            idx[:F_i, eoff + c] = doff + np.arange(F_i) * C + c
    x = jnp.take(decT, jnp.asarray(idx.reshape(-1)), axis=0)
    x = x.reshape(F_pad, Nep, W_enc, fmt.QOA_SLICE_LEN)
    return jnp.transpose(x, (0, 2, 3, 1))


def _transcode_fused_fn(metas, W_enc: int, F_pad: int, Ne: int, Nep: int,
                        platform):
    """Build (and cache per corpus signature) ONE jitted device function
    for the whole pipeline: decode -> chain relayout -> lens -> full
    encode (the platform's kernel) -> tight per-file packing of the
    outputs.  One dispatch per corpus, and only the compressed words and
    LMS snapshots of real frames leave the device: each file's
    (F_i, W_enc, C_i) region is concatenated into flat u32 buffers on the
    device, so the fetch is exactly the compressed payload.
    """
    import jax
    import jax.numpy as jnp

    from ..ops import encode_kernel
    from ..ops.decode import decode_chains

    key = (metas, W_enc, F_pad, Ne, Nep, platform)
    fn = _TRANSCODE_FUSED_CACHE.get(key)
    if fn is not None:
        return fn
    encode, _ = encode_kernel(platform)

    @jax.jit
    def fused(dstate, words, samples_i32, state):
        dec = decode_chains(dstate, words)  # (W, 20, Ndp)
        decT = jnp.transpose(dec[:W_enc], (2, 0, 1))  # (Nd, W_enc, 20)
        x_enc = _relayout_encode_input(decT, metas, W_enc, F_pad, Ne, Nep)
        lens = _transcode_lens(samples_i32, F_pad, W_enc)
        _, snaps, whi, wlo = encode(state, x_enc, lens)
        hp, lp, sp = [], [], []
        for F_i, C, _doff, eoff in metas:
            hp.append(whi[:F_i, :, eoff : eoff + C].reshape(-1))
            lp.append(wlo[:F_i, :, eoff : eoff + C].reshape(-1))
            sp.append(snaps[:F_i, :, eoff : eoff + C].reshape(-1))
        return (
            jnp.concatenate(sp),
            jnp.concatenate(hp),
            jnp.concatenate(lp),
        )

    if len(_TRANSCODE_FUSED_CACHE) >= 32:  # bound compile-cache growth
        _TRANSCODE_FUSED_CACHE.pop(next(iter(_TRANSCODE_FUSED_CACHE)))
    _TRANSCODE_FUSED_CACHE[key] = fused
    return fused


def batch_transcode(
    streams: Sequence[bytes],
    chunk_frames: int = 64,
    mesh=None,
    *,
    return_fused_handle: bool = False,
    bucket="auto",
):
    """Transcode many QOA streams with PCM **device-resident end to end**
    (the BASELINE.json north-star deployment shape): the decode kernel's
    output re-lays out ON DEVICE into the encoder's frame layout and feeds
    the encode kernel directly — only the compressed slice words and LMS
    snapshots ever return to the host.

    The device re-layout is pure indexing: with standard 5120-sample input
    frames, decoded sample (frame f, window w, offset k) of a file IS
    encoder sample (f, w, k), so one gather over the chain axis maps
    decode chains (file x frame x channel) onto encode chains
    (file x channel) and ``lens`` derives from per-file sample counts with
    broadcast arithmetic.  Single-frame files of any length satisfy this
    trivially; multi-frame streams with non-standard uniform frame sizes
    (or streams the arithmetic parser rejects) fall back to the host
    decode -> encode pair, which produces identical bytes.

    With ``mesh`` both the decode chain axis and the encode chain axis
    shard independently over the devices (no hot-loop collectives — the
    chains are embarrassingly parallel; only the relayout reshards).

    With ``return_fused_handle=True`` the return value is
    ``(outs, handle)`` where ``handle`` is a :class:`TranscodeFusedHandle`
    onto the staged single-dispatch device pipeline, or ``None`` when no
    fused pipeline ran (empty corpus, no jax backend, or the ``mesh``
    path).  When part of the corpus falls back to the host pair, the
    handle covers the device-eligible subset.

    ``bucket="auto"`` (default) splits a mixed-length corpus with more
    than one kernel block of encode chains into frame-count buckets, each
    its own fused dispatch, whenever that reduces padded encode work by
    >= 1/0.75 (every chain runs every padded frame step, so short files
    in a long corpus waste whole blocks; see :func:`_length_buckets`).
    Bucketing never changes bytes — chains are independent.
    ``bucket=False`` forces the single launch.
    """
    import jax
    import jax.numpy as jnp

    from ..bitstream import parse_file_arrays

    def _ret(outs, handle=None):
        return (outs, handle) if return_fused_handle else outs

    if not streams:
        return _ret([])

    def _host_pair(d: bytes) -> bytes:
        out = codec.decode_all(d)
        return codec.encode_all(
            out.samples,
            QoaDesc(out.num_channels, out.sample_rate, out.samples_per_channel),
        )

    if _jax_platform() is None:
        # batch the encode side so mono files pair into the C==2 chain
        # (codec._encode_two_mono_native) instead of paying per-file mono16
        decoded = [codec.decode_all(d) for d in streams]
        return _ret(
            codec.encode_all_batch(
                [
                    (
                        o.samples,
                        QoaDesc(
                            o.num_channels, o.sample_rate,
                            o.samples_per_channel,
                        ),
                    )
                    for o in decoded
                ]
            )
        )
    parsed = [parse_file_arrays(d) for d in streams]

    def _eligible(p) -> bool:
        return p is not None and (
            p.n_frames == 1
            or int(p.samples_per_frame[0]) == fmt.QOA_FRAME_LEN
        )

    if not all(_eligible(p) for p in parsed):
        # only the rejected streams pay the host decode->encode pair; the
        # rest of the corpus still runs the device pipeline
        good = [
            (i, d) for i, (d, p) in enumerate(zip(streams, parsed)) if _eligible(p)
        ]
        outs: List[Optional[bytes]] = [None] * len(streams)
        for i, (d, p) in enumerate(zip(streams, parsed)):
            if not _eligible(p):
                outs[i] = _host_pair(d)
        sub_handle = None
        if good:
            sub_outs, sub_handle = batch_transcode(
                [d for _, d in good],
                chunk_frames=chunk_frames,
                mesh=mesh,
                return_fused_handle=True,
                bucket=bucket,
            )
            for (i, _), data in zip(good, sub_outs):
                outs[i] = data
        return _ret(outs, sub_handle)

    platform = _jax_platform()
    _, e_mult = _encode_kernel(mesh)
    d_mult = 1
    if mesh is not None:
        from .mesh import mesh_platform

        platform = mesh_platform(mesh)
        d_mult = mesh.size

    # ---- length bucketing: mixed lengths over >1 block of chains ----
    if bucket:
        segs = _length_buckets(
            [p.n_frames for p in parsed],
            [p.channels for p in parsed],
            e_mult,
            chunk_frames,
        )
        if segs is not None:
            outs = [None] * len(streams)
            handles = []
            for seg in segs:
                sub, h = batch_transcode(
                    [streams[i] for i in seg],
                    chunk_frames=chunk_frames,
                    mesh=mesh,
                    return_fused_handle=True,
                    bucket=False,
                )
                if h is not None:
                    handles.append(h)
                for i, b in zip(seg, sub):
                    outs[i] = b
            return _ret(
                outs, _CompositeFusedHandle(handles) if handles else None
            )

    from ..codec import initial_encoder_state
    from ..ops.decode import words_u32

    # ---- decode staging: all files' chains, one raw-word array ----
    W = max(p.max_windows for p in parsed)
    doffs = []
    n = 0
    for p in parsed:
        doffs.append(n)
        n += p.n_frames * p.channels
    Ndp = -(-n // d_mult) * d_mult
    words_be, dstate = _stage_words(parsed, doffs, W, Ndp)
    words = words_u32(words_be)

    # ---- encode geometry ----
    eoffs = []
    n = 0
    for p in parsed:
        eoffs.append(n)
        n += p.channels
    Ne = n
    Nep = -(-Ne // e_mult) * e_mult

    F_max = max(p.n_frames for p in parsed)
    chunk = min(chunk_frames, codec._next_pow2(F_max))
    F_pad = -(-F_max // chunk) * chunk
    W_enc = max(
        fmt.QOA_SLICES_PER_FRAME if p.n_frames > 1 else p.max_windows
        for p in parsed
    )

    samples = np.zeros(Nep, np.int32)  # samples/channel per enc chain
    for p, eoff in zip(parsed, eoffs):
        samples[eoff : eoff + p.channels] = int(p.samples_per_frame.sum())

    metas = tuple(
        (p.n_frames, p.channels, doff, eoff)
        for p, doff, eoff in zip(parsed, doffs, eoffs)
    )
    state = initial_encoder_state(0, Nep)
    handle = None
    if mesh is None:
        # the WHOLE device pipeline (decode, relayout, lens, encode, tight
        # packing) in ONE jitted dispatch, cached per corpus signature
        fn = _transcode_fused_fn(metas, W_enc, F_pad, Ne, Nep, platform)
        args = tuple(jax.device_put(a) for a in (dstate, words, samples, state))
        if return_fused_handle:
            handle = TranscodeFusedHandle(fn, args)
        sp, hp, lp = jax.device_get(fn(*args))

        out: List[bytes] = []
        o_w = o_s = 0
        for (F_i, C, _doff, _eoff), p in zip(metas, parsed):
            nw = F_i * W_enc * C
            words_f = (
                hp[o_w : o_w + nw].astype(np.uint64) << np.uint64(32)
            ) | lp[o_w : o_w + nw].astype(np.uint64)
            snaps_f = sp[o_s : o_s + F_i * 8 * C].reshape(F_i, 8, C)
            o_w += nw
            o_s += F_i * 8 * C
            out.append(
                bs.assemble_stream_bytes(
                    C,
                    p.sample_rate,
                    int(p.samples_per_frame.sum()),
                    snaps_f,
                    words_f.reshape(F_i, W_enc, C),
                )
            )
        return _ret(out, handle)

    # mesh path: the sharded kernels around an eager relayout (XLA
    # reshards between stages); the encode runs chunk by chunk
    from .mesh import decode_chains_sharded, encode_frames_sharded

    dec = decode_chains_sharded(mesh, dstate, words)
    decT = jnp.transpose(dec[:W_enc], (2, 0, 1))  # (Nd, W_enc, 20)
    x_enc = _relayout_encode_input(decT, metas, W_enc, F_pad, Ne, Nep)
    lens = _transcode_lens(jnp.asarray(samples), F_pad, W_enc)
    state_d = state
    words_parts, snaps_parts = [], []
    for f0 in range(0, F_pad, chunk):
        state_d, snaps, whi, wlo = encode_frames_sharded(
            mesh, state_d, x_enc[f0 : f0 + chunk], lens[f0 : f0 + chunk]
        )
        words_parts.append((whi[:, :, :Ne], wlo[:, :, :Ne]))
        snaps_parts.append(snaps[:, :, :Ne])
    words = np.concatenate(
        [
            (np.asarray(h).astype(np.uint64) << np.uint64(32))
            | np.asarray(l).astype(np.uint64)
            for h, l in words_parts
        ]
    )  # (F_pad, W_enc, Ne)
    snaps = np.concatenate([np.asarray(s) for s in snaps_parts])

    # ---- host byte assembly (compressed-domain only, vectorized) ----
    out: List[bytes] = []
    for p, eoff in zip(parsed, eoffs):
        C = p.channels
        out.append(
            bs.assemble_stream_bytes(
                C,
                p.sample_rate,
                int(p.samples_per_frame.sum()),
                np.ascontiguousarray(snaps[:, :, eoff : eoff + C]),
                np.ascontiguousarray(words[:, :, eoff : eoff + C]),
            )
        )
    return _ret(out)


def transcode_corpus(
    paths: Sequence[str],
    out_dir: Optional[str] = None,
    verify: bool = True,
    mesh=None,
) -> TranscodeReport:
    """Decode a set of QOA files, re-encode them batched, verify, report."""
    datas = []
    for p in paths:
        with open(p, "rb") as f:
            datas.append(f.read())
    t0 = time.perf_counter()
    outs = batch_decode(datas, mesh=mesh)
    decoded = [
        CorpusFile(
            path=p,
            desc=QoaDesc(d.num_channels, d.sample_rate, d.samples_per_channel),
            pcm=d.samples,
        )
        for p, d in zip(paths, outs)
    ]
    decode_seconds = time.perf_counter() - t0

    t0 = time.perf_counter()
    encoded = batch_encode([(c.pcm, c.desc) for c in decoded], mesh=mesh)
    encode_seconds = time.perf_counter() - t0

    results = []
    ok = True
    total = 0
    for c, data in zip(decoded, encoded):
        total += len(c.pcm)
        r = {
            "path": c.path,
            "samples": len(c.pcm),
            "ratio": (len(c.pcm) * 2) / len(data),
            "rms": 0.0,
            "exact": False,
        }
        if verify:
            again = codec.decode_all(data)
            err = again.samples.astype(np.float64) - c.pcm.astype(np.float64)
            r["rms"] = float(np.sqrt((err**2).mean()))
            r["exact"] = bool(np.array_equal(again.samples, c.pcm))
            if r["rms"] >= 500:
                ok = False
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            name = os.path.splitext(os.path.basename(c.path))[0] + ".qoa"
            with open(os.path.join(out_dir, name), "wb") as f:
                f.write(data)
        results.append(r)

    return TranscodeReport(
        files=list(paths),
        total_samples=total,
        encode_seconds=encode_seconds,
        decode_seconds=decode_seconds,
        results=results,
        ok=ok,
    )
