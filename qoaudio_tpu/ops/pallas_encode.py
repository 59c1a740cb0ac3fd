"""GPU encoder kernel (Pallas, Triton route): the corpus encode hot path.

Same algorithm and contract as :func:`ops.encode.encode_frames` (all 16
scalefactor candidates evaluated at once, lexicographic argmin over
(total rank, first-sample rank, scalefactor), two-limb u32 ranks;
bit-exact with the reference's sequential search per SURVEY.md §3.3),
shaped for a GPU instead of being left to XLA:

* the grid covers chain blocks only.  Each program owns ``block`` chains
  and runs the frame loop and the 256-window loop itself, with the LMS
  carry in registers — nothing carries between programs, which run in
  parallel and in no order;
* a window is a (block, 16) plane: one thread per (chain, candidate).
  The argmin over the 16 candidates is a reduction along axis 1, which
  stays inside a warp;
* Triton needs power-of-two loads, so the 20-sample axis is read one row
  at a time.

XLA runs the same recurrence as F x 256 sequential loop iterations over
the whole chain axis; here the loops live inside one kernel launch.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .. import format as fmt

_NSF = fmt.QOA_NUM_SCALEFACTORS  # 16
_SLEN = fmt.QOA_SLICE_LEN  # 20

_I32 = jnp.int32
_U32 = jnp.uint32

# Chains per program: one warp, one thread per (chain, candidate), so the
# candidate reduction is warp-local.  Block 2 measured fastest of 2-32
# (experiments/gpu_block_sweep.py; the kernel is latency-bound, so the
# most programs win).
BLOCK = 2

_SF_TAB = [int(v) for v in fmt.QOA_SCALEFACTOR_TAB]
_RECIP_TAB = [int(v) for v in fmt.QOA_RECIPROCAL_TAB]


def candidate_constants(B: int):
    """Per-candidate constants for a (B, 16) plane, built from iota (a
    kernel cannot capture array constants): scalefactor index, its bits in
    the slice word, the reciprocal, and the four dequant magnitudes from
    the spec's closed forms."""
    s = jax.lax.broadcasted_iota(_I32, (B, _NSF), 1)
    sfv = jnp.zeros((B, _NSF), _I32)
    recip = jnp.zeros((B, _NSF), _I32)
    for i in range(_NSF):
        sel = s == i
        sfv = jnp.where(sel, _SF_TAB[i], sfv)
        recip = jnp.where(sel, _RECIP_TAB[i], recip)
    mags = (
        (3 * sfv + 2) >> 2,
        (5 * sfv + 1) >> 1,
        (9 * sfv + 1) >> 1,
        7 * sfv,
    )
    return s, s.astype(_U32) << 28, recip, mags


def window_body(sample_row, length, carry, consts):
    """Encode one 20-sample window for B chains, all 16 candidates.

    sample_row(k) -> (B,) int32 sample k of the window; length (B,) int32
    valid samples (0 passes the state through); carry: 8 (B,) int32 LMS
    rows (history 0-3, weights 4-7).  Returns (new carry, word_hi,
    word_lo), the words (B,) uint32.  Pure jnp on (B, 16) planes: it is
    the kernel's body and also runs as plain JAX.
    """
    s, sfbits, recip, mags = consts
    B = length.shape[0]

    def plane(v):
        return jnp.broadcast_to(v[:, None], (B, _NSF))

    H = [plane(carry[i]) for i in range(4)]
    W = [plane(carry[4 + i]) for i in range(4)]
    rank_lo = jnp.zeros((B, _NSF), _U32)
    rank_hi = jnp.zeros((B, _NSF), _I32)
    word_hi = sfbits
    word_lo = jnp.zeros((B, _NSF), _U32)
    first_lo, first_hi = rank_lo, rank_hi

    for k in range(_SLEN):
        active = plane(length > k)

        prediction = (W[0] * H[0] + W[1] * H[1] + W[2] * H[2] + W[3] * H[3]) >> 13
        ssum = W[0] * W[0] + W[1] * W[1] + W[2] * W[2] + W[3] * W[3]
        penalty = jnp.maximum((ssum >> 18) - 0x8FF, 0)
        pen_sq = (penalty * penalty).astype(_U32)

        sample = plane(sample_row(k))
        residual = sample - prediction
        n = (residual * recip + (1 << 15)) >> 16
        # sgn(v) == clip(v, -1, 1); both signs are needed because the
        # wrapping reciprocal multiply can flip sgn(n) against sgn(residual)
        scaled = n + jnp.clip(residual, -1, 1) - jnp.clip(n, -1, 1)
        # QOA_QUANT_TAB closed form with the [-8, 8] clamp absorbed:
        # idx = min(|scaled| >> 1, 3), code = (idx << 1) | (scaled < 0)
        neg = scaled < 0
        idx = jnp.minimum(jnp.abs(scaled) >> 1, 3)
        q = (idx << 1) | neg.astype(_I32)
        mag = jnp.where(
            idx < 2,
            jnp.where(idx == 0, mags[0], mags[1]),
            jnp.where(idx == 2, mags[2], mags[3]),
        )
        dq = jnp.where(neg, -mag, mag)
        recon = jnp.clip(prediction + dq, -32768, 32767)

        err = (sample - recon).astype(_U32)
        err_sq = jnp.where(active, err * err, _U32(0))
        pen_sq = jnp.where(active, pen_sq, _U32(0))
        lo1 = rank_lo + err_sq
        c1 = (lo1 < rank_lo).astype(_I32)
        lo2 = lo1 + pen_sq
        c2 = (lo2 < lo1).astype(_I32)
        rank_lo = lo2
        rank_hi = rank_hi + c1 + c2
        if k == 0:
            first_lo, first_hi = rank_lo, rank_hi

        # 3-bit code k lives at u64 bits [57-3k, 59-3k]
        qa = jnp.where(active, q, 0).astype(_U32)
        if k <= 8:
            word_hi = word_hi | (qa << (25 - 3 * k))
        elif k == 9:
            word_hi = word_hi | (qa >> 2)
            word_lo = word_lo | ((qa & 3) << 30)
        else:
            word_lo = word_lo | (qa << (57 - 3 * k))

        delta = dq >> 4
        W = [
            jnp.where(active, W[t] + jnp.where(H[t] < 0, -delta, delta), W[t])
            for t in range(4)
        ]
        H = [
            jnp.where(active, nxt, H[t])
            for t, nxt in enumerate([H[1], H[2], H[3], recon])
        ]

    # Lexicographic argmin (total, first, sf), ties -> lowest sf, as staged
    # masked min-reductions over the candidate axis.
    def row_min(a, fill):
        return jnp.min(jnp.where(ok, a, fill), axis=1)[:, None]

    ok = rank_hi == jnp.min(rank_hi, axis=1)[:, None]
    ok = ok & (rank_lo == row_min(rank_lo, _U32(0xFFFFFFFF)))
    ok = ok & (first_hi == row_min(first_hi, _I32(0x7FFFFFFF)))
    ok = ok & (first_lo == row_min(first_lo, _U32(0xFFFFFFFF)))
    pick = s == row_min(s, _I32(_NSF))

    def sel(a):
        return jnp.sum(jnp.where(pick, a, jnp.zeros_like(a)), axis=1)

    new_carry = tuple(sel(H[t]) for t in range(4)) + tuple(
        sel(W[t]) for t in range(4)
    )
    return new_carry, sel(word_hi), sel(word_lo)


def _encode_kernel(x_ref, lens_ref, state_ref, hi_ref, lo_ref, snaps_ref,
                   state_out_ref):
    F, W = x_ref.shape[0], x_ref.shape[1]
    B = x_ref.shape[3]
    consts = candidate_constants(B)

    def frame(f, carry):
        # per-frame LMS snapshot (serialized into the frame header)
        for i in range(8):
            snaps_ref[f, i, :] = carry[i]

        def window(w, carry):
            carry, wh, wl = window_body(
                lambda k: x_ref[f, w, k, :].astype(_I32),
                lens_ref[f, w, :],
                carry,
                consts,
            )
            hi_ref[f, w, :] = wh
            lo_ref[f, w, :] = wl
            return carry

        return jax.lax.fori_loop(0, W, window, carry)

    carry = jax.lax.fori_loop(
        0, F, frame, tuple(state_ref[i, :] for i in range(8))
    )
    for i in range(8):
        state_out_ref[i, :] = carry[i]


@functools.partial(jax.jit, static_argnames=("block",))
def encode_frames_pallas(state, samples, lens, block: int = BLOCK):
    """Pallas analog of :func:`ops.encode.encode_frames` (same contract).

    state (8, N) int32; samples (F, W, 20, N) int16 or int32; lens
    (F, W, N) int32, W <= 256 windows per frame.  N must be a multiple of
    ``block`` (a power of two).  Returns (new_state, snaps (F, 8, N),
    word_hi, word_lo (F, W, N) uint32).
    """
    F, W, _, N = samples.shape
    assert N % block == 0, f"pad the chain axis to a multiple of {block}"
    hi, lo, snaps, new_state = pl.pallas_call(
        _encode_kernel,
        grid=(N // block,),
        in_specs=[
            pl.BlockSpec((F, W, _SLEN, block), lambda i: (0, 0, 0, i)),
            pl.BlockSpec((F, W, block), lambda i: (0, 0, i)),
            pl.BlockSpec((8, block), lambda i: (0, i)),
        ],
        out_specs=(
            pl.BlockSpec((F, W, block), lambda i: (0, 0, i)),
            pl.BlockSpec((F, W, block), lambda i: (0, 0, i)),
            pl.BlockSpec((F, 8, block), lambda i: (0, 0, i)),
            pl.BlockSpec((8, block), lambda i: (0, i)),
        ),
        out_shape=(
            jax.ShapeDtypeStruct((F, W, N), _U32),
            jax.ShapeDtypeStruct((F, W, N), _U32),
            jax.ShapeDtypeStruct((F, 8, N), _I32),
            jax.ShapeDtypeStruct((8, N), _I32),
        ),
        compiler_params=plgpu.CompilerParams(
            num_warps=max(1, block * _NSF // 32), num_stages=1
        ),
        backend="triton",
        name="qoa_encode",
    )(samples, lens, state)
    return new_state, snaps, hi, lo
