"""XLA decoder kernel: batched LMS reconstruction over frame x channel chains.

The device decoder on every platform (cf. SURVEY.md §3.2; a hand-written
GPU kernel was measured on the H100 and gained nothing end to end, see
PERF.md):

* Every QOA frame serializes a full LMS snapshot in its header
  (reference src/lib.rs:271-281), so **frames decode in parallel**.
  The chain axis N = frames x channels is the vector axis; ``lax.scan``
  runs over the <=256 slice windows of a frame with the 20-step
  recurrence fully unrolled.
* Input is the one staging format of every decode path: the raw
  big-endian u64 slice words viewed as (W, N, 2) uint32 halves
  (:func:`words_u32`), 8 bytes per slice per chain.  Byte order, the
  scalefactor and the 3-bit codes are unpacked on the device.
* All arithmetic is int32 with exact two's-complement wrapping, matching
  the reference's ``wrapping_*`` ops (src/lib.rs:797-828).
* No gathers: the 16-entry scalefactor lookup is a masked select
  evaluated **once per slice**, and the 8-entry dequant row collapses to
  four per-slice magnitudes selected by ``code >> 1`` with a sign flip on
  code parity (dequant values are +/- pairs).

The decoder always reconstructs all 20 samples of a slice; truncation of
short final slices happens on the host, exactly like the reference
(src/lib.rs:291-330).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import bitstream as bs
from .. import format as fmt

_SF_TAB = [int(v) for v in fmt.QOA_SCALEFACTOR_TAB]
_I32 = jnp.int32
_U32 = jnp.uint32


def words_u32(words_be: np.ndarray) -> np.ndarray:
    """Raw big-endian u64 slice words (W, N) -> (W, N, 2) uint32, no copy.

    Each u64 is kept as its two in-memory halves; :func:`word_halves`
    turns them into the logical (hi, lo) on the device.
    """
    words_be = np.ascontiguousarray(words_be, dtype=np.uint64)
    return words_be.view(np.uint32).reshape(words_be.shape + (2,))


def bswap32(x):
    """Byte-reverse uint32 values."""
    return (
        (x >> 24)
        | ((x >> 8) & _U32(0xFF00))
        | ((x << 8) & _U32(0xFF0000))
        | (x << 24)
    )


def word_halves(raw_hi, raw_lo):
    """In-memory halves of a big-endian u64 -> logical (hi, lo) uint32."""
    return bswap32(raw_hi), bswap32(raw_lo)


def slice_magnitudes(sf):
    """Per-chain dequant magnitudes [m0..m3] for a slice's scalefactor.

    m_j == QOA_DEQUANT_MAG[sf, j], computed from the scalefactor value
    (round-ties-away of sf_val * {0.75, 2.5, 4.5, 7}):
      m0 = (3v+2)>>2,  m1 = (5v+1)>>1,  m2 = (9v+1)>>1,  m3 = 7v
    """
    sfv = jnp.zeros_like(sf)
    for s in range(16):
        sfv = jnp.where(sf == s, _SF_TAB[s], sfv)
    return (3 * sfv + 2) >> 2, (5 * sfv + 1) >> 1, (9 * sfv + 1) >> 1, 7 * sfv


def _decode_slice(carry, raw):
    """One slice window for all chains: the 20-step LMS recurrence.

    carry: 8 int32 (N,) rows (history 0-3, weights 4-7); raw: (N, 2)
    uint32 in-memory halves of the big-endian slice words.  Returns the
    new carry and the 20 reconstructed samples (20, N) int16.
    """
    h0, h1, h2, h3, w0, w1, w2, w3 = carry
    hi, lo = word_halves(raw[:, 0], raw[:, 1])
    m0, m1, m2, m3 = slice_magnitudes((hi >> 28).astype(_I32))
    outs = []
    for k in range(fmt.QOA_SLICE_LEN):
        # 3-bit code k lives at u64 bits [57-3k, 59-3k]
        if k <= 8:
            code = (hi >> (25 - 3 * k)) & 7
        elif k == 9:
            code = ((hi & 1) << 2) | (lo >> 30)
        else:
            code = (lo >> (57 - 3 * k)) & 7
        code = code.astype(_I32)
        prediction = (w0 * h0 + w1 * h1 + w2 * h2 + w3 * h3) >> 13
        idx = code >> 1
        mag = jnp.where(
            idx < 2, jnp.where(idx == 0, m0, m1), jnp.where(idx == 2, m2, m3)
        )
        dq = jnp.where((code & 1) == 0, mag, -mag)
        recon = jnp.clip(prediction + dq, -32768, 32767)
        outs.append(recon.astype(jnp.int16))
        delta = dq >> 4
        w0 = w0 + jnp.where(h0 < 0, -delta, delta)
        w1 = w1 + jnp.where(h1 < 0, -delta, delta)
        w2 = w2 + jnp.where(h2 < 0, -delta, delta)
        w3 = w3 + jnp.where(h3 < 0, -delta, delta)
        h0, h1, h2, h3 = h1, h2, h3, recon
    return (h0, h1, h2, h3, w0, w1, w2, w3), jnp.stack(outs)


@jax.jit
def decode_chains(state, words):
    """Decode all slice windows of N independent chains.

    Args:
      state: int32 (8, N) — initial LMS (history rows 0-3, weights 4-7).
      words: uint32 (W, N, 2) — raw big-endian slice words
        (:func:`words_u32`).

    Returns int16 (W, 20, N) reconstructed samples (untrimmed).
    """
    carry = tuple(state[i] for i in range(8))
    _, ys = jax.lax.scan(_decode_slice, carry, words)
    return ys


def decode_batch(
    batch,
    pad_chains_to: int | None = None,
    pad_windows_to: int | None = None,
) -> np.ndarray:
    """Decode a host FrameBatch on device -> int16 (F, W*20, C), untrimmed.

    ``pad_chains_to`` / ``pad_windows_to`` pad the chain / window axes (to
    limit jit recompilation across differently-sized files; padded chains
    and trailing padded windows decode garbage that is dropped).
    """
    F, W, C = batch.sf.shape
    N = F * C
    Np = max(pad_chains_to or N, N)
    Wp = max(pad_windows_to or W, W)

    words_be, st = bs.batch_chain_arrays(batch)
    words = np.zeros((Wp, Np), np.uint64)
    words[:W, :N] = words_be
    state = np.zeros((8, Np), dtype=np.int32)
    state[:, :N] = st

    ys = np.asarray(decode_chains(state, words_u32(words)))
    ys = ys[:W, :, :N].reshape(W, fmt.QOA_SLICE_LEN, F, C)
    return ys.transpose(2, 0, 1, 3).reshape(F, W * fmt.QOA_SLICE_LEN, C)
