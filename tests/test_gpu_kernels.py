"""The GPU encode kernel (Pallas, Triton route), the device decoder and
the corpus layer's choice between them.

The encode kernel is too slow to interpret on the CPU, so its window
body — pure jnp, everything but the grid and loop plumbing — is pinned as
a plain function against the XLA kernel, and the kernel is lowered for
CUDA to prove Triton accepts every operation.  Tests marked ``gpu`` run
it as compiled for the card (``QOA_TEST_GPU=1 pytest -m gpu``, or
``python chip_smoke.py``).

Word-endianness contract: the native engine takes raw big-endian u64
slice words; the device decoder takes the same bytes viewed as (W, N, 2)
uint32 (``ops.decode.words_u32``) and byte-swaps on the device.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qoaudio_tpu import bitstream as bs
from qoaudio_tpu import codec, native
from qoaudio_tpu.ops import encode_kernel
from qoaudio_tpu.ops import pallas_encode as pe
from qoaudio_tpu.ops.decode import bswap32, decode_chains, words_u32
from qoaudio_tpu.ops.encode import encode_frames, initial_encoder_state
from qoaudio_tpu.types import QoaDesc


def _random_words(rng, W, N):
    """Adversarial raw big-endian words: every scalefactor, random codes."""
    logical = rng.integers(0, 1 << 63, size=(W, N), dtype=np.int64).astype(
        np.uint64
    ) | (rng.integers(0, 16, size=(W, N), dtype=np.uint64) << np.uint64(60))
    return logical.byteswap()


# ------------------------------------------------------------ device decode


def test_device_decode_matches_native_adversarial():
    """Raw big-endian words in the weight-wrap regime: the device decoder
    unpacks byte order, scalefactor and codes itself."""
    if not native.available():
        pytest.skip("native engine unavailable")
    rng = np.random.default_rng(3)
    words_be = _random_words(rng, 8, 64)
    state = rng.integers(-32768, 32768, size=(8, 64)).astype(np.int32)
    out = np.asarray(decode_chains(state, words_u32(words_be)))
    assert np.array_equal(out, native.decode_chains(words_be, state))


def test_device_decode_matches_native_real_stream(fixture_bytes):
    if not native.available():
        pytest.skip("native engine unavailable")
    pa = bs.parse_file_arrays(fixture_bytes)
    words_be = np.ascontiguousarray(pa.words_be[:8, :64])
    state = np.ascontiguousarray(pa.state[:, :64])
    out = np.asarray(decode_chains(state, words_u32(words_be)))
    assert np.array_equal(out, native.decode_chains(words_be, state))


def test_bswap32_matches_numpy_byteswap():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 2**32, size=1000, dtype=np.uint64).astype(np.uint32)
    assert np.array_equal(np.asarray(bswap32(jnp.asarray(x))), x.byteswap())


def test_device_decode_shapes():
    out = jax.eval_shape(
        decode_chains,
        jax.ShapeDtypeStruct((8, 300), jnp.int32),
        jax.ShapeDtypeStruct((7, 300, 2), jnp.uint32),
    )
    assert out.shape == (7, 20, 300) and out.dtype == jnp.int16


# ------------------------------------------------------------ encode kernel


def _window_body_once(x, lens, carry):
    """The encode kernel's window body as a plain JAX function."""
    B = carry.shape[1]
    xs = jnp.asarray(x, jnp.int32)
    new_carry, wh, wl = pe.window_body(
        lambda k: xs[k],
        jnp.asarray(lens),
        tuple(jnp.asarray(carry[i]) for i in range(8)),
        pe.candidate_constants(B),
    )
    return np.stack([np.asarray(c) for c in new_carry]), np.asarray(wh), np.asarray(wl)


@pytest.mark.parametrize("masked", [False, True])
def test_encode_window_body_matches_xla_kernel(masked):
    """Full and masked (random lengths 0..20) adversarial windows: the
    body's words and carry must equal the XLA kernel's."""
    rng = np.random.default_rng(7 if masked else 5)
    B = 32
    x = rng.integers(-32768, 32768, size=(1, 1, 20, B)).astype(np.int16)
    carry = rng.integers(-65536, 65536, size=(8, B)).astype(np.int32)
    lens = (
        rng.integers(0, 21, size=B) if masked else np.full(B, 20)
    ).astype(np.int32)
    # invalid samples are zero, as the host layout writes them
    x[0, 0] = np.where(np.arange(20)[:, None] < lens[None, :], x[0, 0], 0)
    new_carry, wh, wl = _window_body_once(x[0, 0], lens, carry)
    want_state, want_snaps, want_hi, want_lo = encode_frames(
        carry, x, lens.reshape(1, 1, B)
    )
    assert np.array_equal(np.asarray(want_snaps)[0], carry)
    assert np.array_equal(wh, np.asarray(want_hi)[0, 0])
    assert np.array_equal(wl, np.asarray(want_lo)[0, 0])
    assert np.array_equal(new_carry, np.asarray(want_state))


def test_encode_window_body_real_stream(fixture_bytes):
    """Real music windows from the fixture's first frame, one per chain."""
    out = codec.decode_all(fixture_bytes)
    x_all, _, _ = codec.layout_pcm(out.samples, 2, out.samples_per_channel)
    B = 32
    x = np.zeros((1, 1, 20, B), np.int16)
    for j in range(B):
        x[0, 0, :, j] = x_all[0, 3 * j, :, j % 2]
    lens = np.full(B, 20, np.int32)
    st = initial_encoder_state(2, B)
    new_carry, wh, wl = _window_body_once(x[0, 0], lens, st)
    want_state, _, want_hi, want_lo = encode_frames(st, x, lens.reshape(1, 1, B))
    assert np.array_equal(wh, np.asarray(want_hi)[0, 0])
    assert np.array_equal(wl, np.asarray(want_lo)[0, 0])
    assert np.array_equal(new_carry, np.asarray(want_state))


def test_encode_window_body_zero_length_passes_state_through():
    rng = np.random.default_rng(9)
    B = 16
    carry = rng.integers(-30000, 30000, size=(8, B)).astype(np.int32)
    new_carry, wh, wl = _window_body_once(
        np.zeros((20, B), np.int16), np.zeros(B, np.int32), carry
    )
    assert np.array_equal(new_carry, carry)
    assert not wl.any() and not (wh & np.uint32(0x0FFFFFFF)).any()


def test_encode_kernel_shapes_and_block_contract():
    F, W, N = 2, 256, 16
    out = jax.eval_shape(
        pe.encode_frames_pallas,
        jax.ShapeDtypeStruct((8, N), jnp.int32),
        jax.ShapeDtypeStruct((F, W, 20, N), jnp.int16),
        jax.ShapeDtypeStruct((F, W, N), jnp.int32),
    )
    want = jax.eval_shape(
        encode_frames,
        jax.ShapeDtypeStruct((8, N), jnp.int32),
        jax.ShapeDtypeStruct((F, W, 20, N), jnp.int16),
        jax.ShapeDtypeStruct((F, W, N), jnp.int32),
    )
    assert [(o.shape, o.dtype) for o in out] == [(w.shape, w.dtype) for w in want]
    with pytest.raises(AssertionError, match="multiple of 4"):
        jax.eval_shape(
            functools.partial(pe.encode_frames_pallas, block=4),
            jax.ShapeDtypeStruct((8, 6), jnp.int32),
            jax.ShapeDtypeStruct((F, W, 20, 6), jnp.int16),
            jax.ShapeDtypeStruct((F, W, 6), jnp.int32),
        )


def test_encode_kernel_lowers_for_cuda():
    low = jax.jit(pe.encode_frames_pallas).trace(
        jax.ShapeDtypeStruct((8, 64), jnp.int32),
        jax.ShapeDtypeStruct((2, 256, 20, 64), jnp.int16),
        jax.ShapeDtypeStruct((2, 256, 64), jnp.int32),
    ).lower(lowering_platforms=("cuda",))
    assert "qoa_encode" in low.as_text()


# ----------------------------------------------------------- kernel choice


@pytest.mark.parametrize("platform", ["gpu", "cpu", None])
def test_encode_kernel_by_platform(platform):
    encode, mult = encode_kernel(platform)
    if platform == "gpu":
        assert (encode, mult) == (pe.encode_frames_pallas, pe.BLOCK)
    else:
        assert (encode, mult) == (encode_frames, 1)


def _gpu_route_on_cpu(monkeypatch, calls):
    """Make the corpus layer take its GPU route on the CPU: the platform
    reads "gpu" and the encode kernel is stood in for by the XLA kernel
    (checking the chain padding)."""
    from qoaudio_tpu.parallel import corpus

    def encode(state, samples, lens):
        calls.append(samples.shape[-1])
        assert samples.shape[-1] % pe.BLOCK == 0
        return encode_frames(state, samples, lens)

    monkeypatch.setattr(corpus, "_jax_platform", lambda: "gpu")
    monkeypatch.setattr(pe, "encode_frames_pallas", encode)
    corpus._TRANSCODE_FUSED_CACHE.clear()


def _small_corpus():
    rng = np.random.default_rng(29)
    files = [
        (rng.integers(-28000, 28000, 5200 * 2).astype(np.int16), QoaDesc(2, 44100, 5200)),
        (rng.integers(-28000, 28000, 777).astype(np.int16), QoaDesc(1, 22050, 777)),
    ]
    return files, [codec.encode_all(p, d) for p, d in files]


def test_gpu_route_batch_decode_on_device(monkeypatch):
    """On a GPU, batch_decode runs the device decoder, not the host engine."""
    from qoaudio_tpu.parallel import batch_decode

    files, streams = _small_corpus()
    want = [codec.decode_all(s).samples for s in streams]
    _gpu_route_on_cpu(monkeypatch, [])

    def no_host(*a, **k):
        raise AssertionError("host engine used on the GPU route")

    monkeypatch.setattr(native, "decode_chains", no_host)
    for got, w in zip(batch_decode(streams), want):
        assert np.array_equal(got.samples, w)


def test_gpu_route_batch_encode_and_transcode(monkeypatch):
    from qoaudio_tpu.parallel import batch_encode, batch_transcode

    calls = []
    files, streams = _small_corpus()
    _gpu_route_on_cpu(monkeypatch, calls)
    n_enc = -(-3 // pe.BLOCK) * pe.BLOCK  # 2 + 1 channels, padded
    assert batch_encode(files) == streams
    assert calls and set(calls) == {n_enc}
    calls.clear()
    got = batch_transcode(streams, bucket=False)
    assert calls == [n_enc]
    for s, g in zip(streams, got):
        out = codec.decode_all(s)
        want = codec.encode_all(
            out.samples, QoaDesc(out.num_channels, out.sample_rate, out.samples_per_channel)
        )
        assert g == want


# ----------------------------------------------------- on the card (gpu)


@pytest.mark.gpu
def test_encode_kernel_matches_xla_on_gpu():
    rng = np.random.default_rng(3)
    F, N = 2, 64
    x = rng.integers(-32768, 32767, (F, 256, 20, N)).astype(np.int16)
    lens = np.full((F, 256, N), 20, np.int32)
    lens[-1, 200:] = 0  # padded windows
    lens[-1, 199] = 7  # short final slice
    x[-1, 199, 7:] = 0
    x[-1, 200:] = 0
    state = initial_encoder_state(0, N)
    got = pe.encode_frames_pallas(state, x, lens)
    want = encode_frames(state, x, lens)
    for a, b in zip(got, want):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.gpu
def test_device_decode_matches_native_on_gpu():
    if not native.available():
        pytest.skip("native engine unavailable")
    rng = np.random.default_rng(7)
    words_be = _random_words(rng, 256, 1024)
    state = rng.integers(-20000, 20000, (8, 1024)).astype(np.int32)
    got = np.asarray(decode_chains(state, words_u32(words_be)))
    assert np.array_equal(got, native.decode_chains(words_be, state))


@pytest.mark.gpu
def test_sharded_kernels_one_device_mesh_on_gpu():
    from qoaudio_tpu.parallel import batch_decode, batch_encode, batch_transcode
    from qoaudio_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(n_devices=1)
    files, streams = _small_corpus()
    assert batch_encode(files, mesh=mesh) == streams
    for got, s in zip(batch_decode(streams, mesh=mesh), streams):
        assert np.array_equal(got.samples, codec.decode_all(s).samples)
    assert batch_transcode(streams, mesh=mesh) == batch_transcode(streams)


@pytest.mark.gpu
def test_batch_transcode_device_resident_on_gpu():
    from qoaudio_tpu.parallel import batch_transcode

    files, streams = _small_corpus()
    got, handle = batch_transcode(streams, return_fused_handle=True)
    assert handle is not None
    for s, g in zip(streams, got):
        out = codec.decode_all(s)
        want = codec.encode_all(
            out.samples, QoaDesc(out.num_channels, out.sample_rate, out.samples_per_channel)
        )
        assert g == want
