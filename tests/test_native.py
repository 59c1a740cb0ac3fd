"""Native host-engine tests: bit-exactness, goldens, and API integration.

The native engine (qoaudio_tpu/native/) is the host/IO path of the
framework; its encoder must produce byte-identical streams to the scalar
oracle (and therefore to the JAX device kernel, which is separately pinned
to the oracle in test_jax_encode.py).
"""

import hashlib
import io

import numpy as np
import pytest

from qoaudio_tpu import QoaDecoder, QoaDesc, QoaEncoder, codec, native
from qoaudio_tpu import format as fmt
from qoaudio_tpu import reference as ref

from conftest import make_noise, make_sine

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native engine unavailable (no g++?)"
)

# SHA-256 of the REAL reference fixture and of encode_all(decode_all(it)) —
# the re-encode hash is frozen after cross-checking byte equality between
# the native engine, the JAX device kernel, and the scalar oracle (on
# prefixes).  Guards encoder bit-exactness against regressions without
# re-running the oracle (VERDICT round 1, item 9).
REAL_FIXTURE_SHA256 = (
    "b8d822ffee42abe052dfaab00136e86c3c1e9eb6e86cd700867b61a9f45a3372"
)
FIXTURE_REENCODE_SHA256 = (
    "e9f87726aef5d602e248dc839ac7de5c570ad869419984f00274cde76f28c19e"
)


def test_native_encode_matches_oracle_various():
    rng = np.random.default_rng(11)
    cases = [
        (make_sine(2100, 1), 1, 44100, 2100),
        (make_noise(6000, 2, seed=1), 2, 44100, 6000),
        (make_noise(70, 1, seed=2), 1, 44100, 70),
        (make_noise(130, 8, seed=3), 8, 44100, 130),
        (make_noise(97, 3, seed=4), 3, 44100, 97),
        (np.zeros(500, np.int16), 1, 44100, 500),
        (np.array([12345], np.int16), 1, 44100, 1),
        (
            np.tile(np.array([32767] * 10 + [-32768] * 10, np.int16), 50),
            1,
            44100,
            1000,
        ),
        (rng.integers(-32768, 32767, 5130 * 2).astype(np.int16), 2, 48000, 5130),
    ]
    for pcm, c, r, s in cases:
        want = ref.encode_all_py(pcm, c, r, s)
        got = codec.encode_all(pcm, QoaDesc(c, r, s), backend="native")
        assert got == want, f"native encode != oracle (C={c}, T={s})"


def test_native_encode_straggler_heavy_windows_match_oracle():
    """Hard signals drive many discarded candidates back over the winner
    bound; windows with >2 qualifying stragglers resolve on the fast
    full-16 vector path (fast16_window_channel) instead of scalar walks.
    Pin that the branch FIRES (the fallback counter moves) and its bytes
    equal the oracle, for both the pairwise (stereo) and mono16 entries."""
    lib = native._load()
    rng = np.random.default_rng(23)
    n = 4000
    t = np.arange(n)
    noisy = (9000 * np.sin(2 * np.pi * 220 * t / 44100)
             + rng.normal(0, 900, n))
    cases = [
        (np.stack([noisy, rng.normal(0, 5000, n)], axis=1)
         .astype(np.int16).reshape(-1), 2),
        (rng.integers(-32768, 32768, n).astype(np.int16), 1),
        (rng.integers(-32768, 32768, 3 * n).astype(np.int16), 3),
    ]
    for pcm, c in cases:
        f0 = lib.qoa_encode_fallbacks()
        got = codec.encode_all(pcm, QoaDesc(c, 44100, n), backend="native")
        assert lib.qoa_encode_fallbacks() > f0, f"resolver never fired (C={c})"
        assert got == ref.encode_all_py(pcm, c, 44100, n), f"C={c}"


def test_native_decode_matches_oracle(fixture_bytes):
    out = codec.decode_all(fixture_bytes, backend="native")
    _, _, want = ref.decode_all_np(fixture_bytes)
    assert np.array_equal(out.samples, want)
    assert out.num_channels == 2 and out.sample_rate == 44100


def test_fixture_reencode_golden(fixture_bytes):
    if hashlib.sha256(fixture_bytes).hexdigest() != REAL_FIXTURE_SHA256:
        pytest.skip("synthesized stand-in fixture; golden pins the real one")
    out = codec.decode_all(fixture_bytes, backend="native")
    desc = QoaDesc(out.num_channels, out.sample_rate, out.samples_per_channel)
    enc = codec.encode_all(out.samples, desc, backend="native")
    assert hashlib.sha256(enc).hexdigest() == FIXTURE_REENCODE_SHA256


def test_streaming_encoder_native_equals_oneshot():
    pcm = make_noise(12000, 2, seed=9, amplitude=30000)
    desc = QoaDesc(2, 44100, 12000)
    oneshot = codec.encode_all(pcm, desc, backend="native")
    enc = QoaEncoder(desc, backend="native")
    out = io.BytesIO()
    enc.write_header(out)
    for off in range(0, 12000, fmt.QOA_FRAME_LEN):
        n = min(12000 - off, fmt.QOA_FRAME_LEN)
        enc.encode_frame(pcm[off * 2 : (off + n) * 2], out)
    assert out.getvalue() == oneshot


def test_streaming_decoder_native_matches_decode_all(fixture_bytes):
    dec = QoaDecoder(fixture_bytes, backend="native", readahead=64)
    total = 0
    chunks = []
    while True:
        nxt = dec.next_frame()
        if nxt is None:
            break
        _, block = nxt
        chunks.append(block)
        total += len(block)
    got = np.concatenate(chunks)
    want = codec.decode_all(fixture_bytes, backend="native").samples
    assert np.array_equal(got, want)


def test_native_auto_backend_is_default():
    # backend="auto" must route to the native engine when available
    pcm = make_sine(100, 1)
    a = codec.encode_all(pcm, QoaDesc(1, 44100, 100))  # auto
    b = codec.encode_all(pcm, QoaDesc(1, 44100, 100), backend="native")
    assert a == b


def test_non_uniform_stream_falls_back(fixture_bytes):
    # a streaming-mode byte stream (total_samples == 0) can't use the fast
    # arithmetic parse; decode_all must still produce exact samples
    pcm = make_noise(7000, 2, seed=12)
    desc = QoaDesc(2, 44100, 7000)
    data = codec.encode_all(pcm, desc, backend="native")
    # rewrite the header to claim streaming mode
    stream = fmt.pack_file_header(0) + data[8:]
    out = codec.decode_all(stream, backend="native")
    _, _, want = ref.decode_all_np(stream)
    assert np.array_equal(out.samples, want)


def test_midstream_format_change_raises_incompatible():
    # a fixed-mode stream whose second frame changes channels must raise
    # IncompatibleFrame on every backend (reference src/lib.rs:246-259,
    # 735-739); the native fast parser must fall back, not misparse
    from qoaudio_tpu.errors import IncompatibleFrame

    d1 = codec.encode_all(np.zeros(100, np.int16), QoaDesc(1, 44100, 100))
    d2 = codec.encode_all(np.zeros(200, np.int16), QoaDesc(2, 44100, 100))
    franken = fmt.pack_file_header(200) + d1[8:] + d2[8:]
    for be in ("native", "numpy"):
        with pytest.raises(IncompatibleFrame):
            codec.decode_all(franken, backend=be)


def test_header_total_vs_actual_frames():
    # the header's total_samples is advisory (the reference only uses it to
    # reserve); decoding is driven by the frames actually present
    pcm = make_noise(777, 1, seed=31)
    data = codec.encode_all(pcm, QoaDesc(1, 44100, 777))
    lying = fmt.pack_file_header(999999) + data[8:]
    out = codec.decode_all(lying, backend="native")
    assert len(out.samples) == 777


def test_build_degrades_gracefully_without_toolchain(monkeypatch):
    """No compiler (or a hung one) must mean _build -> None with no torn
    temp files left behind — available() then reports False instead of
    raising (the numpy/jax paths take over)."""
    import glob
    import subprocess as sp

    from qoaudio_tpu import native as nat

    def no_gxx(cmd, **kw):
        raise OSError("g++ not found")

    monkeypatch.setattr(nat.subprocess, "run", no_gxx)
    assert nat._build(force=True) is None
    assert not glob.glob(nat._lib_path() + ".*.tmp")

    def hung(cmd, **kw):
        raise sp.TimeoutExpired(cmd, 1)

    monkeypatch.setattr(nat.subprocess, "run", hung)
    assert nat._build(force=True) is None
    assert not glob.glob(nat._lib_path() + ".*.tmp")

    def bad_compile(cmd, **kw):
        class R:
            returncode = 1
            stderr = b"boom"
        return R()

    monkeypatch.setattr(nat.subprocess, "run", bad_compile)
    assert nat._build(force=True) is None
    assert not glob.glob(nat._lib_path() + ".*.tmp")


def test_stale_library_without_symbols_degrades(monkeypatch, tmp_path):
    """A library missing the current symbols (a source that no longer
    matches the bindings) must force one rebuild and then degrade to
    available() == False — never raise out of the loader.  All loader
    globals are monkeypatched, so the real engine is untouched."""
    from qoaudio_tpu import native as nat

    src = tmp_path / "dummy.cpp"
    src.write_text('extern "C" int qoa_nothing(void) { return 0; }\n')
    monkeypatch.setattr(nat, "_SRC", str(src))
    monkeypatch.setattr(nat, "_LIB_DIR", str(tmp_path))
    monkeypatch.setattr(nat, "_lib", None)
    monkeypatch.setattr(nat, "_build_failed", False)
    assert nat._load() is None  # builds, binds fail, rebuilds, gives up
    assert nat._build_failed is True
    assert nat.available() is False  # and the verdict is cached


def test_fused_decode_dispatch_boundary_matches_oracle():
    """Adversarial random-word streams with chain counts straddling the
    fused AVX-512 decode kernel's 32-chain dispatch boundary (narrow
    plane-path groups, exactly one block, ragged 1/8/31-column tails,
    multiple blocks) must reproduce the scalar oracle bit-for-bit,
    including weight-wrap regimes (reference wrapping decode,
    src/lib.rs:291-330)."""
    from qoaudio_tpu import bitstream as bs

    rng = np.random.default_rng(23)
    spc = 120  # 6 windows/frame keeps the oracle cheap
    nw = spc // 20
    # (frames, channels): N = F*C = 31, 32, 33, 34, 40, 45, 64, 96
    for F, C in [(31, 1), (32, 1), (33, 1), (17, 2), (20, 2), (45, 1),
                 (16, 4), (48, 2)]:
        frames = []
        for _ in range(F):
            words = rng.integers(
                0, 1 << 63, size=(nw, C), dtype=np.int64
            ).astype(np.uint64) | (
                rng.integers(0, 16, size=(nw, C), dtype=np.uint64)
                << np.uint64(60)
            )
            hist = rng.integers(-32768, 32768, (C, 4)).astype(np.int32)
            wts = rng.choice(
                np.array([-32768, -16384, 16383, 32767], np.int32),
                size=(C, 4),
            )
            frames.append(
                bs.build_frame_bytes(C, 44100, spc, hist, wts, words)
            )
        data = fmt.pack_file_header(spc * F) + b"".join(frames)
        _, _, want = ref.decode_all_py(data)
        out = codec.decode_all(data, backend="native")
        assert np.array_equal(
            out.samples, np.asarray(want, np.int16)
        ), (F, C)


def test_decode_raw_stereo_matches_oracle_various():
    """The raw-bytes fused stereo decode (words + LMS read straight from
    the file buffer — the decode_all fast path) must reproduce the scalar
    oracle bit-for-bit on adversarial random-word/wrap-state streams with
    full-frame counts straddling its 16-frame block boundary, with and
    without a short tail frame, including the gathered remainder path."""
    from qoaudio_tpu import bitstream as bs

    rng = np.random.default_rng(31)
    spc = 100  # 5 windows/frame, window-aligned (raw-path eligible)

    def build(F_full, tail_spc):
        frames = []
        specs = [spc] * F_full + ([tail_spc] if tail_spc else [])
        for s in specs:
            nw = -(-s // 20)
            words = rng.integers(
                0, 1 << 63, size=(nw, 2), dtype=np.int64
            ).astype(np.uint64) | (
                rng.integers(0, 16, size=(nw, 2), dtype=np.uint64)
                << np.uint64(60)
            )
            hist = rng.integers(-32768, 32768, (2, 4)).astype(np.int32)
            wts = rng.choice(
                np.array([-32768, -16384, 16383, 32767], np.int32),
                size=(2, 4),
            )
            frames.append(bs.build_frame_bytes(2, 44100, s, hist, wts, words))
        total = spc * F_full + tail_spc
        return fmt.pack_file_header(total) + b"".join(frames)

    for F_full, tail_spc in [
        (1, 0), (15, 0), (16, 0), (17, 0), (32, 37), (16, 80), (3, 20),
        # tail_spc=99 packs to the SAME byte size as the full frames (5
        # windows), which the uniform probe must reject to the general
        # walk — decode stays correct through the fallback
        (16, 99),
    ]:
        data = build(F_full, tail_spc)
        geo = bs.parse_file_geometry(data)
        if tail_spc == 99:
            assert geo is None
        else:
            assert geo is not None and geo.F_full == F_full
            assert (geo.tail is not None) == bool(tail_spc)
        _, _, want = ref.decode_all_py(data)
        out = codec.decode_all(data, backend="native")
        assert np.array_equal(
            out.samples, np.asarray(want, np.int16)
        ), (F_full, tail_spc)


def test_decode_raw_mono_matches_oracle_various():
    """The raw-bytes fused MONO decode (two windows per 128-bit load
    round, paired-window permute split) must reproduce the scalar oracle
    bit-for-bit across its dispatch boundaries: the 32-frame block edge,
    the gathered remainder, odd vs even window counts (the odd tail
    window re-uses the last pair's odd half), the W==1 gather-only route,
    and short tail frames."""
    from qoaudio_tpu import bitstream as bs

    rng = np.random.default_rng(47)

    def build(spc, F_full, tail_spc):
        frames = []
        specs = [spc] * F_full + ([tail_spc] if tail_spc else [])
        for s in specs:
            nw = -(-s // 20)
            words = rng.integers(
                0, 1 << 63, size=(nw, 1), dtype=np.int64
            ).astype(np.uint64) | (
                rng.integers(0, 16, size=(nw, 1), dtype=np.uint64)
                << np.uint64(60)
            )
            hist = rng.integers(-32768, 32768, (1, 4)).astype(np.int32)
            wts = rng.choice(
                np.array([-32768, -16384, 16383, 32767], np.int32),
                size=(1, 4),
            )
            frames.append(bs.build_frame_bytes(1, 44100, s, hist, wts, words))
        total = spc * F_full + tail_spc
        return fmt.pack_file_header(total) + b"".join(frames)

    for spc, F_full, tail_spc in [
        (100, 1, 0),      # gather remainder only
        (100, 31, 0), (100, 32, 0), (100, 33, 37),  # block edge +- 1
        (100, 65, 80),    # two blocks + remainder + tail
        (60, 32, 0),      # odd W (3): the re-loaded final pair path
        (20, 34, 0),      # W == 1: whole range through the gather route
        (40, 32, 0),      # even minimal W for the paired loop
    ]:
        data = build(spc, F_full, tail_spc)
        geo = bs.parse_file_geometry(data)
        assert geo is not None and geo.F_full == F_full, (spc, F_full)
        _, _, want = ref.decode_all_py(data)
        out = codec.decode_all(data, backend="native")
        assert out.num_channels == 1
        assert np.array_equal(
            out.samples, np.asarray(want, np.int16)
        ), (spc, F_full, tail_spc)


def test_decode_range_raw_path_matches_full_decode():
    """decode_range's raw fast path (geometry probe + byte-offset raw
    kernel, O(range)) must agree with the full decode on ranges covering
    block boundaries, the short tail only, and clamped overshoot."""
    n = 5120 * 3 + 777  # three full frames + short tail
    pcm = make_noise(n, channels=2)
    data = codec.encode_all(
        pcm.reshape(-1), QoaDesc(channels=2, sample_rate=44100, samples=n)
    )
    x = codec.decode_all(data).samples.reshape(-1, 2)
    for s, e in [
        (0, n), (0, 7), (5120 - 3, 5120 + 3), (5120 * 3 + 5, n), (n - 1, n),
        (5119, 5121), (100, 100), (n, n + 50), (0, 10**9),
    ]:
        out = codec.decode_range(data, s, e)
        lo, hi = min(s, n), min(e, n)
        assert np.array_equal(out.samples, x[lo:hi].reshape(-1)), (s, e)


def test_decode_raw_stereo_out_contract():
    """decode_interleaved_stereo_raw validates the out= buffer shape and
    the frame range against the data buffer."""
    if not native.has_fused_interleaved():
        pytest.skip("fused kernel tier unavailable")
    from qoaudio_tpu import bitstream as bs

    n = 5120 * 2  # two full frames
    pcm = make_noise(n, channels=2)
    data = codec.encode_all(
        pcm.reshape(-1), QoaDesc(channels=2, sample_rate=44100, samples=n)
    )
    geo = bs.parse_file_geometry(data)
    assert geo is not None
    with pytest.raises(ValueError):
        native.decode_interleaved_stereo_raw(
            data, fmt.QOA_HEADER_SIZE, geo.F_full, geo.frame_bytes, geo.W0,
            out=np.empty((3, 2), np.int16),
        )
    with pytest.raises(ValueError):
        # range past the end of the buffer
        native.decode_interleaved_stereo_raw(
            data, fmt.QOA_HEADER_SIZE, geo.F_full + 1, geo.frame_bytes,
            geo.W0,
        )


def test_decode_beyond_encoder_channel_cap_matches_oracle():
    """The reference DECODER accepts any channel count 1-255 even though
    its encoder caps at 8 (src/lib.rs:227 vs src/lib.rs:336): it only
    rejects num_channels == 0.  Streams with C > 8 must decode here too,
    bit-exact with the oracle, on every backend and the streaming path."""
    from qoaudio_tpu import bitstream as bs
    from qoaudio_tpu.streaming import QoaDecoder

    rng = np.random.default_rng(9)
    C = 12
    frames = []
    for spc in (100, 100, 60):
        nw = -(-spc // 20)
        words = rng.integers(
            0, 1 << 63, size=(nw, C), dtype=np.int64
        ).astype(np.uint64) | (
            rng.integers(0, 16, size=(nw, C), dtype=np.uint64)
            << np.uint64(60)
        )
        hist = rng.integers(-32768, 32768, (C, 4)).astype(np.int32)
        wts = rng.integers(-1000, 1000, (C, 4)).astype(np.int32)
        frames.append(bs.build_frame_bytes(C, 44100, spc, hist, wts, words))
    data = fmt.pack_file_header(260) + b"".join(frames)

    want_c, _, want = ref.decode_all_py(data)
    assert want_c == C
    want = np.asarray(want, np.int16)
    for backend in ("native", "numpy"):
        out = codec.decode_all(data, backend=backend)
        assert out.num_channels == C
        assert np.array_equal(out.samples, want), backend
    assert np.array_equal(QoaDecoder(data).decode_pending(), want)


def test_decode_raw_mono_out_contract():
    """decode_interleaved_mono_raw validates the out= buffer shape and
    the frame range against the data buffer."""
    if not native.has_fused_interleaved():
        pytest.skip("fused kernel tier unavailable")
    from qoaudio_tpu import bitstream as bs

    n = 5120 * 2
    pcm = make_noise(n, channels=1)
    data = codec.encode_all(
        pcm.reshape(-1), QoaDesc(channels=1, sample_rate=44100, samples=n)
    )
    geo = bs.parse_file_geometry(data)
    assert geo is not None
    with pytest.raises(ValueError):
        native.decode_interleaved_mono_raw(
            data, fmt.QOA_HEADER_SIZE, geo.F_full, geo.frame_bytes, geo.W0,
            out=np.empty((3, 1), np.int16),
        )
    with pytest.raises(ValueError):
        native.decode_interleaved_mono_raw(
            data, fmt.QOA_HEADER_SIZE, geo.F_full + 1, geo.frame_bytes,
            geo.W0,
        )
    with pytest.raises(ValueError):
        native.decode_interleaved_raw(
            data, fmt.QOA_HEADER_SIZE, geo.F_full, geo.frame_bytes, geo.W0, 3
        )


def test_decode_interleaved_array_out_contracts():
    """The array-form fused kernels validate out= shape/dtype/contiguity
    and reject unsupported channel counts."""
    if not native.has_fused_interleaved():
        pytest.skip("fused kernel tier unavailable")
    rng = np.random.default_rng(3)
    W, N = 2, 4
    words = rng.integers(0, 1 << 63, size=(W, N), dtype=np.int64).astype(
        np.uint64
    )
    st = rng.integers(-100, 100, size=(8, N)).astype(np.int32)
    with pytest.raises(ValueError):
        native.decode_interleaved(words, st, 3)
    with pytest.raises(ValueError):
        native.decode_interleaved(
            words[:, :1], st[:, :1], 1, out=np.empty((3, 1), np.int16)
        )
    with pytest.raises(ValueError):
        native.decode_interleaved(
            words, st, 2, out=np.empty((5, 2), np.int16)
        )
    # valid out= buffers round-trip through both channel forms
    out1 = np.empty((1 * W * 20, 1), np.int16)
    got1 = native.decode_interleaved(words[:, :1], st[:, :1], 1, out=out1)
    assert got1 is out1
    out2 = np.empty(((N // 2) * W * 20, 2), np.int16)
    got2 = native.decode_interleaved(words, st, 2, out=out2)
    assert got2 is out2


def test_decode_interleaved_stereo_equals_pair():
    """The fused decode->interleaved kernel must reproduce the
    decode_chains + interleave_trim pair bit-for-bit on adversarial
    random-word/random-state chains: the composed fallback (N < 32),
    exact blocks, ragged 32-chain tails, and single-frame streams."""
    if not native.available():
        pytest.skip("native engine unavailable")
    rng = np.random.default_rng(7)
    for W, F in [(1, 1), (7, 3), (2, 8), (5, 16), (9, 17), (3, 33), (40, 50)]:
        N = 2 * F
        words = rng.integers(0, 1 << 63, size=(W, N), dtype=np.int64).astype(
            np.uint64
        )
        st = rng.integers(-32768, 32768, size=(8, N)).astype(np.int32)
        want = native.interleave_trim(
            native.decode_chains(words, st), F, 2, F * W * 20
        )
        got = native.decode_interleaved_stereo(words, st)
        assert got.shape == (F * W * 20, 2)
        assert np.array_equal(got, want), (W, F)


def test_decode_interleaved_mono_equals_pair():
    """The mono fused kernel (vpermi2w frame-pair de-interleave + masked
    stores) must reproduce the pair bit-for-bit across the composed
    fallback, exact blocks, and ragged tails."""
    if not native.available():
        pytest.skip("native engine unavailable")
    rng = np.random.default_rng(13)
    for W, N in [(1, 1), (7, 5), (2, 16), (5, 32), (9, 33), (3, 65), (40, 100)]:
        words = rng.integers(0, 1 << 63, size=(W, N), dtype=np.int64).astype(
            np.uint64
        )
        st = rng.integers(-32768, 32768, size=(8, N)).astype(np.int32)
        want = native.interleave_trim(
            native.decode_chains(words, st), N, 1, N * W * 20
        )
        got = native.decode_interleaved(words, st, 1)
        assert got.shape == (N * W * 20, 1)
        assert np.array_equal(got, want), (W, N)


def test_allocator_tuning_applied_and_optout():
    """Loading the native engine tunes the allocator once (process-global
    mallopt); QOA_NO_MALLOPT=1 skips it while the engine still works."""
    import os
    import subprocess
    import sys

    # this suite has already loaded the engine without the opt-out
    assert native._allocator_tuned is True

    env = dict(os.environ, QOA_NO_MALLOPT="1")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [
            sys.executable,
            "-c",
            "from qoaudio_tpu import native; assert native.available(); "
            "assert native._allocator_tuned is False; "
            "import numpy as np; "
            "w = np.zeros((3, 40), np.uint64); "
            "s = np.zeros((8, 40), np.int32); "
            "assert native.decode_chains(w, s).shape == (3, 20, 40)",
        ],
        env=env,
        cwd=repo,
        capture_output=True,
        timeout=120,
    )
    assert r.returncode == 0, r.stderr.decode()
