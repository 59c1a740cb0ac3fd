"""Edge-path tests from the round-4 line-coverage sweep (experiments/
line_coverage.py): every test here pins a branch the suite previously
never executed — constructor cleanup, seek on exotic readers, prefetch
failure surfaces, zero-window truncated frames, fast-parser rejections,
native-loader recovery, and the CLI's format-boundary plumbing."""

import io
import os

import numpy as np
import pytest

from conftest import make_sine

from qoaudio_tpu import bitstream as bs
from qoaudio_tpu import codec, format as fmt, native
from qoaudio_tpu.errors import (
    IncompatibleFrame,
    InvalidFrameHeader,
    InvalidSamples,
    IoError,
    NoSamples,
    NotQoaFile,
)
from qoaudio_tpu.streaming import QoaDecoder, QoaEncoder
from qoaudio_tpu.types import FrameHeader, QoaDesc


def _ragged_stream(lens, channels=1, rate=44100):
    total = sum(lens)
    pcm = make_sine(total, channels)
    buf = io.BytesIO()
    buf.write(fmt.pack_file_header(total))
    enc = QoaEncoder(QoaDesc(channels, rate, total))
    pos = 0
    for ln in lens:
        enc.encode_frame(pcm[pos * channels : (pos + ln) * channels], buf)
        pos += ln
    return buf.getvalue()


# ---------------------------------------------------------------- streaming


def test_open_closes_file_when_ctor_raises(tmp_path):
    """QoaDecoder.open wraps construction: a non-QOA file raises the typed
    error AND closes the handle it opened (streaming.py open())."""
    p = tmp_path / "junk.bin"
    p.write_bytes(b"definitely not qoa" * 3)
    with pytest.raises(NotQoaFile):
        QoaDecoder.open(str(p))


class _ReadOnly:
    """A source with read() but no seek/tell (e.g. a socket wrapper)."""

    def __init__(self, data):
        self._b = io.BytesIO(data)

    def read(self, n=-1):
        return self._b.read(n)


class _NoTell(io.BytesIO):
    """Seekable but tell() fails (exotic wrappers); the failed-seek path
    must still raise typed instead of crashing on the position probe."""

    def tell(self):
        raise OSError("no tell")


def test_seek_requires_seekable_source():
    data = _ragged_stream([400, 400])
    dec = QoaDecoder(_ReadOnly(data))
    with pytest.raises(IoError, match="seekable"):
        dec.seek_to_frame(1)


def test_failed_seek_without_tell_is_still_typed():
    # a seekable-but-not-tellable reader is refused UP FRONT (ADVICE r04):
    # letting the seek proceed and then fail on mismatch would leave the
    # cursor moved with nowhere to restore it to, silently desyncing a
    # caller that catches the typed error and keeps reading
    data = _ragged_stream([400, 300, 500])
    dec = QoaDecoder(_NoTell(data))
    with pytest.raises(IoError, match="tellable"):
        dec.seek_to_frame(1)


def test_failed_seek_preserves_prefetched_error_batch(tmp_path):
    """A failed seek re-queues the in-flight prefetch batch INCLUDING its
    deferred error: the truncation diagnostic must survive the handoff
    (streaming.py seek_to_frame batch restore)."""
    data = _ragged_stream([400, 300, 500])
    # truncate inside frame 2's LMS: its batch carries a deferred IoError
    fsize0 = 8 + 16 + 8 * 20  # mono 400-sample frame
    fsize1 = 8 + 16 + 8 * 15  # mono 300-sample frame
    cut = 8 + fsize0 + fsize1 + 8 + 7
    p = tmp_path / "trunc.qoa"
    p.write_bytes(data[:cut])
    dec = QoaDecoder.open(str(p), prefetch=True, readahead=1)
    it = iter(dec)
    got = 0
    while got < 700:  # drain frames 0 and 1; frame 2's batch prefetches
        if not isinstance(next(it), FrameHeader):
            got += 1
    with pytest.raises(IoError, match="non-uniform"):
        dec.seek_to_frame(1)  # stride predicts 400 spc, actual frame is 300
    with pytest.raises(IoError, match="EOF"):
        dec.decode_pending()  # the prefetched batch's error was preserved
    assert next(iter(dec), None) is None  # and the decoder is dead


def test_streaming_partial_header_rewinds_and_resumes():
    """decode_frame with a split next-frame header: the <8 buffered bytes
    rewind (not consumed) and the frame completes on the next feed."""
    f1 = QoaEncoder(QoaDesc(1, 44100, 100)).encode_frame_bytes(make_sine(100, 1))
    f2 = QoaEncoder(QoaDesc(1, 44100, 60)).encode_frame_bytes(make_sine(60, 1))
    dec = QoaDecoder.new_streaming()
    a = dec.decode_frame(f1 + f2[:3])
    b = dec.decode_frame(f2[3:])
    assert len(a) == 100 and len(b) == 60
    one = QoaDecoder.new_streaming()
    whole = one.decode_frame(f1 + f2)
    assert np.array_equal(np.concatenate([a, b]), whole)


def test_truncation_after_lms_yields_zero_window_frame():
    """EOF right after a frame's LMS: the reference emits that frame's
    header and errors before any sample (src/lib.rs:291-330); the batched
    path must deliver the header with an EMPTY block, then the typed error
    (streaming.py _decode_records zero-window branch)."""
    data = _ragged_stream([400, 200])
    cut = 8 + (8 + 16 + 8 * 20) + 8 + 16  # header + frame0 + hdr1 + LMS1
    dec = QoaDecoder(data[:cut])
    got, headers = [], []
    with pytest.raises(IoError, match="EOF"):
        for item in dec:
            if isinstance(item, FrameHeader):
                headers.append(item)
            else:
                got.append(item)
    assert len(got) == 400  # every complete frame's samples first
    assert headers[-1].num_samples_per_channel == 200  # the truncated one


def test_slab_fast_path_guard_without_native(monkeypatch):
    data = _ragged_stream([400, 400, 400])
    want = codec.decode_all(data).samples
    monkeypatch.setattr(native, "available", lambda: False)
    dec = QoaDecoder(data)
    assert np.array_equal(dec.decode_pending(), want)


def test_inline_produce_failure_is_typed_and_fatal():
    """A raw fault outside _produce's own wrapping (inline, no prefetch)
    still flows through _raise_or_stop with the decoder dead."""
    dec = QoaDecoder(_ragged_stream([400, 400]))
    # force the generic _produce route: the bulk-drain fast path has its
    # own producer (slab-into) and correctly DEFERS a later _produce
    # fault after yielding its samples (covered by
    # test_bulk_drain_truncated_stream_defers_error)
    dec._bulk_drain = lambda: None

    def boom():
        raise RuntimeError("inline fault")

    dec._produce = boom
    with pytest.raises(RuntimeError, match="inline fault"):
        dec.decode_pending()
    assert next(iter(dec), None) is None


def test_take_prefetch_surfaces_worker_fault_on_seek(tmp_path):
    """seek_to_frame drains the in-flight prefetch via _take_prefetch; a
    worker that died raw must not crash the seek — the seek itself
    succeeds (uniform stream) and the fault surfaces on the next drain."""
    data = _ragged_stream([400, 400, 400, 400])
    p = tmp_path / "uni.qoa"
    p.write_bytes(data)
    dec = QoaDecoder.open(str(p), prefetch=True, readahead=1)
    it = iter(dec)
    got = 0
    while got < 400:  # batch 1 delivered; future 2 (original) in flight
        if not isinstance(next(it), FrameHeader):
            got += 1

    def boom():
        raise RuntimeError("worker died")

    dec._produce = boom
    while got < 800:  # takes future 2, submits future 3 = boom
        if not isinstance(next(it), FrameHeader):
            got += 1
    dec.seek_to_frame(0)  # drains the poisoned future without raising
    with pytest.raises(RuntimeError, match="worker died"):
        dec.decode_pending()


def test_decode_frame_requires_streaming_decoder():
    dec = QoaDecoder(_ragged_stream([400]))
    with pytest.raises(TypeError, match="new_streaming"):
        dec.decode_frame(b"")


def test_decode_pending_raises_typed_with_no_chunks():
    """An invalid frame header fed to a dry streaming decoder raises the
    typed error from decode_pending even though zero samples decoded."""
    dec = QoaDecoder.new_streaming()
    with pytest.raises(InvalidFrameHeader):
        dec.decode_frame(b"\x00" * 24)


def test_encode_frame_bytes_matches_buffer_form():
    pcm = make_sine(100, 2)
    desc = QoaDesc(2, 44100, 100)
    ea, eb = QoaEncoder(desc), QoaEncoder(desc)
    buf = io.BytesIO()
    ea.encode_frame(pcm, buf)
    assert eb.encode_frame_bytes(pcm) == buf.getvalue()


def test_encoder_one_shot_validates_size():
    enc = QoaEncoder(QoaDesc(1, 44100, 100))
    with pytest.raises(InvalidSamples):
        enc.encode([1, 2, 3])


# ------------------------------------------------------------------- codec


def test_decode_all_native_unavailable(monkeypatch):
    data = _ragged_stream([400])
    want = codec.decode_all(data).samples
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native engine unavailable"):
        codec.decode_all(data, backend="native")
    assert np.array_equal(codec.decode_all(data).samples, want)


def test_decode_range_native_unavailable(monkeypatch):
    data = _ragged_stream([400, 400])
    want = codec.decode_range(data, 100, 500).samples
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native engine unavailable"):
        codec.decode_range(data, 100, 500, backend="native")
    assert np.array_equal(codec.decode_range(data, 100, 500).samples, want)


def test_decode_all_header_only_raises_no_samples():
    with pytest.raises(NoSamples):
        codec.decode_all(fmt.pack_file_header(10), backend="jax")


def test_canon_chunk_caps_at_ladder_top():
    assert codec._canon_chunk(10_000) == codec._CHUNK_LADDER[-1]


# --------------------------------------------------------------- bitstream


def test_stack_frames_validates():
    with pytest.raises(ValueError, match="no frames"):
        bs.stack_frames([])
    mono = bs.parse_file(_ragged_stream([100], channels=1))
    stereo = bs.parse_file(_ragged_stream([100], channels=2))
    with pytest.raises(IncompatibleFrame):
        bs.stack_frames([mono.frames[0], stereo.frames[0]])


def test_fast_parser_rejects_padded_first_frame_size():
    """A first frame whose size field disagrees with its sample count's
    canonical geometry breaks the uniform-stride arithmetic: the O(1)
    parser must hand off (return None) instead of indexing wrong."""
    data = bytearray(_ragged_stream([400, 400]))
    word = int.from_bytes(data[8:16], "big")
    c, r, spc, fsz = fmt.unpack_frame_header(word)
    data[8:16] = fmt.pack_frame_header(c, r, spc, fsz + 8).to_bytes(8, "big")
    assert bs.parse_file_arrays(bytes(data)) is None


def test_fast_parser_rejects_tail_anomalies():
    uni = _ragged_stream([400, 400, 300])
    assert bs.parse_file_arrays(uni) is not None
    # truncated tail: hand off to the general walk for the typed report
    assert bs.parse_file_arrays(uni[:-5]) is None
    # tail with a different sample rate (format change)
    other = io.BytesIO()
    QoaEncoder(QoaDesc(1, 22050, 300)).encode_frame(make_sine(300, 1), other)
    spliced = _ragged_stream([400, 400])[: 8 + 2 * (8 + 16 + 160)]
    assert bs.parse_file_arrays(spliced + other.getvalue()) is None


# ------------------------------------------------------------------ native


def test_build_returns_none_without_source(monkeypatch):
    monkeypatch.setattr(native, "_SRC", "/nonexistent/kernels.cpp")
    assert native._build() is None


def test_library_key_follows_cpu_source_and_flags(monkeypatch, tmp_path):
    """The library's name is keyed on the CPU identity, the source and
    the flag tiers: a library built on another machine (or from another
    source) sits under another name and is rebuilt, never loaded."""
    src = tmp_path / "k.cpp"
    src.write_text("int x;\n")
    monkeypatch.setattr(native, "_SRC", str(src))
    monkeypatch.setattr(native, "_LIB_DIR", str(tmp_path))
    assert native.cpu_model() in native.cpu_identity()
    here = native._lib_path()
    assert os.path.dirname(here) == str(tmp_path)
    assert native._lib_path() == here  # stable
    monkeypatch.setattr(native, "cpu_identity", lambda: "Other CPU | avx2")
    other_cpu = native._lib_path()
    assert other_cpu != here
    monkeypatch.setattr(native, "_FLAG_TIERS", (("-O1",),))
    assert native._lib_path() != other_cpu
    src.write_text("int y;\n")
    assert native._lib_path() not in (here, other_cpu)


def test_load_marks_failed_when_build_fails(monkeypatch):
    monkeypatch.setattr(native, "_build", lambda force=False: None)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    assert native._load() is None
    assert native._build_failed is True


_STUB_SRC = """
extern "C" {
void qoa_gather_frames() {}
void qoa_decode_chains() {}
void qoa_interleave() {}
void qoa_decode_interleaved_stereo() {}
void qoa_decode_interleaved_mono() {}
void qoa_decode_interleaved_stereo_raw() {}
void qoa_decode_interleaved_mono_raw() {}
long qoa_has_fused_interleaved() { return 0; }
void qoa_encode_windows() {}
void qoa_encode_file() {}
long qoa_encode_fallbacks() { return 0; }
}
"""


def test_torn_library_rebuilds_and_recovers(monkeypatch, tmp_path):
    """A torn/garbage .so at the library's keyed path (interrupted copy or
    build): _build() trusts the existing file, CDLL fails with OSError,
    the loader rebuilds once from source and recovers.  All loader
    globals are patched, so the real engine is untouched."""
    src = tmp_path / "stub.cpp"
    src.write_text(_STUB_SRC)
    monkeypatch.setattr(native, "_SRC", str(src))
    monkeypatch.setattr(native, "_LIB_DIR", str(tmp_path))
    with open(native._lib_path(), "wb") as f:
        f.write(b"\x7fELF garbage, not a real object")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    lib = native._load()
    assert lib is not None  # rebuilt from source and bound
    assert native.available()


# ----------------------------------------------------------- parallel bits


def test_relayout_encode_input_matches_dense_reference():
    """The take-based relayout (one chain-major gather + majors-only
    transpose) must place every VALID (f < F_i) sample exactly where the
    dense per-file reshape would; invalid slots may hold anything (their
    lens are 0).  Mixed channel counts and frame counts, with both lane
    and frame padding."""
    import jax.numpy as jnp

    from qoaudio_tpu.parallel import corpus

    rng = np.random.default_rng(17)
    W_enc, F_pad, Nep = 3, 4, 8
    # (F_i, C, doff, eoff): 2 files -> Ne = 3 chains, Nd = 7 dec chains
    metas = ((2, 2, 0, 0), (3, 1, 4, 2))
    Ne, Nd = 3, 7
    decT = rng.integers(-32768, 32768, (Nd, W_enc, 20)).astype(np.int16)
    got = np.asarray(
        corpus._relayout_encode_input(
            jnp.asarray(decT), metas, W_enc, F_pad, Ne, Nep
        )
    )
    assert got.shape == (F_pad, W_enc, 20, Nep)
    for F_i, C, doff, eoff in metas:
        for f in range(F_i):
            for c in range(C):
                want = decT[doff + f * C + c]  # (W_enc, 20)
                assert np.array_equal(got[f, :, :, eoff + c], want), (
                    F_i, C, f, c,
                )


def test_stage_word_halves_matches_logical_words():
    """The one decode staging format: raw big-endian words staged per
    file, viewed as u32 halves and byte-swapped on the device, give the
    logical slice words; padding stays zero."""
    from qoaudio_tpu.ops.decode import word_halves, words_u32
    from qoaudio_tpu.parallel import corpus

    p = bs.parse_file_arrays(_ragged_stream([400, 400], channels=2))
    assert p is not None
    k = p.n_frames * p.channels
    Wp, Np = p.max_windows + 3, k + 5  # padded like a kernel block
    words_be, state = corpus._stage_words([p], [0], Wp, Np)
    raw = words_u32(words_be)
    assert raw.shape == (Wp, Np, 2) and np.shares_memory(raw, words_be)
    hi, lo = (np.asarray(a) for a in word_halves(raw[..., 0], raw[..., 1]))
    logical = p.words_be.view(np.uint64).byteswap()
    got = (hi[: p.max_windows, :k].astype(np.uint64) << np.uint64(32)) | lo[
        : p.max_windows, :k
    ].astype(np.uint64)
    assert np.array_equal(got, logical)
    assert np.array_equal(state[:, :k], p.state)
    assert not hi[:, k:].any() and not lo[p.max_windows :].any()


def test_batch_decode_numpy_ragged_trim(monkeypatch):
    """Without the native engine, the ragged interleave+trim falls to the
    pure-numpy transpose path — bit-exact vs the default engine."""
    from qoaudio_tpu.parallel import batch_decode

    data = _ragged_stream([400, 300, 500])
    want = codec.decode_all(data).samples
    monkeypatch.setattr(native, "available", lambda: False)
    (out,) = batch_decode([data])
    assert np.array_equal(out.samples, want)


def test_make_mesh_limits_device_count():
    from qoaudio_tpu.parallel import make_mesh

    mesh = make_mesh(n_devices=1)
    assert mesh.size == 1


def test_jax_platform_probe_degrades(monkeypatch):
    import jax

    from qoaudio_tpu.parallel import corpus

    def boom():
        raise RuntimeError("no backend")

    monkeypatch.setattr(jax, "devices", boom)
    assert corpus._jax_platform() is None


# --------------------------------------------------------------------- cli


def _one_sample_then_format_change(tmp_path):
    """Streaming-mode file whose FIRST segment is a single sample: the
    play command's format-known probe read crosses the boundary."""
    a = codec.encode_all(make_sine(1, 1), QoaDesc(1, 44100, 1))
    b = codec.encode_all(
        make_sine(100, 1, rate=22050), QoaDesc(1, 22050, 100)
    )
    p = tmp_path / "onesample.qoa"
    p.write_bytes(fmt.pack_file_header(0) + a[8:] + b[8:])
    return p


def test_cli_play_raw_one_sample_first_segment(tmp_path, capsysbinary):
    from qoaudio_tpu import cli

    p = _one_sample_then_format_change(tmp_path)
    assert cli.main(["play", str(p), "--sink", "raw"]) == 0
    raw = capsysbinary.readouterr().out
    assert len(raw) == (1 + 100) * 2  # both segments, held block included


def test_cli_play_audio_sink_pending_handoff(tmp_path, monkeypatch):
    """The audio sink consumes the already-read crossed block (pending)
    instead of re-reading: exactly one stream per format, every sample
    written once."""
    import sys as _sys
    import types as _types

    from qoaudio_tpu import cli

    opened, writes = [], []

    class FakeStream:
        def __init__(self, samplerate, channels, dtype):
            opened.append((channels, samplerate))
            writes.append(0)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def write(self, arr):
            writes[-1] += arr.size

    fake = _types.SimpleNamespace(
        OutputStream=FakeStream, check_output_settings=lambda **kw: None
    )
    monkeypatch.setitem(_sys.modules, "sounddevice", fake)
    p = _one_sample_then_format_change(tmp_path)
    assert cli.main(["play", str(p), "--sink", "audio"]) == 0
    assert opened == [(1, 44100), (1, 22050)]
    assert writes == [1, 100]


def test_cli_play_wav_multiread_segment_then_change(tmp_path, capsys):
    """A first format segment spanning several reads: the WAV sink appends
    every same-format block, then stops at the change with the notice."""
    from qoaudio_tpu import cli
    from qoaudio_tpu.utils.wav import read_wav

    a = codec.encode_all(make_sine(9000, 1), QoaDesc(1, 44100, 9000))
    b = codec.encode_all(
        make_sine(100, 1, rate=22050), QoaDesc(1, 22050, 100)
    )
    p = tmp_path / "long.qoa"
    p.write_bytes(fmt.pack_file_header(0) + a[8:] + b[8:])
    out_wav = tmp_path / "long.wav"
    assert cli.main(["play", str(p), "--output", str(out_wav)]) == 0
    assert "format change" in capsys.readouterr().err
    got, ch, rate = read_wav(out_wav)
    assert (ch, rate, len(got)) == (1, 44100, 9000)


def test_cli_transcode_hbm_ignores_backend_with_notice(tmp_path, capsys):
    from qoaudio_tpu import cli

    pcm = make_sine(3000, 1)
    src = tmp_path / "a.qoa"
    src.write_bytes(codec.encode_all(pcm, QoaDesc(1, 44100, 3000)))
    outdir = tmp_path / "out"
    rc = cli.main(
        ["--backend", "native", "transcode", str(src),
         "--out-dir", str(outdir), "--hbm"]
    )
    assert rc == 0
    assert "--backend is ignored" in capsys.readouterr().err
    dec = codec.decode_all(src.read_bytes())
    want = codec.encode_all(dec.samples, QoaDesc(1, 44100, 3000))
    assert (outdir / "a.qoa").read_bytes() == want


def _uniform_stream(chunk_lens, channels=2, rate=44100):
    """Encode a stream frame-by-frame with caller-chosen chunk lengths."""
    total = sum(chunk_lens)
    pcm = make_sine(total, channels)
    buf = io.BytesIO()
    enc = QoaEncoder(QoaDesc(channels, rate, total))
    enc.write_header(buf)
    pos = 0
    for ln in chunk_lens:
        enc.encode_frame(pcm[pos * channels : (pos + ln) * channels], buf)
        pos += ln
    return buf.getvalue()


def test_batch_decode_no_mesh_native_and_xla_kernels(monkeypatch):
    """The no-mesh batched corpus decode on CPU: the native chain engine
    when present, the XLA kernel when not — both bit-exact per file, for
    standard frames AND a uniform non-window-aligned geometry (interior
    spc % 20 != 0), which forces the per-frame interleave+trim."""
    from qoaudio_tpu.parallel import batch_decode

    streams = [
        _uniform_stream([5120, 5120, 700], channels=2),
        _uniform_stream([2570, 2570, 100], channels=1),  # 2570 % 20 != 0
    ]
    want = [codec.decode_all(d).samples for d in streams]
    outs = batch_decode(streams)
    for o, w in zip(outs, want):
        assert np.array_equal(o.samples, w)
    monkeypatch.setattr(native, "available", lambda: False)
    outs = batch_decode(streams)
    for o, w in zip(outs, want):
        assert np.array_equal(o.samples, w)


def test_stream_slab_decode_three_channels():
    """C=3 streams slab-parse into the chain-array kernels (the fused
    raw-bytes decode is mono/stereo only): the dense word/LMS gather and
    the decode_chains + interleave_trim path must match decode_all."""
    data = _uniform_stream([5120] * 3 + [640], channels=3)
    want = codec.decode_all(data).samples
    out = QoaDecoder(data).decode_pending()
    assert np.array_equal(out, want)


def test_bulk_drain_overflow_stays_lossless():
    """A hostile-but-decodable stream whose FIRST frame understates the
    per-frame sample count (tiny frame 0, full frames after) makes the
    bulk drain's capacity estimate undershoot; the overflow list must
    keep the drain lossless and byte-exact vs decode_all."""
    data = _uniform_stream([20, 5120, 5120], channels=2)
    want = codec.decode_all(data).samples
    dec = QoaDecoder(data, backend="native")
    out = dec.decode_pending()
    assert np.array_equal(out, want)


def test_bulk_drain_raises_when_nothing_decodable():
    """EOF inside frame 2's LMS: the first bulk drain returns frame 1's
    samples with the error deferred; the SECOND drain has zero decodable
    samples, so the deferred error must surface instead of returning an
    empty array (truncation fidelity, reference src/lib.rs:271-281)."""
    data = _uniform_stream([5120, 5120], channels=2)
    f1_size = fmt.qoa_frame_size(2, fmt.QOA_SLICES_PER_FRAME)
    cut = data[: 8 + f1_size + 8 + 10]  # header + frame 1 + hdr2 + mid-LMS
    want = codec.decode_all(_uniform_stream([5120], channels=2)).samples
    dec = QoaDecoder(cut, backend="native")
    first = dec.decode_pending()
    assert np.array_equal(first, want)
    with pytest.raises(IoError):
        dec.decode_pending()


def test_decode_pending_after_partial_iteration_numpy_backend():
    """A partially-drained iterator leaves a mid-frame _pending remainder;
    decode_pending on the non-bulk path (numpy backend) must resume at
    the exact sample boundary."""
    data = _uniform_stream([5120, 700], channels=2)
    want = codec.decode_all(data).samples
    dec = QoaDecoder(data, backend="numpy")
    it = iter(dec)
    assert isinstance(next(it), FrameHeader)
    got_head = [next(it) for _ in range(5)]
    assert got_head == [int(v) for v in want[:5]]
    rest = dec.decode_pending()
    assert np.array_equal(rest, want[5:])
