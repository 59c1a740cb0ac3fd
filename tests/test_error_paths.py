"""Failure-path behaviors that the happy-path suites never reach.

Pins reference semantics on mid-stream format changes in fixed mode
(/root/reference/src/lib.rs:246-259, :735-739), the typed delivery of
engine failures through the streaming iterator (never a raw exception
out of __next__ with the reader left mid-frame), backend-unavailable
errors, and the numpy fallback of the fast whole-file parser.
"""

import io

import numpy as np
import pytest

from conftest import make_sine

from qoaudio_tpu import bitstream as bs
from qoaudio_tpu import codec, format as fmt, native
from qoaudio_tpu.errors import IncompatibleFrame
from qoaudio_tpu.streaming import QoaDecoder
from qoaudio_tpu.types import FixedSamples, FrameHeader, QoaDesc, Streaming


def _spliced_stream(second_desc: QoaDesc) -> bytes:
    """A fixed-mode stream whose second frame changes format."""
    a = codec.encode_all(make_sine(40, 1), QoaDesc(1, 44100, 40))
    b = codec.encode_all(
        make_sine(40, second_desc.channels), second_desc
    )
    return fmt.pack_file_header(80) + a[8:] + b[8:]


@pytest.mark.parametrize(
    "second",
    [QoaDesc(2, 44100, 40), QoaDesc(1, 22050, 40)],
    ids=["channel-change", "rate-change"],
)
def test_fixed_mode_format_change_raises_incompatible(second):
    """Fixed mode pins channels/rate; a change is IncompatibleFrame
    (src/lib.rs:246-259), after the first frame's samples drained."""
    data = _spliced_stream(second)
    dec = QoaDecoder(data)
    got = []
    with pytest.raises(IncompatibleFrame):
        for item in dec:
            if not isinstance(item, FrameHeader):
                got.append(item)
    assert len(got) == 40  # the first (valid) frame decoded fully
    # the decoder is dead afterwards: iteration terminates cleanly
    assert next(iter(dec), None) is None


@pytest.mark.parametrize("backend", ["native", "jax", "numpy"])
def test_decode_all_format_change_raises_incompatible(backend):
    """decode_all rejects channel/rate changes (src/lib.rs:735-739)."""
    if backend == "native" and not native.available():
        pytest.skip("no native engine")
    data = _spliced_stream(QoaDesc(2, 44100, 40))
    with pytest.raises(IncompatibleFrame):
        codec.decode_all(data, backend=backend)


def _multi_frame_stream(n_frames=12, frame_len=2570):
    """Uniform fixed-mode stream that the slab fast path rejects
    (spc % 20 != 0), so decoding runs the per-frame reader."""
    import struct

    spc_total = n_frames * frame_len
    pcm = make_sine(spc_total, 1)
    out = [fmt.pack_file_header(spc_total)]
    from qoaudio_tpu.streaming import QoaEncoder

    enc = QoaEncoder(QoaDesc(1, 44100, spc_total))
    buf = io.BytesIO()
    for i in range(n_frames):
        enc.encode_frame(pcm[i * frame_len : (i + 1) * frame_len], buf)
    return out[0] + buf.getvalue()


def test_decode_stage_failure_is_deferred_typed_error(monkeypatch):
    """An engine failure inside the decode stage yields the samples decoded
    so far, then raises ONCE with the decoder dead — never a raw
    propagation that leaves the reader mid-frame for a retry."""
    data = _multi_frame_stream(n_frames=6, frame_len=410)
    orig = QoaDecoder._decode_records
    calls = {"n": 0}

    def boom(self, group):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise RuntimeError("injected engine fault")
        return orig(self, group)

    monkeypatch.setattr(QoaDecoder, "_decode_records", boom)
    # numpy backend: the native slab fast path bypasses _decode_records
    dec = QoaDecoder(data, readahead=2, backend="numpy")
    got = []
    with pytest.raises(RuntimeError, match="injected engine fault"):
        for item in dec:
            if not isinstance(item, FrameHeader):
                got.append(item)
    assert got  # the first batch's samples were delivered
    assert next(iter(dec), None) is None  # dead, no retry from a torn state


def test_prefetch_worker_failure_is_deferred_typed_error(
    tmp_path, monkeypatch
):
    """A failure outside the decode stage on the prefetch worker flows
    through the same typed path (streaming.py _fill_queue)."""
    data = _multi_frame_stream(n_frames=24)
    p = tmp_path / "multi.qoa"
    p.write_bytes(data)
    dec = QoaDecoder.open(str(p), prefetch=True, readahead=2)

    def boom():
        raise RuntimeError("worker fault")

    got = []
    with pytest.raises(RuntimeError, match="worker fault"):
        for item in dec:
            if not isinstance(item, FrameHeader):
                got.append(item)
                if len(got) == 1:
                    monkeypatch.setattr(dec, "_produce", boom)
    assert got
    assert next(iter(dec), None) is None


def test_backend_native_unavailable_raises(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    data = codec.encode_all(make_sine(40, 1), QoaDesc(1, 44100, 40))
    with pytest.raises(RuntimeError, match="native engine unavailable"):
        codec.decode_all(data, backend="native")
    with pytest.raises(RuntimeError, match="native engine unavailable"):
        QoaDecoder(data, backend="native")


def test_parse_file_arrays_numpy_fallback_matches_native(
    fixture_bytes, monkeypatch
):
    """The pure-numpy gather of the O(1) whole-file parser must produce
    the same chain arrays as the native gather."""
    if not native.available():
        pytest.skip("no native engine to compare against")
    want = bs.parse_file_arrays(fixture_bytes)
    monkeypatch.setattr(native, "available", lambda: False)
    got = bs.parse_file_arrays(fixture_bytes)
    assert got is not None and want is not None
    assert np.array_equal(got.words_be, want.words_be)
    assert np.array_equal(got.state, want.state)
    assert np.array_equal(got.samples_per_frame, want.samples_per_frame)
    assert (got.n_frames, got.channels, got.sample_rate) == (
        want.n_frames, want.channels, want.sample_rate,
    )


def test_source_stops_on_midstream_corruption():
    """QoaPcmSource mirrors the rodio contract: a mid-stream error DROPS
    the remaining samples and ends iteration, no exception
    (src/lib.rs:941-954, the `?` operator)."""
    from qoaudio_tpu.source import QoaPcmSource

    data = _multi_frame_stream(n_frames=6, frame_len=2560)
    cut = QoaDecoder(data)  # geometry probe
    first = int.from_bytes(data[8:16], "big") & 0xFFFF
    truncated = data[: 8 + first + 20]  # inside the second frame
    src = QoaPcmSource(QoaDecoder(truncated))
    samples = list(src)
    assert 0 < len(samples) <= 2 * 2560
    # exhausted source stays exhausted
    assert next(iter(src), None) is None


def test_streaming_mode_singleton_dunders():
    s1, s2 = Streaming(), Streaming()
    assert s1 is s2
    assert s1 == s2 and hash(s1) == hash(s2)
    assert repr(s1) == "Streaming()"
    assert s1 != FixedSamples(2, 44100, 10)


def _ragged_stream(lens, channels=1, rate=44100):
    """Fixed-mode stream with partial INTERIOR frames (legal per
    src/lib.rs:54-57): frame i carries lens[i] samples/channel."""
    from qoaudio_tpu.streaming import QoaEncoder

    total = sum(lens)
    pcm = make_sine(total, channels)
    enc = QoaEncoder(QoaDesc(channels, rate, total))
    buf = io.BytesIO()
    buf.write(fmt.pack_file_header(total))
    pos = 0
    for ln in lens:
        enc.encode_frame(pcm[pos * channels : (pos + ln) * channels], buf)
        pos += ln
    return buf.getvalue()


@pytest.mark.parametrize("backend", ["jax", "numpy"])
def test_ragged_interior_frames_all_backends(backend):
    """Partial interior frames decode identically on every backend (the
    native path is the byte-exact baseline; jax/numpy take the ragged
    concat branch in codec._assemble)."""
    data = _ragged_stream([400, 300, 500])
    want = codec.decode_all(data, backend="native").samples
    got = codec.decode_all(data, backend=backend).samples
    assert np.array_equal(got, want)
    assert len(want) == 1200


def test_oversized_tail_rejected_by_fast_parser():
    """A tail frame LONGER than the uniform interior frames breaks the
    uniform-stride indexing: the O(1) parser must hand off to the general
    walk, which decodes it correctly."""
    data = _ragged_stream([100, 400])
    assert bs.parse_file_arrays(data) is None
    out = codec.decode_all(data)
    assert out.samples_per_channel == 500
    # differential vs the scalar-oracle path
    want = codec.decode_all(data, backend="numpy").samples
    assert np.array_equal(out.samples, want)


def test_open_and_decode_all(tmp_path, fixture_bytes):
    p = tmp_path / "f.qoa"
    p.write_bytes(fixture_bytes)
    out = codec.open_and_decode_all(str(p))
    assert out.samples_per_channel == 2_394_122 and out.num_channels == 2


def test_decode_range_validates_bounds(fixture_bytes):
    with pytest.raises(ValueError):
        codec.decode_range(fixture_bytes, -1, 10)
    with pytest.raises(ValueError):
        codec.decode_range(fixture_bytes, 10, 5)


def test_encode_all_numpy_backend_and_unknown_backend():
    pcm = make_sine(100, 1)
    desc = QoaDesc(1, 44100, 100)
    want = codec.encode_all(pcm, desc, backend="jax")
    assert codec.encode_all(pcm, desc, backend="numpy") == want
    with pytest.raises(ValueError, match="unknown backend"):
        codec.encode_all(pcm, desc, backend="torch")
    with pytest.raises(ValueError, match="unknown backend"):
        codec.decode_all(want, backend="torch")


def test_encode_all_native_unavailable_raises(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native engine unavailable"):
        codec.encode_all(make_sine(40, 1), QoaDesc(1, 44100, 40),
                         backend="native")


def test_seek_preconditions():
    from qoaudio_tpu.errors import IoError, NoSamples

    # non-seekable source: a growable streaming buffer
    dec = QoaDecoder.new_streaming()
    with pytest.raises(IoError):
        dec.seek_to_frame(0)

    # a fixed-mode header promising samples but carrying no frame is not
    # even constructible (the reference reads the first frame header in
    # new(), src/lib.rs:162)
    with pytest.raises(NoSamples):
        QoaDecoder(fmt.pack_file_header(100))


def test_next_frame_returns_partial_drain_with_current_header():
    """Samples already drained by the item iterator belong to the current
    frame: next_frame() returns the REMAINDER under the current header."""
    data = _ragged_stream([400, 300])
    dec = QoaDecoder(data)
    it = iter(dec)
    seen = []
    while len(seen) < 10:
        item = next(it)
        if not isinstance(item, FrameHeader):
            seen.append(item)
    hdr, rest = dec.next_frame()
    assert hdr.num_samples_per_channel == 400
    assert len(rest) == 390
    want = codec.decode_all(data).samples
    assert np.array_equal(np.concatenate([seen, rest]), want[:400])
    hdr2, block2 = dec.next_frame()
    assert hdr2.num_samples_per_channel == 300 and len(block2) == 300
    assert dec.next_frame() is None


def test_parsed_qoa_streaming_property():
    parsed = bs.parse_file(fmt.pack_file_header(0))
    assert parsed.streaming
    parsed2 = bs.parse_file(
        codec.encode_all(make_sine(40, 1), QoaDesc(1, 44100, 40))
    )
    assert not parsed2.streaming


def test_failed_seek_is_typed_and_lossless():
    """seek_to_frame verifies the landing bytes against the expected
    header; on a stream with non-uniform interior frames
    (src/lib.rs:54-57 makes those legal) it raises IoError and restores
    the reader — the decoder keeps iterating with nothing lost."""
    from qoaudio_tpu.errors import IoError

    data = _ragged_stream([400, 300, 500])
    dec = QoaDecoder(data)
    with pytest.raises(IoError, match="non-uniform"):
        dec.seek_to_frame(1)
    out = dec.decode_pending()
    want = codec.decode_all(data).samples
    assert np.array_equal(out, want)
