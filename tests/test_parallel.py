"""Sharding and batched-corpus tests.

Sharded code paths run in-process on a 1-device mesh (cheap, exercises the
same pjit/NamedSharding machinery); the genuine multi-device check runs in
a subprocess with a virtual 8-device CPU client and a tiny graph — see the
conftest docstring for why a multi-device CPU client must not host the
whole suite on a 1-core box.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from qoaudio_tpu import codec
from qoaudio_tpu import format as fmt
from qoaudio_tpu import reference as ref
from qoaudio_tpu.ops.decode import words_u32
from qoaudio_tpu.parallel.corpus import batch_encode, transcode_corpus
from qoaudio_tpu.parallel.mesh import (
    decode_chains_sharded,
    encode_frames_sharded,
    make_mesh,
)
from qoaudio_tpu.types import QoaDesc

from conftest import make_noise, make_sine

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_mesh_available():
    assert make_mesh().size >= 1


def test_multichip_dryrun_subprocess():
    """The driver's multi-chip dryrun must pass on a virtual 8-device mesh.

    Runs the exact code path the driver invokes (__graft_entry__.py
    --dryrun 8): tiny sharded encode+decode, bit-exact vs the scalar
    oracle.  Slow (~1 min: per-op dispatch on the multi-device CPU
    client), but it is the one hard multi-device signal in the suite.
    """
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, os.path.join(_ROOT, "__graft_entry__.py"), "--dryrun", "8"],
        env=env,
        timeout=520,
        capture_output=True,
        text=True,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "bit-exact" in proc.stdout


def test_batch_encode_matches_single_file():
    files = [
        (make_sine(700, 1), QoaDesc(1, 44100, 700)),
        (make_noise(6000, 2, seed=3), QoaDesc(2, 44100, 6000)),
        (make_noise(123, 1, seed=4), QoaDesc(1, 8000, 123)),
    ]
    batched = batch_encode(files)
    for (pcm, desc), data in zip(files, batched):
        want = codec.encode_all(pcm, desc)
        assert data == want


def test_batch_encode_sharded_matches_unsharded():
    mesh = make_mesh()
    files = [
        (make_noise(3000, 2, seed=i), QoaDesc(2, 44100, 3000))
        for i in range(4)
    ]
    sharded = batch_encode(files, mesh=mesh)
    plain = batch_encode(files)
    assert sharded == plain


def test_encode_frames_sharded_runs_on_mesh():
    mesh = make_mesh()
    N = 16  # divisible by 8 devices
    F = 1
    rng = np.random.default_rng(0)
    x = rng.integers(-30000, 30000, (F, 256, 20, N)).astype(np.int32)
    lens = np.full((F, 256, N), 20, np.int32)
    from qoaudio_tpu.ops.encode import encode_frames, initial_encoder_state

    state = initial_encoder_state(0, N)
    s1, sn1, hi1, lo1 = encode_frames_sharded(mesh, state, x, lens)
    s2, sn2, hi2, lo2 = encode_frames(state, x, lens)
    assert np.array_equal(np.asarray(hi1), np.asarray(hi2))
    assert np.array_equal(np.asarray(lo1), np.asarray(lo2))
    assert np.array_equal(np.asarray(s1), np.asarray(s2))


def test_decode_chains_sharded(fixture_bytes):
    from qoaudio_tpu import bitstream as bs

    mesh = make_mesh()
    parsed = bs.parse_file(fixture_bytes)
    batch = bs.stack_frames(parsed.frames[:8])
    F, W, C = batch.sf.shape
    words_be, state = bs.batch_chain_arrays(batch)  # 16 chains
    got = np.asarray(decode_chains_sharded(mesh, state, words_u32(words_be)))
    want = ref.decode_batch_np(batch)  # (F, W*20, C)
    got = got.reshape(W, 20, F, C).transpose(2, 0, 1, 3).reshape(F, W * 20, C)
    assert np.array_equal(got, want)


def test_transcode_corpus(tmp_path):
    # build a small mixed corpus
    paths = []
    specs = [
        (make_sine(5000, 1), QoaDesc(1, 44100, 5000)),
        (make_noise(12000, 2, seed=1), QoaDesc(2, 48000, 12000)),
        (make_noise(333, 1, seed=2), QoaDesc(1, 22050, 333)),
    ]
    for i, (pcm, desc) in enumerate(specs):
        p = tmp_path / f"in{i}.qoa"
        p.write_bytes(codec.encode_all(pcm, desc))
        paths.append(str(p))

    out_dir = tmp_path / "out"
    report = transcode_corpus(paths, out_dir=str(out_dir), verify=True)
    assert report.ok
    assert len(report.results) == 3
    # re-encoding an already-QOA-quantized signal is typically exact
    for r in report.results:
        assert r["rms"] < 500
    for i in range(3):
        assert (out_dir / f"in{i}.qoa").exists()
    assert any("Msamples/s" in line for line in report.lines())


def test_batch_decode_matches_single_file():
    from qoaudio_tpu.parallel.corpus import batch_decode

    streams = []
    wants = []
    for c, n, seed in [(2, 12000, 1), (1, 777, 2), (4, 5121, 3), (2, 20, 4)]:
        pcm = make_noise(n, c, seed=seed)
        data = codec.encode_all(pcm, QoaDesc(c, 44100, n))
        streams.append(data)
        wants.append(codec.decode_all(data).samples)
    outs = batch_decode(streams)
    for out, want in zip(outs, wants):
        assert np.array_equal(out.samples, want)


def test_batch_decode_streaming_mode_fallback():
    # a streaming-mode stream defeats the fast parser; batch_decode must
    # fall back to per-file decoding and still be exact
    from qoaudio_tpu import format as _fmt
    from qoaudio_tpu.parallel.corpus import batch_decode

    pcm = make_noise(3000, 2, seed=5)
    data = codec.encode_all(pcm, QoaDesc(2, 44100, 3000))
    stream = _fmt.pack_file_header(0) + data[8:]
    outs = batch_decode([stream, data])
    assert np.array_equal(outs[0].samples, codec.decode_all(stream).samples)
    assert np.array_equal(outs[1].samples, codec.decode_all(data).samples)


def test_batch_encode_chunked_staging_many_chunks():
    """Memory model: assembly and result staging are per-chunk (a 2-deep
    drain window), so a corpus spanning many chunks must still reassemble
    every file bit-exactly — including files that end mid-chunk."""
    files = [
        (make_noise(5120 * 5 + 17, 2, seed=21), QoaDesc(2, 44100, 5120 * 5 + 17)),
        (make_noise(5120 * 2 + 1, 1, seed=22), QoaDesc(1, 22050, 5120 * 2 + 1)),
        (make_noise(999, 2, seed=23), QoaDesc(2, 44100, 999)),
    ]
    batched = batch_encode(files, chunk_frames=1)  # 6 chunks, window of 2
    for (pcm, desc), data in zip(files, batched):
        assert data == codec.encode_all(pcm, desc)


def test_batch_encode_subframe_corpus_trims_windows():
    """A corpus of sub-frame clips scans only ceil(max/20) windows (the
    trailing zero-length windows are inert); streams stay bit-exact."""
    files = [
        (make_noise(45, 2, seed=31), QoaDesc(2, 44100, 45)),
        (make_noise(60, 1, seed=32), QoaDesc(1, 44100, 60)),
        (make_noise(25, 3, seed=33), QoaDesc(3, 8000, 25)),
    ]
    batched = batch_encode(files)
    for (pcm, desc), data in zip(files, batched):
        assert data == codec.encode_all(pcm, desc)


def test_batch_decode_sharded_matches_unsharded():
    mesh = make_mesh()
    files = [
        (make_noise(5200, 2, seed=41), QoaDesc(2, 44100, 5200)),
        (make_noise(2100, 1, seed=42), QoaDesc(1, 22050, 2100)),
    ]
    streams = [codec.encode_all(pcm, d) for pcm, d in files]
    from qoaudio_tpu.parallel.corpus import batch_decode

    plain = batch_decode(streams)
    sharded = batch_decode(streams, mesh=mesh)
    for a, b, s in zip(plain, sharded, streams):
        assert np.array_equal(a.samples, b.samples)
        assert np.array_equal(b.samples, codec.decode_all(s).samples)


def test_batch_transcode_device_resident():
    """decode -> on-device relayout -> encode must be byte-identical to the
    host decode->encode pair (PCM never reaches the host on this path)."""
    from qoaudio_tpu.parallel.corpus import batch_transcode

    files = [
        (make_noise(5120 * 2 + 300, 2, seed=61), QoaDesc(2, 44100, 5120 * 2 + 300)),
        (make_noise(700, 1, seed=62), QoaDesc(1, 22050, 700)),
        (make_noise(5120, 3, seed=63), QoaDesc(3, 8000, 5120)),
    ]
    streams = [codec.encode_all(pcm, d) for pcm, d in files]
    got = batch_transcode(streams)
    for s, g in zip(streams, got):
        out = codec.decode_all(s)
        want = codec.encode_all(
            out.samples,
            QoaDesc(out.num_channels, out.sample_rate, out.samples_per_channel),
        )
        assert g == want


def test_batch_transcode_nonstandard_framing_falls_back():
    # a uniform 2560-sample-frame stream is valid QOA but not the standard
    # framing the device relayout assumes; the host fallback must cover it
    import io

    from qoaudio_tpu.parallel.corpus import batch_transcode
    from qoaudio_tpu.streaming import QoaEncoder

    pcm = make_noise(2560 * 3, 2, seed=64)
    enc = QoaEncoder(QoaDesc(2, 44100, 2560 * 3))
    buf = io.BytesIO()
    enc.write_header(buf)
    for off in range(0, 2560 * 3, 2560):
        enc.encode_frame(pcm[off * 2 : (off + 2560) * 2], buf)
    stream = buf.getvalue()

    (got,) = batch_transcode([stream])
    out = codec.decode_all(stream)
    want = codec.encode_all(
        out.samples, QoaDesc(out.num_channels, out.sample_rate, out.samples_per_channel)
    )
    assert got == want


def test_batch_transcode_sharded_matches_unsharded():
    # the flagship HBM-resident pipeline under a mesh: decode chains and
    # encode chains shard independently; bytes must equal the unsharded
    # device path AND the host decode->encode pair
    from qoaudio_tpu.parallel.corpus import batch_transcode

    mesh = make_mesh()
    files = [
        (make_noise(5120 * 2 + 300, 2, seed=71), QoaDesc(2, 44100, 5120 * 2 + 300)),
        (make_noise(700, 1, seed=72), QoaDesc(1, 22050, 700)),
    ]
    streams = [codec.encode_all(pcm, d) for pcm, d in files]
    plain = batch_transcode(streams)
    sharded = batch_transcode(streams, mesh=mesh)
    assert plain == sharded
    for s, g in zip(streams, sharded):
        out = codec.decode_all(s)
        want = codec.encode_all(
            out.samples,
            QoaDesc(out.num_channels, out.sample_rate, out.samples_per_channel),
        )
        assert g == want


def test_batch_transcode_single_frame_files_use_device_path(monkeypatch):
    # single-frame files of ANY length satisfy the relayout identity, so a
    # corpus of short clips must NOT fall back to the host pair
    from qoaudio_tpu import codec as qcodec
    from qoaudio_tpu.parallel import corpus

    calls = {"n": 0}
    orig = qcodec.decode_all

    def spy(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(qcodec, "decode_all", spy)
    files = [
        (make_noise(45, 2, seed=81), QoaDesc(2, 44100, 45)),
        (make_noise(700, 1, seed=82), QoaDesc(1, 22050, 700)),
    ]
    streams = [codec.encode_all(pcm, d) for pcm, d in files]
    got = corpus.batch_transcode(streams)
    assert calls["n"] == 0, "single-frame corpus fell back to the host pair"
    for s, g in zip(streams, got):
        out = orig(s)
        want = codec.encode_all(
            out.samples,
            QoaDesc(out.num_channels, out.sample_rate, out.samples_per_channel),
        )
        assert g == want


def test_batch_transcode_fused_handle():
    # return_fused_handle=True must hand back the staged single-dispatch
    # pipeline: calling the handle reproduces the packed device buffers
    # bit-for-bit, and the default call signature stays a plain list
    import numpy as np

    from qoaudio_tpu.parallel import corpus

    files = [
        (make_noise(2 * 5120 + 33, 2, seed=101), QoaDesc(2, 44100, 2 * 5120 + 33)),
        (make_noise(5120, 1, seed=102), QoaDesc(1, 22050, 5120)),
    ]
    streams = [codec.encode_all(pcm, d) for pcm, d in files]
    outs, handle = corpus.batch_transcode(streams, return_fused_handle=True)
    assert isinstance(outs, list) and all(isinstance(o, bytes) for o in outs)
    assert isinstance(handle, corpus.TranscodeFusedHandle)
    sp, hp, lp = handle()  # re-dispatch the staged pipeline
    sp2, hp2, lp2 = handle.fn(*handle.args)
    for a, b in ((sp, sp2), (hp, hp2), (lp, lp2)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    # plain call: no tuple, no handle retained anywhere in module state
    plain = corpus.batch_transcode(streams)
    assert plain == outs
    assert not hasattr(corpus, "_LAST_FUSED_CALL")


def test_batch_transcode_fused_handle_mixed_fallback():
    # with a host-fallback file in the corpus the handle must still cover
    # the device-eligible subset
    import io

    from qoaudio_tpu.parallel import corpus
    from qoaudio_tpu.streaming import QoaEncoder

    good = codec.encode_all(make_noise(5120 + 7, 2, seed=111),
                            QoaDesc(2, 44100, 5120 + 7))
    # non-standard uniform framing (2560-sample frames) -> host pair
    pcm = make_noise(2560 * 2, 1, seed=112)
    enc = QoaEncoder(QoaDesc(1, 44100, 2560 * 2))
    buf = io.BytesIO()
    enc.write_header(buf)
    for off in range(0, 2560 * 2, 2560):
        enc.encode_frame(pcm[off : off + 2560], buf)
    odd = buf.getvalue()
    outs, handle = corpus.batch_transcode([good, odd],
                                          return_fused_handle=True)
    assert isinstance(handle, corpus.TranscodeFusedHandle)
    for s, g in zip([good, odd], outs):
        out = codec.decode_all(s)
        want = codec.encode_all(
            out.samples,
            QoaDesc(out.num_channels, out.sample_rate, out.samples_per_channel),
        )
        assert g == want


def test_transcode_fused_cache_reuse():
    # the per-corpus-signature jit cache must serve repeat corpora without
    # rebuilding, and repeated calls must stay byte-identical
    from qoaudio_tpu.parallel import corpus

    files = [
        (make_noise(5120 + 77, 2, seed=91), QoaDesc(2, 44100, 5120 + 77)),
        (make_noise(300, 1, seed=92), QoaDesc(1, 8000, 300)),
    ]
    streams = [codec.encode_all(pcm, d) for pcm, d in files]
    before = len(corpus._TRANSCODE_FUSED_CACHE)
    first = corpus.batch_transcode(streams)
    mid = len(corpus._TRANSCODE_FUSED_CACHE)
    second = corpus.batch_transcode(streams)
    after = len(corpus._TRANSCODE_FUSED_CACHE)
    assert first == second
    assert mid == after  # second call hit the cache
    assert mid >= before  # first call may have added (or reused) an entry


def test_batch_transcode_random_corpora_property():
    # randomized corpus shapes (single/multi-frame, 1-4 channels, short
    # tails) through the device path must equal the host pair byte-for-byte
    from qoaudio_tpu.parallel.corpus import batch_transcode

    rng = np.random.default_rng(17)
    for trial in range(4):
        n_files = int(rng.integers(1, 5))
        files = []
        for j in range(n_files):
            ch = int(rng.integers(1, 5))
            kind = rng.integers(0, 3)
            if kind == 0:
                spc = int(rng.integers(1, 200))  # short single-frame clip
            elif kind == 1:
                spc = int(rng.integers(4000, 5121))  # near-frame boundary
            else:
                spc = 5120 * int(rng.integers(1, 4)) + int(rng.integers(0, 200))
            pcm = rng.integers(-32768, 32768, spc * ch).astype(np.int16)
            files.append((pcm, QoaDesc(ch, 44100, spc)))
        streams = [codec.encode_all(p, d) for p, d in files]
        got = batch_transcode(streams)
        for s, g in zip(streams, got):
            out = codec.decode_all(s)
            want = codec.encode_all(
                out.samples,
                QoaDesc(out.num_channels, out.sample_rate, out.samples_per_channel),
            )
            assert g == want, f"trial {trial}"


def test_batch_decode_non_window_aligned_uniform_frames():
    # uniform multi-frame streams whose frame length is not a multiple of
    # 20 (legal: the decoder reads spc from every header) must decode
    # bit-exactly — the fused interleave+trim's single trailing trim is
    # only valid for window-aligned frames (regression: sample 30 onward
    # was garbage for 2x30-sample frames)
    import io

    from qoaudio_tpu.parallel.corpus import batch_decode
    from qoaudio_tpu.streaming import QoaEncoder

    for frame_len, n_frames, ch in [(30, 2, 1), (2570, 3, 2), (45, 4, 1)]:
        n = frame_len * n_frames
        pcm = make_noise(n, ch, seed=frame_len)
        enc = QoaEncoder(QoaDesc(ch, 44100, n))
        buf = io.BytesIO()
        enc.write_header(buf)
        for off in range(0, n, frame_len):
            enc.encode_frame(pcm[off * ch : (off + frame_len) * ch], buf)
        data = buf.getvalue()
        want = codec.decode_all(data).samples
        (got,) = batch_decode([data])
        assert np.array_equal(got.samples, want), frame_len


def test_batch_corpus_partial_fallback_keeps_batching():
    # one rejected stream must not force the WHOLE corpus onto the host
    # path: the eligible files still batch, every output stays exact and
    # in order
    import io

    from qoaudio_tpu import format as _fmt
    from qoaudio_tpu.parallel.corpus import batch_decode, batch_transcode
    from qoaudio_tpu.streaming import QoaEncoder

    pcm1 = make_noise(5120 + 300, 2, seed=51)
    good1 = codec.encode_all(pcm1, QoaDesc(2, 44100, 5120 + 300))
    pcm2 = make_noise(700, 1, seed=52)
    good2 = codec.encode_all(pcm2, QoaDesc(1, 22050, 700))
    # a streaming-mode stream defeats the arithmetic parser
    streaming = _fmt.pack_file_header(0) + good2[8:]
    # a non-standard uniform multi-frame stream defeats the relayout gate
    pcm3 = make_noise(2560 * 2, 1, seed=53)
    enc = QoaEncoder(QoaDesc(1, 44100, 2560 * 2))
    buf = io.BytesIO()
    enc.write_header(buf)
    enc.encode_frame(pcm3[:2560], buf)
    enc.encode_frame(pcm3[2560:], buf)
    nonstd = buf.getvalue()

    streams = [good1, streaming, good2, nonstd]
    outs = batch_decode(streams)
    for s, o in zip(streams, outs):
        assert np.array_equal(o.samples, codec.decode_all(s).samples)

    got = batch_transcode(streams)
    for s, g in zip(streams, got):
        out = codec.decode_all(s)
        want = codec.encode_all(
            out.samples,
            QoaDesc(out.num_channels, out.sample_rate, out.samples_per_channel),
        )
        assert g == want


def test_batch_apis_empty_and_invalid_inputs():
    """Empty corpora return []; a PCM/desc size mismatch is the encoder's
    InvalidSamples, raised before any device work."""
    import pytest

    from qoaudio_tpu.errors import InvalidSamples
    from qoaudio_tpu.parallel import batch_decode, batch_encode, batch_transcode

    assert batch_encode([]) == []
    assert batch_decode([]) == []
    assert batch_transcode([]) == []
    with pytest.raises(InvalidSamples):
        batch_encode([(make_noise(99, 1, seed=3), QoaDesc(1, 44100, 100))])


def test_batch_apis_no_jax_backend_host_fallback(monkeypatch):
    """With no usable jax platform the corpus APIs still deliver the same
    bit-exact streams through the host engine, file by file."""
    from qoaudio_tpu.parallel import corpus as corpus_mod
    from qoaudio_tpu.parallel import batch_decode, batch_encode, batch_transcode

    files = [
        (make_noise(333, 2, seed=11), QoaDesc(2, 44100, 333)),
        (make_noise(101, 1, seed=12), QoaDesc(1, 22050, 101)),
    ]
    want_streams = batch_encode(files)
    want_pcm = [o.samples for o in batch_decode(want_streams)]
    want_transcode = batch_transcode(want_streams)

    monkeypatch.setattr(corpus_mod, "_jax_platform", lambda: None)
    got_streams = batch_encode(files)
    assert got_streams == want_streams
    got = batch_decode(want_streams)
    assert all(
        np.array_equal(a.samples, b) for a, b in zip(got, want_pcm)
    )
    assert batch_transcode(want_streams) == want_transcode


def test_length_buckets_partition_properties():
    """The DP partitioner: <=1 tile of chains never buckets (the
    structural analysis says packing pays only past 128 chains), uniform
    lengths never bucket, and a large mixed corpus splits at a length
    boundary with every index appearing exactly once."""
    from qoaudio_tpu.parallel.corpus import _length_buckets

    # the bench corpus shape: 48 chains in one 128-lane tile -> None
    frames = [(64, 128, 256)[i % 3] for i in range(32)]
    chans = [(2, 1, 2, 1)[i % 4] for i in range(32)]
    assert _length_buckets(frames, chans, 128, 64) is None

    # uniform lengths -> None regardless of scale
    assert _length_buckets([64] * 256, [2] * 256, 128, 64) is None

    # 256 stereo files, half 64 frames and half 256: single launch pads
    # every lane to 256 frames; two buckets cut the padded work ~1.4x
    frames = [64] * 128 + [256] * 128
    chans = [2] * 256
    segs = _length_buckets(frames, chans, 128, 64)
    assert segs is not None and len(segs) == 2
    flat = sorted(i for s in segs for i in s)
    assert flat == list(range(256))
    assert segs[0] == list(range(128)) and segs[1] == list(range(128, 256))
    # buckets preserve original input order internally
    assert all(s == sorted(s) for s in segs)


def test_batch_transcode_bucketed_bit_exact(monkeypatch):
    """bucket='auto' must produce byte-identical streams to the single
    launch and to the host pair, reassembled in input order, and the
    returned handle must cover every bucket.  The cost constants shrink
    so a small CPU corpus actually buckets (e_mult=1 on the XLA path)."""
    from qoaudio_tpu.parallel import corpus

    monkeypatch.setattr(corpus, "_BUCKET_OVERHEAD", 1.0)
    files = [
        (make_noise(5120 * 8 + 40, 2, seed=201), QoaDesc(2, 44100, 5120 * 8 + 40)),
        (make_noise(300, 1, seed=202), QoaDesc(1, 22050, 300)),
        (make_noise(5120 + 7, 2, seed=203), QoaDesc(2, 48000, 5120 + 7)),
        (make_noise(5120 * 8, 1, seed=204), QoaDesc(1, 44100, 5120 * 8)),
    ]
    streams = [codec.encode_all(pcm, d) for pcm, d in files]
    segs = corpus._length_buckets(
        [-(-d.samples // fmt.QOA_FRAME_LEN) for _, d in files],
        [d.channels for _, d in files],
        1,
        64,
    )
    assert segs is not None and len(segs) > 1, "corpus must actually bucket"

    got, handle = corpus.batch_transcode(streams, return_fused_handle=True)
    single = corpus.batch_transcode(streams, bucket=False)
    assert got == single
    for s, g in zip(streams, got):
        out = codec.decode_all(s)
        want = codec.encode_all(
            out.samples,
            QoaDesc(out.num_channels, out.sample_rate, out.samples_per_channel),
        )
        assert g == want
    assert isinstance(handle, corpus._CompositeFusedHandle)
    assert len(handle.handles) == len(segs)
    r = handle()  # re-dispatch every bucket; returns the last bucket's outputs
    assert r is not None and len(r) == 3


def test_batch_transcode_bucketed_with_host_fallback(monkeypatch):
    """Bucketing composes with the ineligible-stream host fallback: the
    rejected stream takes the host pair, the rest buckets, order holds."""
    import io

    from qoaudio_tpu.parallel import corpus
    from qoaudio_tpu.streaming import QoaEncoder

    monkeypatch.setattr(corpus, "_BUCKET_OVERHEAD", 1.0)
    pcm = make_noise(2560 * 2, 2, seed=211)
    enc = QoaEncoder(QoaDesc(2, 44100, 2560 * 2))
    buf = io.BytesIO()
    enc.write_header(buf)
    for off in range(0, 2560 * 2, 2560):
        enc.encode_frame(pcm[off * 2 : (off + 2560) * 2], buf)
    odd = buf.getvalue()

    files = [
        (make_noise(5120 * 8 + 11, 2, seed=212), QoaDesc(2, 44100, 5120 * 8 + 11)),
        (make_noise(400, 1, seed=213), QoaDesc(1, 22050, 400)),
        (make_noise(5120 * 8, 1, seed=214), QoaDesc(1, 48000, 5120 * 8)),
    ]
    streams = [codec.encode_all(pcm_i, d) for pcm_i, d in files]
    mixed = [streams[0], odd, streams[1], streams[2]]
    got = corpus.batch_transcode(mixed)
    for s, g in zip(mixed, got):
        out = codec.decode_all(s)
        want = codec.encode_all(
            out.samples,
            QoaDesc(out.num_channels, out.sample_rate, out.samples_per_channel),
        )
        assert g == want


def test_batch_transcode_bucketed_under_mesh(monkeypatch):
    """bucket='auto' composes with ``mesh=``: the bucket partitioner uses
    the sharded kernel's chain multiple, every bucket's sub-call runs the
    sharded decode->relayout->encode pipeline, bytes equal both the
    unbucketed mesh run and the host pair in input order, and the fused
    handle is None (the mesh path stages no single-dispatch pipeline)."""
    from qoaudio_tpu.parallel import corpus

    monkeypatch.setattr(corpus, "_BUCKET_OVERHEAD", 1.0)
    files = [
        (make_noise(5120 * 8 + 13, 2, seed=221), QoaDesc(2, 44100, 5120 * 8 + 13)),
        (make_noise(320, 1, seed=222), QoaDesc(1, 22050, 320)),
        (make_noise(5120 + 9, 2, seed=223), QoaDesc(2, 48000, 5120 + 9)),
        (make_noise(5120 * 8, 1, seed=224), QoaDesc(1, 44100, 5120 * 8)),
    ]
    streams = [codec.encode_all(pcm, d) for pcm, d in files]
    mesh = make_mesh()
    segs = corpus._length_buckets(
        [-(-d.samples // fmt.QOA_FRAME_LEN) for _, d in files],
        [d.channels for _, d in files],
        mesh.size,
        64,
    )
    assert segs is not None and len(segs) > 1, "corpus must actually bucket"

    got, handle = corpus.batch_transcode(
        streams, mesh=mesh, return_fused_handle=True
    )
    assert handle is None
    assert got == corpus.batch_transcode(streams, mesh=mesh, bucket=False)
    for s, g in zip(streams, got):
        out = codec.decode_all(s)
        want = codec.encode_all(
            out.samples,
            QoaDesc(out.num_channels, out.sample_rate, out.samples_per_channel),
        )
        assert g == want
