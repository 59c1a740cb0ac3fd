"""Command-line tools: encode / decode / play / transcode.

Analogs of the reference examples (/root/reference/examples/encode.rs,
decode.rs, play.rs) plus a batched corpus ``transcode`` command that has no
reference counterpart (SURVEY.md §1, new top layer).

Usage:
  python -m qoaudio_tpu.cli encode  input.wav output.qoa
  python -m qoaudio_tpu.cli decode  input.qoa output.wav
  python -m qoaudio_tpu.cli play    input.qoa          (writes to sink/stdout)
  python -m qoaudio_tpu.cli transcode *.qoa --out-dir DIR
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def _cmd_encode(args) -> int:
    from . import codec
    from .types import QoaDesc
    from .utils.wav import read_wav

    inputs = args.input
    multi = len(inputs) > 1
    if multi or (os.path.isdir(args.output) or args.output.endswith(os.sep)):
        out_dir = args.output
        os.makedirs(out_dir, exist_ok=True)
        outs = [
            os.path.join(
                out_dir,
                os.path.splitext(os.path.basename(i))[0] + ".qoa",
            )
            for i in inputs
        ]
    else:
        outs = [args.output]

    items = []
    for path in inputs:
        pcm, channels, rate = read_wav(path)
        items.append((pcm, QoaDesc(channels, rate, len(pcm) // channels)))

    # one batch call: on the native backend, mono files pair into the
    # C==2 chain for up to 2x aggregate throughput (codec.encode_all_batch)
    t0 = time.perf_counter()
    streams = codec.encode_all_batch(items, backend=args.backend)
    dt = time.perf_counter() - t0

    total_samples = 0
    total_pcm_bytes = 0
    total_qoa_bytes = 0
    for path, out, (pcm, desc), data in zip(inputs, outs, items, streams):
        with open(out, "wb") as f:
            f.write(data)
        pcm_bytes = len(pcm) * 2
        total_samples += len(pcm)
        total_pcm_bytes += pcm_bytes
        total_qoa_bytes += len(data)
        print(
            f"{path}: {desc.samples} samples/ch, {desc.channels} ch, "
            f"{desc.sample_rate} Hz -> {out} "
            f"({pcm_bytes} -> {len(data)} bytes, "
            f"compression {pcm_bytes / len(data):.2f}x)"
        )
    print(
        f"encoded {total_pcm_bytes} -> {total_qoa_bytes} bytes "
        f"(compression {total_pcm_bytes / total_qoa_bytes:.2f}x) in "
        f"{dt*1e3:.1f} ms ({total_samples/dt/1e6:.1f} Msamples/s)"
    )
    return 0


def _cmd_decode(args) -> int:
    from . import codec
    from .utils.wav import write_wav

    with open(args.input, "rb") as f:
        data = f.read()
    t0 = time.perf_counter()
    out = codec.decode_all(data, backend=args.backend)
    dt = time.perf_counter() - t0
    write_wav(args.output, out.samples, out.num_channels, out.sample_rate)
    print(
        f"decoded {len(out.samples)} samples ({out.num_channels} ch, "
        f"{out.sample_rate} Hz, {out.duration_seconds:.1f} s) "
        f"in {dt*1e3:.1f} ms ({len(out.samples)/dt/1e6:.1f} Msamples/s)"
    )
    return 0


def _play_audio_sink(src, block, bf, pending) -> int:
    """Stream decoded PCM to a real audio device via sounddevice.

    The analog of the reference's rodio sink (/root/reference/
    examples/play.rs:11-25, src/lib.rs:914-989): blocks stream to the
    device as frames decode, so playback starts before the file finishes
    decoding.  ``bf`` is ``block``'s (channels, rate); ``pending`` is an
    already-read (block, format) of the NEXT segment, or None.
    """
    import sounddevice as sd  # availability probed by the caller

    while len(block):
        # one OutputStream per format segment: a read never spans a
        # format change, and each block carries its own format (the
        # source's channels/sample_rate can already describe the NEXT
        # staged frame when a read stopped at the boundary)
        ch, rate = bf
        with sd.OutputStream(
            samplerate=rate, channels=ch, dtype="int16"
        ) as stream:
            while len(block):
                # a ``pending`` block was read with the PREVIOUS segment's
                # value limit and can stop mid-frame at a non-multiple of
                # THIS segment's channel count: write only whole samples
                # and carry the tail into the next read.  The carry always
                # resolves within the segment (segments hold whole frames,
                # so each segment's total length is a multiple of its
                # channel count), leaving it empty at every format change.
                whole = len(block) - len(block) % ch
                if whole:
                    stream.write(
                        np.ascontiguousarray(block[:whole].reshape(-1, ch))
                    )
                carry = block[whole:]
                if pending is not None:
                    (block, bf), pending = pending, None
                else:
                    block = src.read(8192 * ch)
                    bf = (src.block_channels, src.block_sample_rate)
                if carry.size:
                    if not len(block):
                        break  # defensive: a mid-sample EOF drops the tail
                    block = np.concatenate([carry, block])
                if bf != (ch, rate):
                    break  # reopen the device for the new format
    return 0


def _cmd_play(args) -> int:
    """Stream samples to an audio sink.

    ``--sink audio`` plays through the default output device (requires the
    optional ``sounddevice`` package and an audio device — absent on
    headless servers, in which case it falls back to WAV).  ``--sink wav`` (default)
    renders to a WAV file; ``--sink raw`` streams raw PCM to stdout,
    pipeable into e.g. ``aplay -f S16_LE``.
    """
    from .source import QoaPcmSource
    from .streaming import QoaDecoder

    src = QoaPcmSource(QoaDecoder.open(args.input, backend=args.backend))
    # pull one sample so the first block's format is known (streaming-mode
    # files report channels 0 until the first frame is pulled), then top
    # up to a channel-aligned block so the audio sink's (n, channels)
    # reshape holds for every channel count.  One read never spans a
    # format change, but CONSECUTIVE reads cross it — compare block
    # formats before merging and hold a crossed block as pending.
    first = src.read(1)
    fmt0 = (src.block_channels, src.block_sample_rate)
    pending = None  # an already-read (block, format) of the NEXT segment
    if len(first):
        top = src.read(8192 * max(1, fmt0[0]) - 1)
        if top.size:
            bf = (src.block_channels, src.block_sample_rate)
            if bf == fmt0:
                first = np.concatenate([first, top])
            else:  # 1-sample first segment, already crossed the boundary
                pending = (top, bf)

    sink = args.sink
    if sink == "audio":
        # probe availability only (module import + device settings); a
        # failure MID-PLAYBACK must propagate — blocks already played are
        # gone, so silently "falling back" would write a corrupted WAV
        try:
            import sounddevice as sd

            sd.check_output_settings(
                samplerate=max(1, fmt0[1]),
                channels=max(1, fmt0[0]),
                dtype="int16",
            )
        except Exception as e:  # no module or no usable device
            print(f"audio sink unavailable ({e}); falling back to WAV",
                  file=sys.stderr)
            sink = "wav"
        else:
            return _play_audio_sink(src, first, fmt0, pending)
    if sink == "raw":
        # raw PCM is untyped: stream every segment regardless of format
        sys.stdout.buffer.write(first.astype("<i2").tobytes())
        if pending is not None:
            sys.stdout.buffer.write(pending[0].astype("<i2").tobytes())
        while True:
            more = src.read()
            if not more.size:
                break
            sys.stdout.buffer.write(more.astype("<i2").tobytes())
        return 0
    # WAV sink: drain the rest of the FIRST format segment only (a WAV
    # holds exactly one format; block formats gate every append)
    blocks = [first]
    changed = pending is not None
    while not changed:
        b = src.read()
        if not b.size:
            break
        if (src.block_channels, src.block_sample_rate) != fmt0:
            changed = True
            break
        blocks.append(b)
    samples = np.concatenate(blocks)
    if samples.size == 0 or fmt0[0] == 0 or fmt0[1] == 0:
        print(f"{args.input}: no playable frames; nothing written")
        return 0
    ch0, rate0 = fmt0
    out = args.output or (os.path.splitext(args.input)[0] + ".play.wav")
    from .utils.wav import write_wav

    if changed:
        print(
            f"{args.input}: mid-stream format change — writing only the "
            "first segment (use --sink raw for the whole stream)",
            file=sys.stderr,
        )
    write_wav(out, samples, ch0, rate0)
    dur = src.total_duration()
    print(
        f"rendered {args.input} ({ch0} ch, {rate0} Hz"
        + (f", {dur:.1f} s" if dur else "")
        + f") -> {out}"
    )
    return 0


def _cmd_info(args) -> int:
    """Print stream metadata without decoding any samples.

    A pure header walk: reads each 8-byte frame header and skips the
    spc-derived body (the reference reader's stride, src/lib.rs:291-330)
    — no slice-word staging, O(frames) work and O(1) memory.  Damaged
    files report everything parsed up to the corruption instead of a
    traceback (that is exactly when one runs ``info``).
    """
    from . import bitstream as bs
    from . import format as fmt
    from .errors import QoaError

    with open(args.input, "rb") as f:
        data = f.read()
    total = fmt.unpack_file_header(data)
    mode = "streaming" if total == 0 else "fixed"
    frames = 0
    channels = rates = None
    samples = 0
    damage = None
    off = fmt.QOA_HEADER_SIZE
    n = len(data)
    while off + 8 <= n:
        word = int.from_bytes(data[off : off + 8], "big")
        ch, rate, spc, fsize = fmt.unpack_frame_header(word)
        try:
            bs._validate_frame_header(ch, rate, fsize)
        except QoaError as e:
            damage = f"invalid frame header at byte {off} ({e.__class__.__name__})"
            break
        nw = -(-spc // fmt.QOA_SLICE_LEN)
        body = fmt.QOA_LMS_STATE_BYTES * ch + 8 * nw * ch
        if off + 8 + body > n:
            damage = f"truncated frame at byte {off}"
            break
        frames += 1
        channels, rates = ch, rate
        samples += spc
        off += 8 + body
    if 0 < n - off < 8 and damage is None:
        damage = f"trailing {n - off} bytes after the last frame"
    print(f"{args.input}: {mode} mode, {frames} frames")
    if frames == 0 or not rates or not samples:
        # degenerate but parseable (e.g. header-only stream): counts only
        print(f"  {len(data)} bytes, no frames")
        return 0
    print(f"  channels {channels}, sample rate {rates} Hz")
    print(
        f"  {samples} samples/ch ({samples / rates:.2f} s), "
        f"{len(data)} bytes, "
        f"{len(data) * 8 / (samples * (channels or 1)):.2f} bits/sample"
    )
    if total and total != samples:
        print(f"  note: header declares {total} samples/ch")
    if damage:
        print(f"  note: {damage}")
    return 0


def _cmd_transcode(args) -> int:
    if args.backend != "auto" and not args.hbm:
        # an explicit backend pins every stage to that engine (e.g. a
        # numpy-oracle verification run), file by file
        from . import codec
        from .types import QoaDesc

        t0 = time.perf_counter()
        total = 0
        for p in args.inputs:
            with open(p, "rb") as f:
                data = f.read()
            out = codec.decode_all(data, backend=args.backend)
            enc = codec.encode_all(
                out.samples,
                QoaDesc(out.num_channels, out.sample_rate, out.samples_per_channel),
                backend=args.backend,
            )
            total += len(out.samples)
            if args.out_dir:
                os.makedirs(args.out_dir, exist_ok=True)
                name = os.path.splitext(os.path.basename(p))[0] + ".qoa"
                with open(os.path.join(args.out_dir, name), "wb") as f:
                    f.write(enc)
        dt = time.perf_counter() - t0
        print(
            f"transcoded {len(args.inputs)} files on backend="
            f"{args.backend}: {total} samples in {dt*1e3:.0f} ms "
            f"({total/dt/1e6:.1f} Msamples/s)"
        )
        return 0
    if args.hbm and args.backend != "auto":
        print(
            "--hbm selects the device pipeline; --backend is ignored",
            file=sys.stderr,
        )
    if args.hbm:
        # HBM-resident pipeline: decode -> on-device relayout -> encode;
        # PCM never reaches the host, so there is nothing to verify against
        # without a separate decode — report sizes and timing only
        from .parallel.corpus import batch_transcode

        datas = []
        for p in args.inputs:
            with open(p, "rb") as f:
                datas.append(f.read())
        t0 = time.perf_counter()
        outs = batch_transcode(datas)
        dt = time.perf_counter() - t0
        total_in = sum(len(d) for d in datas)
        total_out = 0
        for p, data in zip(args.inputs, outs):
            total_out += len(data)
            if args.out_dir:
                os.makedirs(args.out_dir, exist_ok=True)
                name = os.path.splitext(os.path.basename(p))[0] + ".qoa"
                with open(os.path.join(args.out_dir, name), "wb") as f:
                    f.write(data)
        print(
            f"device transcode: {len(outs)} files, {total_in} -> {total_out} "
            f"bytes in {dt*1e3:.0f} ms (PCM stayed device-resident)"
        )
        return 0

    from .parallel.corpus import transcode_corpus

    report = transcode_corpus(
        args.inputs,
        out_dir=args.out_dir,
        verify=not args.no_verify,
    )
    for line in report.lines():
        print(line)
    return 0 if report.ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="qoaudio_tpu", description=__doc__)
    p.add_argument(
        "--backend",
        choices=["auto", "native", "jax", "numpy"],
        default="auto",
        help="execution backend for the codec core (auto = native host "
        "engine when available, else the JAX device kernels)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("encode", help="WAV -> QOA (many inputs batch)")
    pe.add_argument("input", nargs="+")
    pe.add_argument(
        "output",
        help="output .qoa file, or a directory with multiple inputs "
        "(mono files pair into the native engine's stereo chain)",
    )
    pe.set_defaults(fn=_cmd_encode)

    pd = sub.add_parser("decode", help="QOA -> WAV")
    pd.add_argument("input")
    pd.add_argument("output")
    pd.set_defaults(fn=_cmd_decode)

    pp = sub.add_parser("play", help="decode to an audio sink")
    pp.add_argument("input")
    pp.add_argument("--output", default=None)
    pp.add_argument(
        "--sink",
        choices=["audio", "wav", "raw"],
        default="wav",
        help="audio = play through the default device (sounddevice; falls "
        "back to wav when unavailable)",
    )
    pp.set_defaults(fn=_cmd_play)

    pi = sub.add_parser("info", help="print stream metadata")
    pi.add_argument("input")
    pi.set_defaults(fn=_cmd_info)

    pt = sub.add_parser("transcode", help="batched corpus transcode")
    pt.add_argument("inputs", nargs="+")
    pt.add_argument("--out-dir", default=None)
    pt.add_argument("--no-verify", action="store_true")
    pt.add_argument(
        "--hbm",
        action="store_true",
        help="HBM-resident pipeline: PCM never leaves the device; only "
        "compressed data crosses the host<->device link",
    )
    pt.set_defaults(fn=_cmd_transcode)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
