"""qoaudio_tpu — a bit-exact QOA ("Quite OK Audio") codec framework.

A ground-up re-design of the capabilities of the reference Rust crate
``qoaudio`` (rafaelcaricio/qoaudio): streaming + one-shot decode, one-shot
+ frame-at-a-time encode (checkpoint/resume), random access, playback
source + audio sink, WAV tooling, and batched multi-chip corpus transcode.

Two execution tiers share one bit-exact algorithm: JAX/XLA/Pallas device
kernels (a Pallas encode kernel on a GPU) for the batched device-resident
deployment shape (frames decode in
parallel — each carries a full LMS snapshot; the encoder evaluates all 16
scalefactor candidates as vector lanes with exact wrapping int32
semantics), and a native C++ SIMD engine for the latency-bound host/IO
paths.  ``backend="auto"`` picks per call site.
"""

from .format import (  # noqa: F401
    QOA_FRAME_LEN,
    QOA_HEADER_SIZE,
    QOA_LMS_LEN,
    QOA_MAGIC,
    QOA_MAX_CHANNELS,
    QOA_SLICE_LEN,
    QOA_SLICES_PER_FRAME,
    MAX_SLICES_PER_CHANNEL_PER_FRAME,
    qoa_frame_size,
)

from .errors import (  # noqa: F401
    DecodeError,
    EncodeError,
    IncompatibleFrame,
    InvalidChannels,
    InvalidFrameHeader,
    InvalidSampleRate,
    InvalidSamples,
    IoError,
    NoSamples,
    NotQoaFile,
    QoaError,
)

from .types import (  # noqa: F401
    DecodedQoa,
    FixedSamples,
    FrameHeader,
    ProcessingMode,
    QoaDesc,
    Streaming,
)

from .codec import (  # noqa: F401
    decode_all,
    decode_range,
    encode_all,
    encode_all_batch,
    open_and_decode_all,
)

from .streaming import QoaDecoder, QoaEncoder  # noqa: F401
from .source import QoaPcmSource  # noqa: F401

__version__ = "0.1.0"

__all__ = [
    "DecodedQoa",
    "FixedSamples",
    "FrameHeader",
    "ProcessingMode",
    "QoaDesc",
    "Streaming",
    "decode_all",
    "decode_range",
    "encode_all",
    "encode_all_batch",
    "open_and_decode_all",
    "QoaDecoder",
    "QoaEncoder",
    "QoaPcmSource",
    "QOA_FRAME_LEN",
    "QOA_HEADER_SIZE",
    "QOA_LMS_LEN",
    "QOA_MAGIC",
    "QOA_MAX_CHANNELS",
    "QOA_SLICE_LEN",
    "QOA_SLICES_PER_FRAME",
    "MAX_SLICES_PER_CHANNEL_PER_FRAME",
    "qoa_frame_size",
    "DecodeError",
    "EncodeError",
    "IncompatibleFrame",
    "InvalidChannels",
    "InvalidFrameHeader",
    "InvalidSampleRate",
    "InvalidSamples",
    "IoError",
    "NoSamples",
    "NotQoaFile",
    "QoaError",
]
