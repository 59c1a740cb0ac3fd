"""Multi-file / multi-chip corpus layer (the new top layer, SURVEY.md §1).

Public surface:

* :func:`batch_encode` / :func:`batch_decode` — many files in one batched
  chain axis, optionally sharded over a ``jax.sharding.Mesh``.
* :func:`batch_transcode` — decode -> on-device re-layout -> encode with
  PCM device-resident end to end (only compressed data crosses the
  host<->device link).
* :func:`transcode_corpus` — file-level decode/re-encode/verify driver.
* :func:`make_mesh` — 1-D data-parallel mesh over the available devices.
"""

from .corpus import (  # noqa: F401
    TranscodeFusedHandle,
    TranscodeReport,
    batch_decode,
    batch_encode,
    batch_transcode,
    transcode_corpus,
)
from .mesh import make_mesh  # noqa: F401

__all__ = [
    "TranscodeFusedHandle",
    "TranscodeReport",
    "batch_decode",
    "batch_encode",
    "batch_transcode",
    "transcode_corpus",
    "make_mesh",
]
