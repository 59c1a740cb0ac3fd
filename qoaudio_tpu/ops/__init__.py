"""Device kernels.

``encode.py`` / ``decode.py`` hold the plain XLA forms: the reference for
the GPU encode kernel, the device path on the CPU backend, and the decode
path everywhere.  ``pallas_encode.py`` holds the GPU encode kernel
(Pallas, Triton route).
"""

from __future__ import annotations


def encode_kernel(platform):
    """The encode kernel for a JAX platform and the chain count its chain
    axis must be padded to: the GPU kernel on ``"gpu"``, the XLA kernel on
    any other platform.  Both have the contract of
    :func:`encode.encode_frames`."""
    if platform == "gpu":
        from .pallas_encode import BLOCK, encode_frames_pallas

        return encode_frames_pallas, BLOCK
    from .encode import encode_frames

    return encode_frames, 1
