"""Device-mesh sharding for multi-device corpus transcode.

The QOA workload is embarrassingly parallel across files/channels
(SURVEY.md §2.2): the chain axis N of the codec kernels shards over a 1-D
``jax.sharding.Mesh`` and each device runs the kernel on its own chain
shard under ``jax.shard_map`` (for encode, the platform's kernel:
:func:`qoaudio_tpu.ops.encode_kernel`).  No collectives: chains never
talk to each other.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import encode_kernel

DATA_AXIS = "data"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D data-parallel mesh over the available (or given) devices."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (DATA_AXIS,))


def mesh_platform(mesh: Mesh) -> str:
    return mesh.devices.flat[0].platform


def _chains_last(rank: int) -> P:
    """PartitionSpec sharding only the last (chain) axis."""
    return P(*([None] * (rank - 1) + [DATA_AXIS]))


def shard_chain_arrays(mesh: Mesh, *arrays):
    """Device-put arrays with their last axis sharded across the mesh.

    The chain axis must be divisible by the mesh size (pad first).
    """
    return tuple(
        jax.device_put(a, NamedSharding(mesh, _chains_last(np.ndim(a))))
        for a in arrays
    )


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def encode_multiple(mesh: Mesh) -> int:
    """Encode chain-axis padding multiple for a mesh: the kernel's own
    multiple on every device."""
    return encode_kernel(mesh_platform(mesh))[1] * mesh.size


_WORDS = P(None, DATA_AXIS, None)  # (W, N, 2) raw slice words


@functools.lru_cache(maxsize=16)
def _sharded(mesh: Mesh, op: str):
    """One jitted ``shard_map`` per mesh and op, so repeated calls reuse
    the compiled executable."""
    if op == "encode":
        fn, _ = encode_kernel(mesh_platform(mesh))
        in_specs = (_chains_last(2), _chains_last(4), _chains_last(3))
        out_specs = (
            _chains_last(2), _chains_last(3), _chains_last(3), _chains_last(3)
        )
    else:
        from ..ops.decode import decode_chains as fn

        in_specs, out_specs = (_chains_last(2), _WORDS), _chains_last(3)
    return jax.jit(
        jax.shard_map(
            fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
            check_vma=False,
        )
    )


def encode_frames_sharded(mesh: Mesh, state, samples, lens):
    """The platform's encode kernel, one chain shard per device.

    state (8, N), samples (F, W, 20, N), lens (F, W, N); N must be a
    multiple of ``encode_multiple(mesh)``.
    """
    return _sharded(mesh, "encode")(
        *shard_chain_arrays(mesh, state, samples, lens)
    )


def decode_chains_sharded(mesh: Mesh, state, words):
    """The decode kernel, one chain shard per device.

    state (8, N), words (W, N, 2) raw slice words; N must be a multiple
    of the mesh size.  Returns (W, 20, N) sharded over N.
    """
    (state,) = shard_chain_arrays(mesh, state)
    words = jax.device_put(words, NamedSharding(mesh, _WORDS))
    return _sharded(mesh, "decode")(state, words)
