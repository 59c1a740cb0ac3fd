"""Process set-up shared by the GPU entry scripts (chip_smoke.py, bench.py):
the persistent compile cache, the device check, and the card's identity.
"""

from __future__ import annotations

import os
import subprocess

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``
    (a fixed path: the directory is part of the cache key)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _REPO, ".jax_cache"
    )


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`compile_cache_dir`
    (every executable is cached, however fast it compiled)."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path


def cache_stats(path: str) -> tuple[int, int]:
    """(entries, bytes) of a compile-cache directory (0, 0 if absent)."""
    n = size = 0
    for root, _, files in os.walk(path):
        for f in files:
            n += 1
            size += os.path.getsize(os.path.join(root, f))
    return n, size


def require_gpu():
    """The JAX devices, or SystemExit naming the platform found: a JAX
    whose CUDA start-up fails quietly runs on the CPU instead."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"needs an NVIDIA GPU; JAX found platform {devices[0].platform!r}"
        )
    return devices


def device_record(devices) -> dict:
    """The device as JAX reports it (platform, kind, count)."""
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def nvidia_smi() -> str:
    """``name, power.limit`` of each card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip()
