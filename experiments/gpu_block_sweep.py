"""Block-size and width sweep of the GPU encode kernel against XLA.

Needs one NVIDIA GPU.  Block sweep: the fixture's first 16 frames
replicated over 2,048 chains; for each block size, compile seconds,
median device milliseconds of 5 runs after a warm-up
(``block_until_ready``), and mismatched elements against the XLA kernel.
Width sweep (``--widths``): 4 frames at 2,048-65,536 chains with the
default block, to find where the kernel's time starts to grow with the
chain count (the marginal cost per padded lane-frame that the length
bucketing model in parallel/corpus.py charges).  (The GPU decode kernel
this sweep also covered gained nothing end to end and was removed; its
numbers are in PERF.md.)

    python experiments/gpu_block_sweep.py [--widths]
"""

import os
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from qoaudio_tpu.utils.device import enable_compile_cache, nvidia_smi, require_gpu  # noqa: E402

FIXTURE = os.path.join(ROOT, "tests", "fixtures", "julien_baker_sprained_ankle.qoa")


def timed(jitted, args, runs=5, **static):
    import jax

    t0 = time.perf_counter()
    compiled = jitted.lower(*args, **static).compile()
    compile_s = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))
    ts = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        ts.append(time.perf_counter() - t0)
    return out, compile_s, statistics.median(ts), compiled


def mismatches(a, b):
    import jax.numpy as jnp

    return sum(int(jnp.sum(x != y)) for x, y in zip(a, b))


def main(widths=False):
    enable_compile_cache()
    devices = require_gpu()
    import jax

    print(f"{devices[0].device_kind} x{len(devices)}; nvidia-smi: {nvidia_smi()}")
    from qoaudio_tpu import codec
    from qoaudio_tpu.ops import pallas_encode as pe
    from qoaudio_tpu.ops.encode import encode_frames, initial_encoder_state

    data = open(FIXTURE, "rb").read()
    out = codec.decode_all(data)
    x, lens, _ = codec.layout_pcm(out.samples, 2, out.samples_per_channel)
    if widths:
        F = 4
        prev = None
        for N in (2048, 8192, 16384, 32768, 65536):
            xp = jax.device_put(np.repeat(x[:F], N // 2, axis=3))
            lp = jax.device_put(np.repeat(lens[:F, :, None].astype(np.int32), N, axis=2))
            st = jax.device_put(initial_encoder_state(2, N))
            _, ct, t, _ = timed(pe.encode_frames_pallas, (st, xp, lp))
            marginal = "" if prev is None else (
                f", marginal {(t - prev[1]) / (F * (N - prev[0])) * 1e9:.2f} ns "
                "per added lane-frame"
            )
            print(f"encode pallas {F} frames x {N} chains: compile {ct:.1f} s, "
                  f"{t*1e3:.3f} ms, {t / (F * N) * 1e9:.2f} ns per lane-frame{marginal}")
            prev = (N, t)
            del xp, lp, st
        return
    N, F = 2048, 16
    xp = jax.device_put(np.repeat(x[:F], N // 2, axis=3))
    lp = jax.device_put(np.repeat(lens[:F, :, None].astype(np.int32), N, axis=2))
    st = jax.device_put(initial_encoder_state(2, N))
    args = (st, xp, lp)
    ref, ct, t, _ = timed(encode_frames, args)
    print(f"encode xla: compile {ct:.1f} s, {t*1e3:.3f} ms")
    for b in (2, 4, 8, 16, 32):
        try:
            got, ct, t, _ = timed(pe.encode_frames_pallas, args, block=b)
            print(f"encode pallas block={b}: compile {ct:.1f} s, {t*1e3:.3f} ms, "
                  f"mismatches {mismatches(got, ref)}")
        except Exception as e:  # a block the compiler refuses is a result
            print(f"encode pallas block={b}: FAILED {type(e).__name__}: {str(e)[:1500]}")


if __name__ == "__main__":
    main(widths="--widths" in sys.argv[1:])
