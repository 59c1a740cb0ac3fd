"""Test configuration.

Tests run on the plain SINGLE-device CPU client.  Do NOT provision a
multi-device virtual CPU client here: on a 1-core host the multi-device
CPU client costs ~1 ms of cross-thread handoff PER XLA OP (measured:
the encoder slice body runs in 0.3 ms on the 1-device client and ~1,300 ms
on the 8-device client), which made round 1's suite unrunnable.
Multi-device sharding semantics are tested on a 1-device mesh in-process,
and on a real virtual 8-device client in a SUBPROCESS with a tiny graph
(tests/test_parallel.py::test_multichip_dryrun_subprocess, which drives
the same code path the driver's dryrun uses).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# The suite runs on the CPU backend unless QOA_TEST_GPU=1 keeps the
# process's own platform (``pytest -m gpu`` on a machine with a card, or
# chip_smoke.py, which runs the gpu-marked tests in its own process).
import jax

if not os.environ.get("QOA_TEST_GPU"):
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

# The real fixture ships IN this repo (analog of the reference's
# include_bytes!, src/lib.rs:996) so the SHA-256 goldens in test_native.py
# run everywhere; QOA_FIXTURE overrides for experiments.
FIXTURE_PATH = os.environ.get(
    "QOA_FIXTURE",
    os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "fixtures",
        "julien_baker_sprained_ankle.qoa",
    ),
)

# Fixture geometry, independently verified by a frame walk (see SURVEY.md §0).
FIXTURE_SAMPLES_PER_CHANNEL = 2_394_122
FIXTURE_CHANNELS = 2
FIXTURE_SAMPLE_RATE = 44_100
FIXTURE_FRAMES = 468
FIXTURE_LAST_FRAME_SAMPLES = 3_082


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Tests marked ``gpu`` run the GPU kernels as compiled for the card
    (a Triton kernel has no CPU lowering); elsewhere they skip.  Decided
    here, per test, never at import."""
    if request.node.get_closest_marker("gpu") is None:
        return
    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(
            f"needs an NVIDIA GPU (platform is {platform!r}); run "
            "`QOA_TEST_GPU=1 pytest -m gpu` or `python chip_smoke.py` on the card"
        )


@pytest.fixture(scope="session")
def fixture_bytes(tmp_path_factory):
    """Real reference fixture, or a synthesized stand-in with IDENTICAL
    geometry (stereo 44.1 kHz, 2,394,122 samples/channel => 468 frames,
    3,082-sample tail) so CI without the reference mount still runs every
    fixture-driven test.  Golden-hash tests detect the stand-in themselves.
    """
    if os.path.exists(FIXTURE_PATH):
        with open(FIXTURE_PATH, "rb") as f:
            return f.read()
    from qoaudio_tpu import codec, native
    from qoaudio_tpu.types import QoaDesc

    if not native.available():
        pytest.skip("no reference fixture and no native engine to synthesize")
    cache = tmp_path_factory.getbasetemp() / "synthetic_fixture.qoa"
    if cache.exists():
        return cache.read_bytes()
    n = FIXTURE_SAMPLES_PER_CHANNEL
    t = np.arange(n) / float(FIXTURE_SAMPLE_RATE)
    rng = np.random.default_rng(2026)
    sig = (
        np.sin(2 * np.pi * 220.0 * t) * 9000
        + np.sin(2 * np.pi * 1313.0 * t) * 3000
        + rng.normal(0, 400, n)
    )
    pcm = np.stack([sig, np.roll(sig, 5)], -1).reshape(-1).astype(np.int16)
    data = codec.encode_all(
        pcm, QoaDesc(FIXTURE_CHANNELS, FIXTURE_SAMPLE_RATE, n), backend="native"
    )
    cache.write_bytes(data)
    return data


def make_sine(samples_per_channel, channels=1, freq=440.0, rate=44100):
    """Deterministic test signal: sine (+ cosine for ch 2, etc.)."""
    t = np.arange(samples_per_channel, dtype=np.float64) / rate
    chans = []
    for c in range(channels):
        phase = c * np.pi / 2
        chans.append(
            (np.sin(2 * np.pi * freq * t + phase) * 16384.0).astype(np.int16)
        )
    return np.stack(chans, axis=-1).reshape(-1)  # interleaved


def make_noise(samples_per_channel, channels=1, seed=0, amplitude=30000):
    rng = np.random.default_rng(seed)
    return rng.integers(
        -amplitude, amplitude, size=samples_per_channel * channels
    ).astype(np.int16)


@pytest.fixture
def sine_mono():
    return make_sine(4410, 1)


@pytest.fixture
def sine_stereo():
    return make_sine(4410, 2)
