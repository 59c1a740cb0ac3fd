"""The bench harness's self-validating measurement machinery.

The device numbers the driver records come out of ``bench.py``'s
linearity-gated slope fits and the per-section subprocess orchestration;
both carry enough policy (acceptance thresholds, per-metric merge,
retry queueing, fragment salvage) to deserve pinning on CPU: a timing
loop that synced after every launch once floored every decode
measurement at the per-launch round trip and mislabeled a fast kernel
as a "structural bottleneck" for a whole round.  These tests keep the
guard rails from regressing.
"""

import sys

import pytest

sys.path.insert(0, __file__.rsplit("/tests/", 1)[0])

import bench  # noqa: E402


# ---------------------------------------------------------------------------
# fit_launch_slope: the linearity gate
# ---------------------------------------------------------------------------


def test_fit_accepts_linear_positive_slope():
    # ideal session: time = slope*K + round-trip intercept
    per, bound = bench.fit_launch_slope(
        lambda K: 0.004 * K + 0.030, (2, 8, 16, 24), 3e-4, "t"
    )
    assert per == pytest.approx(0.004, rel=1e-6)
    # bound is the whole-chain average at the largest K (RTT-inclusive)
    assert bound == pytest.approx((0.004 * 24 + 0.030) / 24, rel=1e-6)


def test_fit_rejects_constant_times():
    # batching pathology: chain time independent of K
    per, bound = bench.fit_launch_slope(
        lambda K: 0.050, (2, 8, 16, 24), 3e-4, "t", tries=2
    )
    assert per is None
    assert bound == pytest.approx(0.050 / 24, rel=1e-6)


def test_fit_rejects_negative_slope():
    per, _ = bench.fit_launch_slope(
        lambda K: 0.100 - 0.002 * K, (2, 8, 16), 3e-4, "t", tries=1
    )
    assert per is None


def test_fit_rejects_below_plausibility_floor():
    # a positive but sub-floor slope (e.g. 0.1 ms/launch where the kernel
    # cannot physically run that fast) must not be accepted
    per, _ = bench.fit_launch_slope(
        lambda K: 1e-4 * K + 0.030, (2, 8, 16, 24), 3e-4, "t", tries=1
    )
    assert per is None


def test_fit_rejects_nonlinear_then_accepts_clean_rep():
    # first rep noisy/nonlinear, second rep clean: the re-rep must save it
    calls = {"n": 0}

    def chain(K):
        calls["n"] += 1
        if calls["n"] <= 4:  # first rep: 4 Ks of garbage (non-monotone)
            return [0.05, 0.01, 0.09, 0.02][(calls["n"] - 1) % 4]
        return 0.004 * K + 0.030

    per, _ = bench.fit_launch_slope(chain, (2, 8, 16, 24), 3e-4, "t")
    assert per == pytest.approx(0.004, rel=1e-6)


# ---------------------------------------------------------------------------
# _run_device_sections: per-section orchestration
# ---------------------------------------------------------------------------


def _patch_sections(monkeypatch, script):
    """script: {section: [fragments_attempt1, fragments_attempt2, ...]}"""
    seen = {name: 0 for name in script}

    def fake(section, timeout):
        i = min(seen[section], len(script[section]) - 1)
        seen[section] += 1
        return script[section][i]

    monkeypatch.setattr(bench, "_device_subprocess", fake)
    monkeypatch.setattr(bench.time, "sleep", lambda s: None)
    return seen


def test_sections_merge_and_no_retry_when_healthy(monkeypatch):
    seen = _patch_sections(
        monkeypatch,
        {
            "decode": [[{"decode_batched_msps": 51000.0}]],
            "transcode": [
                [
                    {"transcode_hbm_msps": 45.0,
                     "transcode_hbm_vs_baseline": 1.33},
                    {"transcode_chip_msps": 480.0},
                ]
            ],
            "encode": [[{"_headline": 4200.0}, {"encode_xla_msps": 900.0}]],
            "saturated": [
                [
                    {"transcode_saturated_msps": 6.0},
                    {"transcode_saturated_chip_msps": 2700.0},
                ]
            ],
        },
    )
    headline, extra = bench._run_device_sections()
    assert headline == 4200.0
    assert extra["decode_batched_msps"] == 51000.0
    assert extra["transcode_chip_msps"] == 480.0
    assert extra["transcode_saturated_chip_msps"] == 2700.0
    assert all(v == 1 for v in seen.values())  # healthy: one attempt each


def test_below_par_section_retries_once_and_keeps_best(monkeypatch):
    seen = _patch_sections(
        monkeypatch,
        {
            # first attempt RTT-floored artifact, second healthy
            "decode": [
                [{"decode_batched_msps_rejected": True,
                  "decode_batched_msps_floor": 6800.0}],
                [{"decode_batched_msps": 52000.0}],
            ],
            "transcode": [[{"transcode_hbm_msps": 45.0}]],
            "encode": [[{"_headline": 4100.0}]],
            "saturated": [[{"transcode_saturated_chip_msps": 2600.0}]],
        },
    )
    headline, extra = bench._run_device_sections()
    assert seen["decode"] == 2  # exactly one retry
    assert extra["decode_batched_msps"] == 52000.0
    assert extra["decode_batched_msps_rejected"] is True  # history kept
    assert extra["decode_batched_msps_floor"] == 6800.0


def test_dead_tunnel_zeroes_nothing_else(monkeypatch):
    # encode children hang (no fragments ever); decode+transcode still land
    seen = _patch_sections(
        monkeypatch,
        {
            "decode": [[{"decode_batched_msps": 48000.0}]],
            "transcode": [[{"transcode_hbm_msps": 44.0}]],
            "encode": [[], []],
            "saturated": [[{"transcode_saturated_chip_msps": 2600.0}]],
        },
    )
    headline, extra = bench._run_device_sections()
    assert headline == 0.0
    assert seen["encode"] == 2  # retried once, then gave up
    assert extra["decode_batched_msps"] == 48000.0
    assert extra["transcode_hbm_msps"] == 44.0


def test_budget_exhaustion_skips_cleanly(monkeypatch):
    calls = []

    def fake(section, timeout):
        calls.append(section)
        return [[{"_headline": 4100.0}]][0] if section == "encode" else []

    monkeypatch.setattr(bench, "_device_subprocess", fake)
    monkeypatch.setattr(bench.time, "sleep", lambda s: None)
    monkeypatch.setenv("QOA_BENCH_DEVICE_BUDGET", "0")
    headline, extra = bench._run_device_sections()
    assert calls == []  # nothing ran
    assert headline == 0.0 and extra == {}


def test_fragment_salvage_from_partial_stdout():
    # a killed child's flushed lines must parse; trailing junk must not
    out = (
        b"devices: [CudaDevice(id=0)]\n"
        b'{"transcode_hbm_msps": 45.2, "transcode_hbm_vs_baseline": 1.33}\n'
        b'{"transcode_chip_ms'  # killed mid-write
    )
    frags = bench._parse_fragments(out)
    assert frags == [
        {"transcode_hbm_msps": 45.2, "transcode_hbm_vs_baseline": 1.33}
    ]
