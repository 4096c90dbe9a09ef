"""The trace reduction and every per-layer metric reader on a synthetic
trace whose answers are known."""

from __future__ import annotations

import pytest

from benchmark.harness.spec import load_benchmark, load_reader
from benchmark.harness.trace import WINDOW_SPAN, summarize
from benchmark.work.counts import least_seconds, posterior_work

MS = 1_000_000  # ns


def _events():
    """A 10 ms window: host span 'posterior' 0-5.5 ms with an op 'aten::mm'
    1-2 ms; on the device kstar 1-2 ms, fwd 1.5-3 ms (overlapping), a copy
    4-5 ms, an MVN kernel 7-8 ms; idle 0-1, 3-4, 5-7, 8-10 ms."""
    host, dev = 1, -1
    return [
        (WINDOW_SPAN, False, 0, 10 * MS, host),
        ("posterior", False, 0, int(5.5 * MS), host),
        ("aten::mm", False, 1 * MS, 2 * MS, host),
        ("void kstar_kernel<4>(float*)", True, 1 * MS, 2 * MS, dev),
        ("void fwd_wgmma_kernel<1, 2>(float*)", True, int(1.5 * MS), 3 * MS, dev),
        ("Memcpy DtoD (Device -> Device)", True, 4 * MS, 5 * MS, dev),
        ("void mvn_wide_kernel<2>(float*)", True, 7 * MS, 8 * MS, dev),
        ("outside", True, 11 * MS, 12 * MS, dev),
    ]


def test_summarize_takes_the_union_and_labels_the_gaps():
    s = summarize(_events())
    assert s["window_s"] == pytest.approx(0.010)
    assert s["busy_s"] == pytest.approx(0.004)     # 1-3, 4-5, 7-8 ms
    assert s["n_kernels"] == 3                     # the copy is no kernel
    assert s["kernels"]["void kstar_kernel<4>(float*)"] == [1, pytest.approx(0.001)]
    gaps = dict(s["idle_gaps"])
    assert gaps["posterior"] == pytest.approx(0.002)                       # 0-1, 3-4
    assert gaps["host outside any traced operation"] == pytest.approx(0.004)  # 5-7, 8-10
    assert dict(s["device_ops"])["Memcpy DtoD (Device -> Device)"] == pytest.approx(0.001)


def _summary(mode, calls):
    s = summarize(_events())
    cfg = {"n_design": 50, "ndim": 3, "npc": 2, "blocks": [4, 6]}
    s.update(steps=4, calls=calls, walkers=8, acceptance=0.8, config=cfg,
             traffic={"mode": mode})
    return s, cfg


def _read(name, summary):
    return load_reader(name).read(summary)


def test_every_metric_has_a_reader_that_reads():
    names = {m["name"] for m in load_benchmark()["per_layer"]}
    for name in names:
        hmc = name.endswith(".hmc")
        s, _ = _summary("auto" if hmc else "generic", {(8, hmc): 3})
        v = _read(name, s)
        assert v is not None and v >= 0, name


def test_counts_and_shares():
    s, cfg = _summary("auto", {(8, True): 3, (16, False): 1})
    assert _read("kernels_per_step.hmc", s) == pytest.approx(3 / 4)
    assert _read("kernels_per_step.ens", s) == pytest.approx(3 / 4)
    assert _read("hmc_accept.hmc", s) == pytest.approx(80.0)
    assert _read("device_idle.hmc", s) == pytest.approx(60.0)
    assert _read("device_idle.ens", s) == pytest.approx(60.0)
    w = posterior_work(cfg, "auto", 8, True)
    w1 = posterior_work(cfg, "auto", 16, False)
    pred = w["predict"].scaled(3) + w1["predict"]
    # the predict kernels ran 1 + 1.5 ms
    assert _read("predict_roofline.hmc", s) == pytest.approx(
        100 * least_seconds(pred) / 0.0025)
    total = pred + w["other"].scaled(3) + w1["other"]
    assert _read("mfu.hmc", s) == pytest.approx(100 * least_seconds(total) / 0.010)


def test_mvn_share_and_silence_without_its_kernels():
    s, cfg = _summary("stitched", {(8, False): 2})
    mvn = posterior_work(cfg, "stitched", 8, False)["mvn"].scaled(2)
    assert _read("mvn_roofline.ens", s) == pytest.approx(100 * least_seconds(mvn) / 0.001)
    s["kernels"] = {k: v for k, v in s["kernels"].items() if "mvn" not in k}
    assert _read("mvn_roofline.ens", s) is None
    s["kernels"] = {}
    s, _ = _summary("auto", {(8, True): 1})
    s["kernels"] = {}
    assert _read("predict_roofline.hmc", s) is None


@pytest.mark.parametrize("cell", ["bes-hmc", "bes-ens-generic"])
def test_a_traced_tiny_run_reports_its_layers(cell):
    """``--trace 1`` on the CPU: the trace path runs end to end (no device
    events here, so the rooflines stay silent)."""
    import time

    import torch

    from benchmark.harness.runner import run_cell

    from .conftest import tiny_spec

    out = run_cell(tiny_spec(cell), 2**31 + 21, 0.2, True, torch.device("cpu"),
                   time.perf_counter())
    suffix = cell.split("-")[1][:3]
    assert f"kernels_per_step.{suffix}" in out["metrics"]
    assert out["metrics"][f"device_idle.{suffix}"]["value"] == pytest.approx(100.0)
    assert "predict_roofline.hmc" not in out["metrics"]
    assert out["device"]["window_s"] > 0 and set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["correct"]
