"""The PCSK cell ``pcsk-hmc``: whole tiny CPU runs (sound, and with the
timed path broken underneath), the reference's PC counts and noise against
the port's heads, the reference against the port's float64 path, and the
cell's own metric readers on a synthetic trace with known answers."""

from __future__ import annotations

import copy
import time

import numpy as np
import pytest
import torch

from benchmark.harness.calls import sub_seed
from benchmark.harness.problem import base_problem, make_problem
from benchmark.harness.problem_pcsk import build_pcsk_chain
from benchmark.harness.runner import run_cell
from benchmark.harness.spec import load_benchmark, load_cell, load_json, load_reader
from benchmark.harness.trace import WINDOW_SPAN, summarize
from benchmark.reference.posterior_pcsk import (
    PosteriorPCSK, evaluate, evaluate_u, fit_block_pcsk, pc_count,
)
from benchmark.work import counts as wc
from benchmark.work import counts_pcsk as wp

from . import test_bench_faults as faults

CELL = "pcsk-hmc"
SEED = 2**31 + 17


def tiny_pcsk_spec() -> dict:
    """``pcsk-hmc`` cut to a CPU test's size: 3 parameters, 40 design points,
    blocks of 6 and 4 observables, 16 walkers; ``npc`` and ``npc_blocks``
    from the 99% rule on that problem."""
    spec = load_cell(CELL)
    cfg = dict(copy.deepcopy(spec["config"]), ndim=3, n_design=40, blocks=[6, 4], npc=6)
    p = base_problem(cfg)
    ks, i0 = [], 0
    for nobs in cfg["blocks"]:
        ks.append(fit_block_pcsk(p["outputs"][:, i0:i0 + nobs], p["train_err"][:, i0:i0 + nobs],
                                 cfg["target_variance"])[0].shape[0])
        i0 += nobs
    cfg.update(npc=max(ks), npc_blocks=ks)
    tp = dict(spec["workload"]["traffic_params"], walkers=16, chunk_steps=3, warmup_walkers=8,
              check_calls=2, check_walkers=8)
    spec["config"] = cfg
    spec["workload"] = dict(spec["workload"], traffic_params=tp)
    return spec


def _run(spec=None, trace=False):
    return run_cell(spec or tiny_pcsk_spec(), SEED, 0.3, trace, torch.device("cpu"),
                    time.perf_counter())


def test_the_cell_loads_by_name():
    spec = load_cell(CELL)
    cfg = spec["config"]
    assert spec["workload"]["driver"] == "hmc_pcsk" and spec["entry"]["chips"] == 1
    assert (cfg["ndim"], cfg["n_design"], cfg["blocks"]) == (
        20, 1095, load_json("configs", "auau-bes")["blocks"])
    assert cfg["npc_blocks"] == [24, 23, 11, 88, 13, 19, 24, 48, 88] and cfg["npc"] == 88
    assert (cfg["method"], cfg["kernel"], cfg["target_variance"]) == ("PCSK", "Matern", 0.99)
    assert cfg["reduced"] == [] and cfg["hyper_ranges"] and cfg["hyper_source"]
    assert spec["workload"]["traffic_params"] == load_json(
        "workloads", "bes-hmc")["traffic_params"]
    assert set(spec["readers"]) == {m["name"] for m in spec["per_layer"]}
    assert [m["name"] for m in spec["end_to_end"]] == ["hmc_samples_per_s", "setup_s"]


def test_the_configuration_names_a_source_of_its_own():
    """A deployment is told from the others by its source and its cuts: the
    PCSK heads' source is the file that defines them, not the flagship's."""
    configs = load_benchmark()["configs"]
    entry = next(c for c in configs if c["name"] == "auau-bes-pcsk")
    assert entry["source"] == load_json("configs", "auau-bes-pcsk")["source"]
    assert entry["source"].endswith("/src/emulator_BAND.py")
    for other in configs:
        if other is not entry:
            assert (other["source"], other["reduced"]) != (entry["source"], entry["reduced"])


def test_the_published_problem_keeps_the_configured_pcs():
    """The reference's 99% rule on the configuration's problem gives
    ``npc_blocks``, for any seed's permutation."""
    cfg = load_json("configs", "auau-bes-pcsk")
    for seed in (0, SEED):
        p = make_problem(cfg, seed)
        ks, i0 = [], 0
        for nobs in cfg["blocks"]:
            z = fit_block_pcsk(p["outputs"][:, i0:i0 + nobs], p["train_err"][:, i0:i0 + nobs],
                               cfg["target_variance"])[0]
            ks.append(z.shape[0])
            i0 += nobs
        assert ks == cfg["npc_blocks"]


def test_pc_count_rule():
    ev = np.array([90.0, 8.0, 1.5, 0.5])          # cumulative 0.90, 0.98, 0.995, 1
    assert pc_count(ev, 0.99) == 3
    assert pc_count(ev, 0.98) == 3                 # the ratio must exceed the target
    assert pc_count(ev, 0.999999) == 4


def test_reference_pcs_and_noise_equal_the_port_heads(tmp_path):
    spec = tiny_pcsk_spec()
    cfg = spec["config"]
    problem = make_problem(cfg, sub_seed(SEED, 0))
    chain = build_pcsk_chain(problem, cfg, str(tmp_path), torch.device("cpu"), "auto",
                             dtype=torch.float64)
    ref = PosteriorPCSK(problem, cfg)
    assert [e._npc_used for e in chain.emuList] == ref.npcs == cfg["npc_blocks"]
    i0 = 0
    for e, nobs in zip(chain.emuList, cfg["blocks"]):
        _, var_z, _, _, _ = fit_block_pcsk(problem["outputs"][:, i0:i0 + nobs],
                                           problem["train_err"][:, i0:i0 + nobs],
                                           cfg["target_variance"])
        port = e._pc_noise_diag(np.ones(e.nev, dtype=bool), e._npc_used).numpy()
        np.testing.assert_allclose(port, var_z, rtol=1e-9)
        assert e.gp_config.kernel.kind == "Matern" and e.gp_alpha == cfg["gp_alpha"]
        i0 += nobs


def test_a_wrong_pc_count_is_refused(tmp_path):
    spec = tiny_pcsk_spec()
    cfg = dict(spec["config"], npc_blocks=[k + 1 for k in spec["config"]["npc_blocks"]])
    problem = make_problem(cfg, sub_seed(SEED, 0))
    with pytest.raises(AssertionError, match="PCs"):
        build_pcsk_chain(problem, cfg, str(tmp_path), torch.device("cpu"), "auto")


def test_reference_matches_the_port_in_float64(tmp_path):
    from gpbayestools_hic_tpu_torch.samplers.hmc import make_value_and_grad

    spec = tiny_pcsk_spec()
    cfg = spec["config"]
    problem = make_problem(cfg, sub_seed(SEED, 0))
    chain = build_pcsk_chain(problem, cfg, str(tmp_path), torch.device("cpu"), "auto",
                             dtype=torch.float64)
    rng = np.random.default_rng(3)
    x = rng.uniform(0.02, 0.98, (48, cfg["ndim"]))
    x[0, 0] = 1.2
    port = chain.log_posterior(x)
    ref = PosteriorPCSK(problem, cfg)
    want = evaluate(ref, torch.as_tensor(x), rows=16)
    assert np.isneginf(port[0]) and np.isneginf(want[0])
    np.testing.assert_allclose(want[1:], port[1:], rtol=1e-9, atol=1e-8)
    fn, state = chain.posterior_with_state()
    d = cfg["ndim"]
    tf = {"mu": torch.as_tensor(rng.normal(size=d) * 0.3),
          "chol": torch.as_tensor(np.eye(d) * 0.8), "lo": torch.zeros(d, dtype=torch.float64),
          "width": torch.ones(d, dtype=torch.float64)}
    u = torch.as_tensor(rng.normal(size=(24, d)))
    _, lp_x, g = make_value_and_grad(fn, state, tf, True)(u)
    _, r_x, r_g = evaluate_u(ref, u, tf["mu"], tf["chol"], rows=8)
    np.testing.assert_allclose(r_x, lp_x.numpy(), rtol=1e-9, atol=1e-8)
    np.testing.assert_allclose(r_g, g.numpy(), rtol=1e-7, atol=1e-7)


def test_a_sound_tiny_run_is_correct():
    out = _run()
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"hmc_samples_per_s", "setup_s"}
    assert out["checks"]["lp_gap"]["value"] < 1e-3


def test_a_traced_tiny_run_reports_its_layers():
    """``--trace 1`` on the CPU: no device events, so the rooflines stay
    silent and the fused forward's share reads 0."""
    out = _run(trace=True)
    m = out["metrics"]
    assert m["device_idle.pcsk"]["value"] == pytest.approx(100.0)
    assert m["matern_share.pcsk"]["value"] == 0.0
    assert "kernels_per_step.pcsk" in m and "mfu.pcsk" in m
    assert "predict_roofline.pcsk" not in m and "kstar_roofline.pcsk" not in m
    assert out["correct"]


@pytest.mark.parametrize("fault", ["unchanged_state", "half_walkers_unmoved", "half_batch",
                                   "altered_answer"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    """test_bench_faults.py's four faults, in this cell."""
    if fault == "unchanged_state":
        faults._unchanged_state(monkeypatch, "bes-hmc")
    elif fault == "half_walkers_unmoved":
        faults._half_unmoved(monkeypatch, "bes-hmc")
    else:
        faults._likelihood_patch(monkeypatch, "bes-hmc",
                                 faults._half_batch if fault == "half_batch" else faults._altered)
    out = _run()
    assert not out["correct"], out["checks"]
    if fault == "half_walkers_unmoved":
        assert out["checks"]["stuck_share"]["value"] >= 0.5, out["checks"]


MS = 1_000_000  # ns


def _summary(calls):
    """A 10 ms window: the Matern pre-pass 1-2 ms, the forward 2-4 ms, the
    fast backward 4-7 ms, an RBF pre-pass 8-9 ms (another cell's family)."""
    ev = [(WINDOW_SPAN, False, 0, 10 * MS, 1),
          ("void (anonymous namespace)::kstar_kernel<1>(float const*)", True, 1 * MS, 2 * MS, -1),
          ("void (anonymous namespace)::fwd_wgmma_kernel<2>(float*)", True, 2 * MS, 4 * MS, -1),
          ("void (anonymous namespace)::bwd_wgmma_kernel<2>(float*)", True, 4 * MS, 7 * MS, -1),
          ("void (anonymous namespace)::kstar_kernel<0>(float const*)", True, 8 * MS, 9 * MS, -1)]
    s = summarize(ev)
    cfg = {"n_design": 50, "ndim": 3, "npc": 5, "npc_blocks": [2, 5], "blocks": [4, 6]}
    s.update(steps=4, calls=calls, walkers=8, acceptance=0.75, config=cfg,
             traffic={"walkers": 8})
    return s, cfg


def test_the_readers_on_a_known_trace():
    calls = {(8, True): 3, (16, False): 1}
    s, cfg = _summary(calls)
    read = {name: load_reader(name).read for name in (
        "predict_roofline.pcsk", "kstar_roofline.pcsk", "matern_share.pcsk", "mfu.pcsk",
        "kernels_per_step.pcsk", "device_idle.pcsk")}
    predict = kstar = other = wc.Work()
    for (m, grad), count in calls.items():
        for k in (2, 5):
            predict = predict + wp.predict_work(k, 50, m, 3, grad).scaled(count)
            kstar = kstar + wp.kstar_work(k, 50, m, 3, grad).scaled(count)
            other = other + wc.woodbury_work(m, k).scaled(count)
    # the four fused kernels ran 1 + 2 + 3 + 1 ms, the pre-passes 2 ms
    assert read["predict_roofline.pcsk"](s) == pytest.approx(
        100 * wc.least_seconds(predict) / 0.007)
    assert read["kstar_roofline.pcsk"](s) == pytest.approx(100 * wc.least_seconds(kstar) / 0.002)
    assert read["mfu.pcsk"](s) == pytest.approx(
        100 * wc.least_seconds(predict + other) / 0.010)
    # one Matern pre-pass over 2 blocks x 4 calls
    assert read["matern_share.pcsk"](s) == pytest.approx(100 / 8)
    assert read["kernels_per_step.pcsk"](s) == pytest.approx(4 / 4)
    assert read["device_idle.pcsk"](s) == pytest.approx(30.0)
    s["kernels"] = {}
    assert read["predict_roofline.pcsk"](s) is None and read["kstar_roofline.pcsk"](s) is None
    assert read["matern_share.pcsk"](s) == 0.0


def test_the_work_counts_by_hand():
    # b=1 GP, n=2 training points, m=1 query, d=1: Matern's k* is 4 more
    # operations an element than RBF's, 6 with the weight
    f = wp.predict_work(1, 2, 1, 1, False)
    assert f == wc.fwd_work(1, 2, 1, 1) + wc.Work(0.0, 2 * 4, 0.0)
    g = wp.predict_work(1, 2, 1, 1, True)
    assert g == wc.fwd_work(1, 2, 1, 1) + wc.bwd_work(1, 2, 1, 1) + wc.Work(0.0, 2 * 6, 0.0)
    k = wp.kstar_work(1, 2, 1, 1, True)
    assert k.flops_tf32 == 2 * (3 + 6 + 2)
    # xs 2, query 1, inv_ls 1, amp 1; k* and w 2 each
    assert k.nbytes == 4 * (2 + 1 + 1 + 1 + 2 * 2)
    assert wp.block_npcs({"npc": 4, "blocks": [3, 5]}) == [4, 4]
    parts = wp.posterior_work({"n_design": 5, "ndim": 2, "npc": 3, "npc_blocks": [1, 3],
                               "blocks": [3, 4]}, 6, True)
    assert parts["other"] == wc.woodbury_work(6, 1) + wc.woodbury_work(6, 3)
    assert parts["predict"] == wp.predict_work(1, 5, 6, 2, True) + wp.predict_work(3, 5, 6, 2,
                                                                                    True)
