"""The dense cells' predict readers (``fused_predict_share.ens``,
``predict_roofline.ens``) on synthetic summaries whose answers are known."""

from __future__ import annotations

import pytest

from benchmark.harness.spec import load_reader
from benchmark.work.counts import least_seconds, posterior_work

CFG = {"n_design": 50, "ndim": 3, "npc": 2, "blocks": [4, 6, 5, 3, 7, 2, 8, 9, 1]}
FWD = "void fwd_wgmma_kernel<1, 2>(float const*, float*)"
KST = "void kstar_kernel<4>(float const*, float*)"


def _summary(mode, calls, kernels):
    return {"config": CFG, "calls": calls, "traffic": {"mode": mode}, "kernels": kernels,
            "window_s": 0.010, "busy_s": 0.004, "n_kernels": 0, "steps": 4}


def _read(name, summary):
    return load_reader(name).read(summary)


@pytest.mark.parametrize("mode", ["generic", "stitched"])
def test_without_fused_launches_the_share_is_zero_and_the_roofline_silent(mode):
    s = _summary(mode, {(2048, False): 5, (4096, False): 1},
                 {"void gemv2T_kernel_val<float>(float*)": [300, 0.2],
                  "void mvn_smem_kernel<128, 256>(float*)": [30, 0.1]})
    assert _read("fused_predict_share.ens", s) == 0.0
    assert _read("predict_roofline.ens", s) is None


@pytest.mark.parametrize("mode", ["generic", "stitched"])
def test_one_forward_per_emulator_and_call_reads_100(mode):
    calls = {(2048, False): 5, (4096, False): 1}
    n = len(CFG["blocks"]) * 6
    s = _summary(mode, calls, {FWD: [n, 0.003], KST: [n, 0.001]})
    assert _read("fused_predict_share.ens", s) == pytest.approx(100.0)
    s["kernels"][FWD] = [n // 2, 0.003]
    assert _read("fused_predict_share.ens", s) == pytest.approx(50.0)


@pytest.mark.parametrize("mode", ["generic", "stitched"])
def test_the_roofline_is_the_hmc_formula_under_the_cells_mode(mode):
    calls = {(2048, False): 5, (4096, False): 1}
    n = len(CFG["blocks"]) * 6
    s = _summary(mode, calls, {FWD: [n, 0.003], KST: [n, 0.001],
                               "void mvn_warp_kernel<16, 32>(float*)": [n, 0.5]})
    work = (posterior_work(CFG, mode, 2048, False)["predict"].scaled(5)
            + posterior_work(CFG, mode, 4096, False)["predict"])
    expect = 100 * least_seconds(work) / 0.004
    assert _read("predict_roofline.ens", s) == pytest.approx(expect)
    # the HMC reader counts the same kernels; its "auto" predict work is the
    # same forward, so on a gradient-free window the two agree
    assert _read("predict_roofline.hmc", s) == pytest.approx(expect)
