"""The work counts against counts made by hand at tiny shapes."""

from __future__ import annotations

import pytest

from benchmark.work import counts as wc


def test_fwd_and_bwd_by_hand():
    # b=1 GP, n=2 training points, m=1 query, d=1 parameter
    f = wc.fwd_work(1, 2, 1, 1)
    # [G; alpha] k*: G lower triangle 3 entries (2 fma each) + alpha row 2 (2 each)
    assert f.flops_16 == 2 * 3 + 2 * 2
    # qf: 2 per row of G (2 rows); k*: per entry 3 d + 2 = 5 (2 entries)
    assert f.flops_tf32 == 2 * 2 + 2 * 5
    # G 4, xs 2, query 1, inv_ls 1, alpha 2, amp 1, mean + qf 2 floats
    assert f.nbytes == 4 * (4 + 2 + 1 + 1 + 2 + 1 + 2)
    g = wc.bwd_work(1, 2, 1, 1)
    assert g.flops_16 == 2 * 3
    assert g.flops_tf32 == 2 * 2 + 2 * 7 + 3 * 2
    assert g.nbytes == 4 * (4 + 2 + 1 + 1 + 2 + 1 + 2 + 1)


def test_mvn_by_hand():
    # n = 2: pivot 0 updates 3 entries (with y) twice-flops 2*3=6, scales 2, log 2
    # pivot 1: 1*2 = 2, scale 1, log 2
    w = wc.mvn_work(1, 2)
    assert w.flops_tf32 == (2 * 3 + 2 + 2) + (1 * 2 + 1 + 2)
    assert w.nbytes == 4 * (3 + 2 + 1)
    assert wc.mvn_work(5, 2).flops == 5 * w.flops


def test_least_seconds_takes_the_longer_bound():
    ops = wc.Work(989e12, 495e12, 0.0)
    assert wc.least_seconds(ops) == pytest.approx(2.0)
    assert wc.least_seconds(wc.Work(0.0, 0.0, 3.35e12)) == pytest.approx(1.0)


@pytest.mark.parametrize("mode", ["auto", "generic", "stitched"])
def test_posterior_work_sums_the_blocks(mode):
    cfg = {"n_design": 5, "ndim": 2, "npc": 2, "blocks": [3, 4]}
    parts = wc.posterior_work(cfg, mode, 6, grad=(mode == "auto"))
    fwd = wc.fwd_work(2, 5, 6, 2)
    pred = fwd + fwd
    if mode == "auto":
        pred = pred + wc.bwd_work(2, 5, 6, 2).scaled(2)
        assert parts["mvn"] == wc.Work()
        assert parts["other"] == wc.woodbury_work(6, 2).scaled(2)
    elif mode == "generic":
        assert parts["mvn"] == wc.mvn_work(6, 3) + wc.mvn_work(6, 4)
        assert parts["other"] == wc.assembly_work(6, 2, 3) + wc.assembly_work(6, 2, 4)
    else:
        assert parts["mvn"] == wc.mvn_work(6, 7)
        assert parts["other"] == (wc.assembly_work(6, 2, 3, False) + wc.assembly_work(6, 2, 4, False)
                                  + wc.stitched_fill_work(6, 7))
    assert parts["predict"] == pred
