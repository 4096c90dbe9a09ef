"""A whole run (the look for a chip skipped, tiny sizes, the CPU) with the
timed path broken underneath must come out not correct, once for each
fault a cell can have; a sound run comes out correct.  The cells run on
one chip, so the fault "the exchange between chips left out" has no place
here."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark.harness.runner import run_cell

from .conftest import CELLS, tiny_spec

SEED = 2**31 + 11


def _run(cell):
    return run_cell(tiny_spec(cell), SEED, 0.3, False, torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"


def _unchanged_state(monkeypatch, cell):
    """Each step returns the walkers as they were."""
    if cell == "bes-hmc":
        from gpbayestools_hic_tpu_torch.samplers import hmc

        def step(vg, u, p_prev, lp_u, lp_x, g, *args, **kw):
            return u, p_prev, lp_u, lp_x, g, torch.ones((), dtype=u.dtype)

        monkeypatch.setattr(hmc, "trajectory_transition", step)
    else:
        from gpbayestools_hic_tpu_torch.samplers import ensemble

        def half(active, passive, lp_active, log_prob_fn, a, move, draws):
            log_prob_fn(active)
            return active, lp_active, torch.zeros(active.shape[0], dtype=torch.bool)

        monkeypatch.setattr(ensemble, "_half_update", half)


def _half_unmoved(monkeypatch, cell):
    """Each step updates only half of the walkers: the other half keeps its
    state (the likelihood calls themselves stay right)."""
    if cell == "bes-hmc":
        from gpbayestools_hic_tpu_torch.samplers import hmc

        orig = hmc.trajectory_transition

        def step(vg, u, p_prev, lp_u, lp_x, g, *args, **kw):
            un, pn, lpn_u, lpn_x, gn, acc = orig(vg, u, p_prev, lp_u, lp_x, g, *args, **kw)
            keep = torch.arange(u.shape[0], device=u.device) >= u.shape[0] // 2
            return (torch.where(keep[:, None], u, un), pn, torch.where(keep, lp_u, lpn_u),
                    torch.where(keep, lp_x, lpn_x), torch.where(keep[:, None], g, gn), acc)

        monkeypatch.setattr(hmc, "trajectory_transition", step)
    else:
        from gpbayestools_hic_tpu_torch.samplers import ensemble

        orig = ensemble._half_update
        calls = [0]

        def half(active, passive, lp_active, log_prob_fn, a, move, draws):
            out = orig(active, passive, lp_active, log_prob_fn, a, move, draws)
            calls[0] += 1
            if calls[0] % 2 == 0:  # a step's second half stays where it was
                return active, lp_active, torch.zeros_like(out[2])
            return out

        monkeypatch.setattr(ensemble, "_half_update", half)


def _likelihood_patch(monkeypatch, cell, alter):
    """Wrap where the program produces each block's likelihood terms."""
    from gpbayestools_hic_tpu_torch.samplers import chain

    if cell == "bes-hmc":
        orig = chain.spd_qform_logdet

        def qform_logdet(s, z):
            quad, logdet = orig(s, z)
            return alter(quad), logdet

        monkeypatch.setattr(chain, "spd_qform_logdet", qform_logdet)
    else:
        orig = chain.mvn_loglike_best
        monkeypatch.setattr(chain, "mvn_loglike_best", lambda y, cov: alter(orig(y, cov)))


def _half_batch(x):
    """Half of the batch left out, the mean of the rest in its place."""
    h = x.shape[0] // 2
    return torch.cat([x[:h], x[:h].mean().expand(x.shape[0] - h)])


def _altered(x):
    """One answer in eight altered where it is produced."""
    bump = torch.zeros_like(x)
    bump[::8] = 2.0
    return x + bump


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged_state", "half_walkers_unmoved", "half_batch",
                                   "altered_answer"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    if fault == "unchanged_state":
        _unchanged_state(monkeypatch, cell)
    elif fault == "half_walkers_unmoved":
        _half_unmoved(monkeypatch, cell)
    else:
        _likelihood_patch(monkeypatch, cell, _half_batch if fault == "half_batch" else _altered)
    out = _run(cell)
    assert not out["correct"], out["checks"]
    if fault == "half_walkers_unmoved":
        # caught by the walkers that never moved, not by the values
        assert out["checks"]["stuck_share"]["value"] >= 0.5, out["checks"]
        assert out["checks"]["lp_gap"]["value"] <= out["checks"]["lp_gap"]["limit"]
