"""The plain reference against the port's float64 CPU path, in every
likelihood mode, and the HMC coordinates' value and gradient."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.harness.calls import sub_seed
from benchmark.harness.problem import build_chain, make_problem
from benchmark.reference.posterior import Posterior, evaluate, evaluate_u, round_tf32

from .conftest import tiny_spec


@pytest.fixture(scope="module")
def tiny():
    spec = tiny_spec("bes-hmc")
    cfg = spec["config"]
    problem = make_problem(cfg, sub_seed(2**31 + 5, 0))
    return cfg, problem


def _points(n, d, seed):
    x = np.random.default_rng(seed).uniform(0.02, 0.98, (n, d))
    x[0, 0] = 1.2  # one walker outside the box
    return x


@pytest.mark.parametrize("mode", ["auto", "generic", "stitched"])
def test_reference_matches_the_port_in_float64(tiny, tmp_path, mode):
    cfg, problem = tiny
    chain = build_chain(problem, cfg, str(tmp_path), torch.device("cpu"), mode,
                        dtype=torch.float64)
    x = _points(64, cfg["ndim"], 1)
    port = chain.log_posterior(x)
    ref = evaluate(Posterior(problem, cfg), torch.as_tensor(x), rows=16)
    assert np.isneginf(port[0]) and np.isneginf(ref[0])
    np.testing.assert_allclose(ref[1:], port[1:], rtol=1e-9, atol=1e-8)


def test_hmc_coordinates_value_and_gradient(tiny, tmp_path):
    from gpbayestools_hic_tpu_torch.samplers.hmc import make_value_and_grad

    cfg, problem = tiny
    chain = build_chain(problem, cfg, str(tmp_path), torch.device("cpu"), "auto",
                        dtype=torch.float64)
    fn, state = chain.posterior_with_state()
    d = cfg["ndim"]
    rng = np.random.default_rng(2)
    a = rng.normal(size=(d, d))
    tf = {"mu": torch.as_tensor(rng.normal(size=d) * 0.3),
          "chol": torch.as_tensor(np.linalg.cholesky(a @ a.T / d + np.eye(d))),
          "lo": torch.zeros(d, dtype=torch.float64), "width": torch.ones(d, dtype=torch.float64)}
    u = torch.as_tensor(rng.normal(size=(32, d)))
    lp_u, lp_x, g = make_value_and_grad(fn, state, tf, True)(u)
    r_u, r_x, r_g = evaluate_u(Posterior(problem, cfg), u, tf["mu"], tf["chol"], rows=8)
    np.testing.assert_allclose(r_x, lp_x.numpy(), rtol=1e-9, atol=1e-8)
    np.testing.assert_allclose(r_u, lp_u.numpy(), rtol=1e-9, atol=1e-8)
    np.testing.assert_allclose(r_g, g.numpy(), rtol=1e-7, atol=1e-7)


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -3.0],
                     dtype=torch.float32)
    assert round_tf32(x).tolist() == [1.0 + 2.0 ** -10, 1.0, 1.0 + 2 * 2.0 ** -10, -3.0]


def test_the_control_stands_apart_from_the_program(tiny):
    """At a test's size the TF32 control is far further from the float64
    reference than the float32 port is (on the card and at the cells'
    sizes the control is run by ``run.py --control``, see PERF.md)."""
    cfg, problem = tiny
    x = torch.as_tensor(_points(64, cfg["ndim"], 3)[1:])
    ref = evaluate(Posterior(problem, cfg), x)
    f32 = evaluate(Posterior(problem, cfg, dtype=torch.float32), x.float())
    ctl = evaluate(Posterior(problem, cfg, dtype=torch.float32, tf32=True), x.float())
    assert np.max(np.abs(ctl - ref)) > 30 * np.max(np.abs(f32 - ref))


def test_every_seed_poses_the_same_problem_in_another_order(tmp_path):
    """Two seeds give permuted copies of one problem: the same posterior at
    correspondingly permuted points, the inputs themselves in another
    order."""
    from benchmark.harness.problem import base_problem

    cfg = tiny_spec("bes-ens-generic")["config"]
    a, b = make_problem(cfg, 11), make_problem(cfg, 12)
    assert not np.array_equal(a["design"], b["design"])
    base = base_problem(cfg)
    # find each seed's parameter order from the truth point
    ca = [int(np.flatnonzero(base["truth"] == t)[0]) for t in a["truth"]]
    cb = [int(np.flatnonzero(base["truth"] == t)[0]) for t in b["truth"]]
    x = np.random.default_rng(0).uniform(0.05, 0.95, (8, cfg["ndim"]))
    xa = np.empty_like(x)
    xb = np.empty_like(x)
    xa[:] = x[:, ca]
    xb[:] = x[:, cb]
    ra = evaluate(Posterior(a, cfg), torch.as_tensor(xa))
    rb = evaluate(Posterior(b, cfg), torch.as_tensor(xb))
    np.testing.assert_allclose(ra, rb, rtol=1e-9, atol=1e-8)
