"""PyTorch port: HMC on known targets, and the small numeric helpers
(kernels, linalg, metrics) against the JAX package.  CPU, float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpbayestools_hic_tpu.ops import kernels as jk
from gpbayestools_hic_tpu.ops import linalg as jl
from gpbayestools_hic_tpu.utils import metrics as jm
from gpbayestools_hic_tpu_torch.ops import kernels as pk
from gpbayestools_hic_tpu_torch.ops import linalg as pl
from gpbayestools_hic_tpu_torch.samplers.hmc import run_hmc
from gpbayestools_hic_tpu_torch.utils import metrics as pm

CPU64 = dict(device="cpu", dtype=torch.float64)
MEAN = np.array([1.0, -2.0])
STD = np.array([0.5, 2.0])


def _gauss(x):
    m = torch.tensor(MEAN, dtype=x.dtype)
    s = torch.tensor(STD, dtype=x.dtype)
    return -0.5 * (((x - m) / s) ** 2).sum(-1)


def _check_moments(res, mean, std, ess_floor=500):
    """Mean and variance within 5 Monte-Carlo standard errors, the errors
    taken from the spread of the per-walker estimates (the walkers are
    independent chains, so this holds whatever the autocorrelation)."""
    chain = res.chain
    assert pm.effective_sample_size(chain) > ess_floor
    nw = chain.shape[0]
    w_mean = chain.mean(1)
    w_var = chain.var(1)
    se_mean = w_mean.std(0, ddof=1) / np.sqrt(nw)
    se_var = w_var.std(0, ddof=1) / np.sqrt(nw)
    assert np.all(np.abs(w_mean.mean(0) - mean) < 5 * se_mean), (w_mean.mean(0), mean, se_mean)
    assert np.all(np.abs(w_var.mean(0) - std**2) < 5 * se_var), (w_var.mean(0), std**2, se_var)


@pytest.mark.parametrize("scheme,persist", [("mh", 0.0), ("windowed", 0.0),
                                            ("windowed", 0.7), ("multinomial", 0.0)])
def test_hmc_gaussian_moments(scheme, persist):
    """Every production kernel reproduces a known Gaussian's moments."""
    x0 = np.random.default_rng(0).normal(size=(64, 2)) * 0.1
    res = run_hmc(_gauss, x0, 200, seed=1, warmup=64, scheme=scheme,
                  persist=persist, **CPU64)
    assert res.chain.shape == (64, 200, 2) and res.scheme == scheme
    _check_moments(res, MEAN, STD)


def test_hmc_bounded_box_matches_truncated_target():
    """Sigmoid reparametrization: a flat target on a box gives uniform
    draws inside it (mean and variance of U(lo, hi) per coordinate)."""
    lo, hi = np.array([0.0, -1.0]), np.array([1.0, 3.0])
    x0 = np.random.default_rng(2).uniform(lo, hi, size=(64, 2))
    res = run_hmc(lambda x: torch.zeros(x.shape[0], dtype=x.dtype), x0, 200,
                  seed=3, lo=lo, hi=hi, warmup="auto", scheme="auto", **CPU64)
    assert np.all((res.chain > lo) & (res.chain < hi))
    _check_moments(res, (lo + hi) / 2, (hi - lo) / np.sqrt(12.0), ess_floor=300)


def test_hmc_warmup_walkers_and_determinism():
    x0 = np.random.default_rng(4).normal(size=(32, 2))
    a = run_hmc(_gauss, x0, 20, seed=5, warmup=16, warmup_walkers=8, **CPU64)
    b = run_hmc(_gauss, x0, 20, seed=5, warmup=16, warmup_walkers=8, **CPU64)
    c = run_hmc(_gauss, x0, 20, seed=6, warmup=16, warmup_walkers=8, **CPU64)
    np.testing.assert_array_equal(a.chain, b.chain)
    assert not np.array_equal(a.chain, c.chain)
    assert a.warmup_steps == 32 and a.chain.shape == (32, 20, 2)


@pytest.mark.parametrize("kw,match", [
    (dict(scheme="nuts"), "scheme"),
    (dict(persist=0.5, scheme="mh"), "persist"),
    (dict(scheme="windowed", window=5, n_leapfrog=8), "window"),
    (dict(warmup=0), "warmup"),
    (dict(warmup_walkers=0), "warmup_walkers"),
])
def test_hmc_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        run_hmc(_gauss, np.zeros((4, 2)), 2, **{"warmup": 2, **kw}, **CPU64)


def test_kernels_match_jax():
    """RBF and Matern-1.5 Gram matrices (self and cross) and the diagonal,
    f64 to 1e-12 (direct differences vs the JAX expansion: same value up to
    roundoff at these O(1) distances)."""
    rng = np.random.default_rng(0)
    x, y = rng.uniform(size=(9, 3)), rng.uniform(size=(5, 3))
    params = {"log_amp": np.log(1.3), "log_ls": np.log([0.4, 0.9, 1.7]),
              "log_noise": np.log(0.05)}
    tp = {k: torch.tensor(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    for kind in ("RBF", "Matern"):
        cfg_p, cfg_j = pk.KernelConfig(kind), jk.KernelConfig(kind)
        np.testing.assert_allclose(pk.kernel_fn(tp, torch.tensor(x), config=cfg_p).numpy(),
                                   np.asarray(jk.kernel_fn(jp, x, config=cfg_j)), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(
            pk.kernel_fn(tp, torch.tensor(x), torch.tensor(y), config=cfg_p).numpy(),
            np.asarray(jk.kernel_fn(jp, x, y, config=cfg_j)), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(pk.kernel_diag(tp, torch.tensor(x)).numpy(),
                               np.asarray(jk.kernel_diag(jp, x)), rtol=1e-14)
    lo, hi = pk.default_bounds(np.array([1.0, 2.0]))
    jlo, jhi = jk.default_bounds(np.array([1.0, 2.0]))
    for k in lo:
        np.testing.assert_allclose(lo[k].numpy(), np.asarray(jlo[k]))
        np.testing.assert_allclose(hi[k].numpy(), np.asarray(jhi[k]))


def test_linalg_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(6, 4, 4))
    s = a @ np.swapaxes(a, 1, 2) + np.eye(4)
    z = rng.normal(size=(6, 4))
    q, ld = pl.spd_qform_logdet(torch.tensor(s), torch.tensor(z))
    jq, jld = jl.spd_qform_logdet(jnp.asarray(s), jnp.asarray(z))
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=1e-12)
    np.testing.assert_allclose(ld.numpy(), np.asarray(jld), rtol=1e-12)
    q40, ld40 = pl.spd_qform_logdet(torch.tensor(s), torch.tensor(z), max_unroll=2)
    np.testing.assert_allclose(q40.numpy(), np.asarray(jq), rtol=1e-10)
    np.testing.assert_allclose(ld40.numpy(), np.asarray(jld), rtol=1e-10)
    # non-PD input: NaN, never an exception
    bad = s.copy()
    bad[0] = -np.eye(4)
    qb, _ = pl.spd_qform_logdet(torch.tensor(bad), torch.tensor(z))
    assert np.isnan(qb[0].item()) and np.isfinite(qb[1:].numpy()).all()
    # jitter rescue per matrix (a singular PSD matrix gets the bump)
    sing = np.stack([s[0], np.ones((4, 4))])
    c = pl.cholesky_jittered(torch.tensor(sing)).numpy()
    jc = np.asarray(jl.cholesky_jittered(jnp.asarray(sing)))
    np.testing.assert_allclose(c, jc, rtol=1e-10, atol=1e-12)
    y, var = rng.normal(size=(5, 7)), rng.uniform(0.1, 1, size=(5, 7))
    var[0, 0] = -1.0
    got = pl.mvn_loglike_diagcov_batch(torch.tensor(y), torch.tensor(var)).numpy()
    want = np.asarray(jl.mvn_loglike_diagcov_batch(jnp.asarray(y), jnp.asarray(var)))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert got[0] == -np.inf


def test_metrics_match_jax():
    """Own copy of the convergence diagnostics: identical numbers."""
    rng = np.random.default_rng(2)
    chain = np.cumsum(rng.normal(size=(8, 400, 3)), axis=1) * 0.05 + rng.normal(size=(8, 400, 3))
    a, b = pm.convergence_diagnostics(chain), jm.convergence_diagnostics(chain)
    for k in ("rhat", "tau", "tau_converged"):
        np.testing.assert_array_equal(a[k], b[k])
    assert a["ess"] == b["ess"] and a["converged"] == b["converged"]
    assert pm.effective_sample_size(chain) == jm.effective_sample_size(chain)
    np.testing.assert_array_equal(pm.split_rhat(chain), jm.split_rhat(chain))
