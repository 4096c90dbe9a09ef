"""PyTorch port: parallel-tempered Langevin MC against the JAX package.
CPU, float64; single steps with JAX's own draws injected, and the
sampled distribution statistically."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpbayestools_hic_tpu.samplers import ptlmc as jpt
from gpbayestools_hic_tpu_torch.samplers import ptlmc as ppt

CPU64 = dict(device="cpu", dtype=torch.float64)
MEAN = np.array([0.5, -0.3])
COV = np.array([[0.04, 0.018], [0.018, 0.09]])
PREC = np.linalg.inv(COV)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the suite runs in
    parallel worker processes, where multi-threaded torch ops on every
    worker oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lp_torch(x):
    d = x - torch.tensor(MEAN, dtype=x.dtype)
    return -0.5 * torch.einsum("bi,ij,bj->b", d, torch.tensor(PREC, dtype=x.dtype), d)


def _lp_jax(state, x):
    d = x - jnp.asarray(MEAN)
    return -0.5 * jnp.einsum("bi,ij,bj->b", d, jnp.asarray(PREC), d)


def test_temperature_ladder_equals_jax():
    temps = ppt._temperature_ladder(30, 16, 100.0)
    np.testing.assert_allclose(temps, np.asarray(jpt._temperature_ladder(30, 16, 100.0,
                                                                         jnp.float64)),
                               rtol=1e-15)
    assert np.isclose(temps[0], 100.0) and np.all(np.diff(temps[:30]) < 0)


def _swap_draws(k_swap, n, iters=5):
    key_rt, key_u = jax.random.split(k_swap)
    rtv = np.asarray(jax.random.randint(key_rt, (iters * n,), 1, n))
    log_u = np.log(np.asarray(jax.random.uniform(key_u, (iters * n,), dtype=jnp.float64)))
    return rtv, log_u


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_temp_exchange_gives_jax_order(seed):
    """The host swap pass with JAX's randint/uniform draws gives JAX's
    permutation exactly, and some swaps happen."""
    n = 12
    key = jax.random.PRNGKey(seed)
    temps = np.exp(np.linspace(np.log(10.0), 0.0, n))
    lpostf = np.asarray(jax.random.normal(jax.random.PRNGKey(100 + seed), (n,))) * 10
    want = np.asarray(jpt._temp_exchange(key, jnp.arange(n), jnp.asarray(lpostf),
                                         jnp.asarray(temps), iters=5))
    rtv, log_u = _swap_draws(key, n)
    got, swaps = ppt._temp_exchange(np.arange(n), lpostf, temps, rtv, log_u)
    np.testing.assert_array_equal(got, want)
    assert swaps > 0 and sorted(got.tolist()) == list(range(n))


@pytest.mark.parametrize("use_gradients", [False, True])
def test_steps_match_jax_scan(use_gradients):
    """14 steps (11 tuning, rho adapted at steps 0 and 10) on a correlated
    Gaussian with JAX's draws injected: the cold chains of the 3
    production steps equal JAX's scan to 1e-10 (float64; the only
    differences are rounding order), in both branches."""
    numtemps, numchain, ndim = 4, 3, 2
    totnum = numtemps + numchain
    total, tuning = 14, 11
    rng = np.random.default_rng(4)
    theta = MEAN + rng.normal(size=(totnum, ndim)) * 0.2
    temps = ppt._temperature_ladder(numtemps, numchain, 10.0)
    hc = np.array([[0.15, 0.02], [0.02, 0.25]])
    covmat0 = hc @ hc
    taracc = 0.6 if use_gradients else 0.25
    tau0 = -1.0
    rho0 = 2.0 * (1.0 + np.tanh(tau0))
    jfval0 = _lp_jax((), jnp.asarray(theta)) / jnp.asarray(temps)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jpt._ptlmc_scan(
        _lp_jax, (), jnp.asarray(theta), jfval0, jnp.asarray(temps), jnp.asarray(hc),
        jnp.asarray(tau0), jnp.asarray(rho0), key, jnp.asarray(covmat0),
        total_steps=total, samptunning=tuning, numtemps=numtemps, taracc=taracc,
        use_gradients=use_gradients))

    t = torch.tensor
    tt = t(temps)
    th = t(theta)
    if use_gradients:
        lp0, g0 = ppt._value_and_grad(_lp_torch, th)
        fval0, dfval0 = lp0 / tt, g0 / tt[:, None]
    else:
        fval0, dfval0 = _lp_torch(th) / tt, torch.zeros_like(th)
    carry = ppt.PTLMCState(th, fval0, dfval0, tau0, rho0 * tt ** (1.0 / 3.0), 0.0)
    saved = []
    for k, kk in enumerate(jax.random.split(key, total)):
        _, k_prop, k_acc, k_swap = jax.random.split(kk, 4)
        rvalo = np.asarray(jax.random.normal(k_prop, (totnum, ndim), jnp.float64))
        log_u = np.log(np.asarray(jax.random.uniform(k_acc, (totnum,), dtype=jnp.float64)))
        rtv, log_us = _swap_draws(k_swap, totnum)
        carry = ppt.ptlmc_step(_lp_torch, carry, k, t(rvalo), t(log_u), t(rtv), t(log_us),
                               temps=tt, temps_np=temps, hc=t(hc), covmat0=t(covmat0),
                               samptunning=tuning, taracc=taracc,
                               use_gradients=use_gradients)
        if k >= tuning:
            saved.append(carry.thetac[numtemps:].numpy())
    got = np.transpose(np.stack(saved), (1, 0, 2))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    assert carry.swaps > 0


def test_preopt_matches_jax_vmapped_lbfgsb():
    """The batched pre-optimization (chains as lanes of one L-BFGS) lands
    where JAX's vmapped L-BFGS lands from the same whitened starts, on a
    non-quadratic target: x within 1e-8 (float64; both stop on the same
    projected-gradient rule)."""
    rng = np.random.default_rng(2)
    nl, ndim = 9, 3
    starts = rng.uniform(-1, 1, size=(nl, ndim))
    cen, sd = starts.mean(0), starts.std(0)
    white = (starts - cen) / sd
    lo, hi = np.maximum(-10, white.min(0)), np.minimum(10, white.max(0))
    c = np.array([0.2, -0.1, 0.3])

    def lp_t(x):
        d = x - torch.tensor(c, dtype=x.dtype)
        return -(d**2).sum(-1) - 0.5 * (d**4).sum(-1) - 0.3 * d[:, 0] * d[:, 1]

    def lp_j(state, x):
        d = x - jnp.asarray(c)
        return -jnp.sum(d**2, -1) - 0.5 * jnp.sum(d**4, -1) - 0.3 * d[:, 0] * d[:, 1]

    jx, jf = jpt._preopt(lp_j, (), jnp.asarray(white), jnp.asarray(cen), jnp.asarray(sd),
                         jnp.asarray(lo), jnp.asarray(hi), maxiter=100)
    t = torch.tensor
    stats = {}
    px, pf = ppt._preopt(lp_t, t(white), t(cen), t(sd), t(lo), t(hi), maxiter=100,
                         stats=stats)
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=0, atol=1e-8)
    np.testing.assert_allclose(pf.numpy(), np.asarray(jf), rtol=1e-10, atol=1e-12)
    assert stats["converged"] == nl and stats["iterations"] > 1


def _draw(seed, ndim=2):
    return lambda n: np.random.default_rng(seed).uniform(-2, 2, size=(n, ndim))


@pytest.mark.parametrize("use_gradients,seed,cov_atol", [(False, 1, 0.03), (True, 2, 0.035)])
def test_gaussian_moments(use_gradients, seed, cov_atol):
    """PTLMC recovers a correlated Gaussian with and without the Langevin
    drift: mean within 0.05 and covariance within the JAX tests' bounds
    (16 chains x 300 steps after 100 discarded)."""
    stats = {}
    chain = ppt.run_ptlmc(_lp_torch, _draw(seed), numtemps=10, numchain=16,
                          sampperchain=400, maxtemp=30.0, nstartparameters=500, seed=seed,
                          use_gradients=use_gradients, stats=stats, **CPU64)
    assert chain.shape == (16, 400, 2)
    s = chain[:, 100:].reshape(-1, 2)
    np.testing.assert_allclose(s.mean(0), MEAN, atol=0.05)
    np.testing.assert_allclose(np.cov(s.T), COV, atol=cov_atol)
    pre = stats["preopt"]
    assert pre["converged"] == 26 and np.all(pre["lp_after"] >= pre["lp_before"])
    assert 0 < stats["swap_acceptance"] < 1 and stats["ms_per_step"] > 0


def test_gradient_mode_1d_gaussian():
    """ndim == 1 with gradients (the real proposal covariance reaches the
    Langevin correction): mean within 0.03, standard deviation within 0.04."""
    mu, sd = 0.3, 0.15
    chain = ppt.run_ptlmc(lambda x: -0.5 * (((x - mu) / sd) ** 2).sum(-1), _draw(5, 1),
                          numtemps=8, numchain=16, sampperchain=400, maxtemp=30.0,
                          nstartparameters=300, seed=4, use_gradients=True, **CPU64)
    s = chain[:, 100:, 0].reshape(-1)
    assert abs(s.mean() - mu) < 0.03 and abs(s.std() - sd) < 0.04


def test_too_few_start_points_refused():
    with pytest.raises(ValueError, match="nstartparameters"):
        ppt.run_ptlmc(_lp_torch, lambda n: np.zeros((n, 2)), numtemps=30, numchain=16,
                      sampperchain=10, nstartparameters=40, **CPU64)


def test_chain_run_ptlmc_matches_jax(tmp_path):
    """Chain.run_MCMC_PTLMC on the small synthetic chain (nev 60, ndim 4, two
    blocks, npc 2, gp_maxiter=10) in each package: the chain-pickle
    contract, samples inside the box, and the JAX run's posterior means
    within 5 Monte-Carlo standard errors of the port's.  The posterior is
    broad (sd 0.1-0.3 in the unit box) and the chains exchange states, so
    an autocorrelation-time error of one run under-reports its scatter
    about fourfold; the error here is the scatter of the port's means over
    four seeds (two with the Langevin drift, two without), that of the
    JAX run taken to be the same."""
    from gpbayestools_hic_tpu.utils.synthetic import build_synthetic_chain as j_build
    from gpbayestools_hic_tpu_torch.utils.synthetic import build_synthetic_chain

    kw = dict(nev=60, ndim=4, nobs_blocks=(5, 3), npc=2, gp_maxiter=10, seed=0)
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    jc, _ = j_build(tmpdir=str(tmp_path / "j"), **kw)
    pc, _ = build_synthetic_chain(tmpdir=str(tmp_path / "p"), **kw, **CPU64)
    run = dict(nsteps=200, nwalkers=8, ntemps=10, maxtemp=50.0, nstartparameters=300)
    jc.run_MCMC_PTLMC(**run, seed=0)
    with pytest.raises(ValueError, match="requested 2 devices but only 0 available"):
        pc.run_MCMC_PTLMC(**run, devices=2)
    means = []
    for seed in range(1, 5):
        pc.run_MCMC_PTLMC(**run, seed=seed, use_gradients=bool(seed % 2))
        with open(pc.mcmc_path, "rb") as f:
            got = pickle.load(f)["chain"]
        assert got.shape == (8, 200, 4) and np.isfinite(got).all()
        assert np.all((got > 0) & (got < 1))
        means.append(got[:, 50:].reshape(-1, 4).mean(0))
    means = np.array(means)
    want = np.asarray(jc.chain)[:, 50:].reshape(-1, 4).mean(0)
    err = means.std(0, ddof=1) * np.sqrt(1.0 + 1.0 / len(means))
    gap = np.abs(want - means.mean(0))
    assert np.all(gap < 5 * err), (gap, err)
