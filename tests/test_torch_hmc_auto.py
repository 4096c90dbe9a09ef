"""PyTorch port: HMC's calibrated trajectory length (``n_leapfrog="auto"``),
warm start and resume, against the JAX package.  CPU, float64."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpbayestools_hic_tpu.samplers import hmc as jhmc
from gpbayestools_hic_tpu.samplers.chain import _warm_fallback_key
from gpbayestools_hic_tpu_torch.samplers import hmc as phmc
from gpbayestools_hic_tpu_torch.samplers.chain import warm_fallback_seed
from gpbayestools_hic_tpu_torch.samplers.ensemble import derive_seed
from gpbayestools_hic_tpu_torch.samplers.hmc import run_hmc
from gpbayestools_hic_tpu_torch.utils.synthetic import build_synthetic_chain

CPU64 = dict(device="cpu", dtype=torch.float64)
COV = np.array([[1.0, 0.8], [0.8, 2.0]])
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


def _gauss(x):
    return -0.5 * torch.einsum("bi,ij,bj->b", x, torch.tensor(PREC, dtype=x.dtype), x)


def _ar1_probe_chain(rng, nsteps, nwalkers, ndim, l_max, rho_of_group):
    """A probe-shaped chain whose transitions of length L are AR(1) with
    coefficient ``rho_of_group(L)`` (the JAX test's construction)."""
    us = np.empty((nsteps, nwalkers, ndim))
    us[0] = rng.standard_normal((nwalkers, ndim))
    for t in range(1, nsteps):
        rho = np.stack([rho_of_group(1 + (w + t) % l_max) for w in range(nwalkers)])
        us[t] = rho * us[t - 1] + np.sqrt(1.0 - rho**2) * rng.standard_normal((nwalkers, ndim))
    return us


@pytest.mark.parametrize("case", ["one_fast", "worst_coordinate", "flat", "starved", "random"])
def test_select_leapfrog_equals_jax(case):
    """The port's copy picks JAX's length on the same probe arrays,
    including the starved-group fallback (fewer than 8 lag pairs)."""
    rng = np.random.default_rng(0)
    slow = np.array([0.9, 0.9])
    rho_of = {
        "one_fast": lambda L: slow if L != 5 else np.zeros(2),
        "worst_coordinate": lambda L: {5: np.array([0.0, 0.9]), 2: np.zeros(2)}.get(L, slow),
        "flat": lambda L: np.zeros(2),
        "starved": lambda L: np.zeros(2),
        "random": lambda L: np.array([0.1 * L % 0.95, 0.5]),
    }[case]
    us = _ar1_probe_chain(rng, 256, 32, 2, 8, rho_of)
    if case == "starved":
        us = us[:2, :4]
    got = phmc._select_leapfrog(us, 8)
    assert got == jhmc._select_leapfrog(us, 8)
    if case == "starved":
        assert got == 4
    if case == "one_fast":
        assert got == 5


def test_probe_transition_matches_jax_probe_scan():
    """Two probe steps (rotating lengths 1 + ((w + s) mod l_max)) with
    JAX's own draws injected reproduce JAX's probe scan on a bounded
    correlated Gaussian, positions and acceptance to 1e-12 (float64, same
    arithmetic up to rounding order)."""
    m, d, l_max, nsteps = 6, 2, 4, 2
    lo, hi = np.array([-3.0, -4.0]), np.array([3.0, 5.0])
    rng = np.random.default_rng(3)
    chol = np.array([[0.8, 0.0], [0.3, 1.1]])
    mu = np.array([0.1, -0.2])
    u0 = rng.normal(size=(m, d)) * 0.5
    log_eps = np.log(0.35)

    def jlp(state, x):
        return -0.5 * jnp.einsum("bi,ij,bj->b", x, jnp.asarray(PREC), x)

    jtf = {"mu": jnp.asarray(mu), "chol": jnp.asarray(chol), "lo": jnp.asarray(lo),
           "width": jnp.asarray(hi - lo)}
    key = jax.random.PRNGKey(5)
    us, accs, _, _ = jhmc._hmc_scan(jlp, (), jtf, jnp.asarray(u0), key, jnp.asarray(log_eps),
                                    nsteps=nsteps, n_leapfrog=l_max, adapt=False,
                                    bounded=True, probe=True)
    t = torch.tensor
    tf = {"mu": t(mu), "chol": t(chol), "lo": t(lo), "width": t(hi - lo)}
    vg = phmc.make_value_and_grad(lambda s, x: _gauss(x), None, tf, True)
    u = t(u0)
    lp_u, lp_x, g = vg(u)
    for s, k in enumerate(jax.random.split(key, nsteps)):
        k_p, k_j, _, k_a = jax.random.split(k, 4)
        e = np.exp(log_eps) * np.asarray(jax.random.uniform(k_j, (m, 1), jnp.float64, 0.9, 1.1))
        p0 = np.asarray(jax.random.normal(k_p, (m, d), jnp.float64))
        log_unif = np.log(np.asarray(jax.random.uniform(k_a, (m,), jnp.float64)))
        u, lp_u, lp_x, g, acc = phmc.probe_transition(vg, u, lp_u, lp_x, g, t(e), t(p0), s,
                                                      l_max, t(log_unif))
        np.testing.assert_allclose(u.numpy(), np.asarray(us[s]), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(float(acc), float(accs[s]), rtol=1e-12)


def test_auto_leapfrog_gaussian_moments():
    """n_leapfrog='auto' picks a length in range and samples a correlated
    Gaussian: mean within 0.1 and standard deviations within 12% (the JAX
    test's bounds, 64 walkers x 400 steps)."""
    x0 = np.random.default_rng(9).normal(size=(64, 2)) * 0.2
    res = run_hmc(_gauss, x0, 400, seed=10, n_leapfrog="auto", l_max=8, probe_steps=24,
                  warmup=96, **CPU64)
    assert 1 <= res.n_leapfrog <= 8 and res.warmup_steps == 192
    samples = res.chain.reshape(-1, 2)
    assert np.allclose(samples.mean(0), 0.0, atol=0.1)
    assert np.allclose(samples.std(0), np.sqrt(np.diag(COV)), rtol=0.12)
    with pytest.raises(ValueError, match="auto"):
        run_hmc(_gauss, x0, 4, n_leapfrog="nuts", **CPU64)


def test_warm_start_skips_adaptation(monkeypatch):
    """warm_start runs only production (warmup_steps == 0), reuses the step
    size, metric and length, samples the target (mean within 0.1, standard
    deviations within 15%, the JAX test's bounds) and draws new
    randomness; 'auto' with a warm start reuses its length without a
    probe."""
    x0 = np.random.default_rng(11).normal(size=(64, 2)) * 0.2
    res = run_hmc(_gauss, x0, 300, seed=12, n_leapfrog=6, warmup=96, **CPU64)
    assert res.warmup_steps == 2 * 96
    calls = []
    real = phmc._mh_phase

    def counting(*a, **kw):
        calls.append(kw.get("nsteps"))
        return real(*a, **kw)

    monkeypatch.setattr(phmc, "_mh_phase", counting)
    res2 = run_hmc(_gauss, res.final_state, 300, seed=13, n_leapfrog=6, warmup=96,
                   warm_start=res, **CPU64)
    assert calls == [300] and res2.warmup_steps == 0
    np.testing.assert_allclose(res2.step_size, res.step_size, rtol=1e-12)
    np.testing.assert_array_equal(res2.precond_chol, res.precond_chol)
    np.testing.assert_array_equal(res2.precond_mu, res.precond_mu)
    samples = res2.chain.reshape(-1, 2)
    assert np.allclose(samples.mean(0), 0.0, atol=0.1)
    assert np.allclose(samples.std(0), np.sqrt(np.diag(COV)), rtol=0.15)
    assert not np.array_equal(res2.chain, res.chain)
    calls.clear()
    res3 = run_hmc(_gauss, res2.final_state, 10, seed=14, n_leapfrog="auto",
                   warm_start=res2, **CPU64)
    assert calls == [10] and res3.n_leapfrog == 6 and res3.warmup_steps == 0


def test_scheme_auto_warm_start_uses_previous_acceptance():
    """With a warm start, scheme='auto' decides on the earlier run's
    production acceptance."""
    x0 = np.random.default_rng(5).normal(size=(32, 2))
    first = run_hmc(_gauss, x0, 100, seed=6, n_leapfrog=6, warmup=96, scheme="auto", **CPU64)
    res = run_hmc(_gauss, first.final_state, 30, seed=7, n_leapfrog=6, scheme="auto",
                  warm_start=first, **CPU64)
    assert res.warmup_steps == 0
    assert res.scheme == ("windowed" if float(np.mean(first.acceptance)) >= 0.75 else "mh")


@pytest.mark.parametrize("scheme", ["windowed", "auto"])
def test_window_below_one_refused_before_warmup(monkeypatch, scheme):
    """Under n_leapfrog='auto' an explicit window < 1 is refused before any
    warmup step runs (the JAX package checks it only after the probe)."""
    calls = []
    monkeypatch.setattr(phmc, "_mh_phase", lambda *a, **kw: calls.append(1))
    monkeypatch.setattr(phmc, "_adaptive_phase", lambda *a, **kw: calls.append(1))
    with pytest.raises(ValueError, match="window"):
        run_hmc(_gauss, np.zeros((8, 2)), 4, n_leapfrog="auto", warmup=4, scheme=scheme,
                window=0, **CPU64)
    assert calls == []


def test_continuation_seeds():
    """The continuation rule: deterministic per input, distinct per
    continuation and per seed (mirrors the JAX test of its fallback key,
    which holds for the JAX function on the same states too)."""
    fs1 = np.random.default_rng(0).normal(size=(32, 4))
    fs2 = np.random.default_rng(1).normal(size=(32, 4))
    a, b = warm_fallback_seed(0, fs1), warm_fallback_seed(0, fs2)
    assert a != b and a == warm_fallback_seed(0, fs1) and a != warm_fallback_seed(7, fs1)
    kd = [np.asarray(jax.random.key_data(_warm_fallback_key(s, f)))
          for s, f in ((0, fs1), (0, fs2), (7, fs1))]
    assert not np.array_equal(kd[0], kd[1]) and not np.array_equal(kd[0], kd[2])
    resumed = {derive_seed(0, (1 << 20) + n) for n in (8, 16, 24)}
    assert len(resumed) == 3 and 0 not in resumed
    assert derive_seed(0, (1 << 20) + 8) == derive_seed(0, (1 << 20) + 8)


@pytest.fixture(scope="module")
def small_chain(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hmc_auto")
    chain, _ = build_synthetic_chain(nev=40, ndim=3, nobs_blocks=(4, 3), npc=2,
                                     gp_maxiter=0, seed=0, tmpdir=str(tmp), **CPU64)
    return chain


def test_chain_resume_and_warm_start(small_chain, tmp_path):
    """run_MCMC_HMC: a fresh auto-L run, a warm start with no pickle (starts
    at the final state), then resume=True with a warm start grows the
    pickle 8 -> 16 and draws other randomness than the fresh run; the
    file's walker count wins over nwalkers."""
    c = small_chain
    c.mcmc_path = tmp_path / "chain.pkl"
    res = c.run_MCMC_HMC(nsteps=8, nwalkers=16, nburnsteps=8, n_leapfrog="auto", seed=1)
    assert 1 <= res.n_leapfrog <= 16 and res.warmup_steps == 16
    c.mcmc_path = tmp_path / "warm" / "chain.pkl"
    c.mcmc_path.parent.mkdir()
    res2 = c.run_MCMC_HMC(nsteps=8, seed=1, warm_start=res)
    assert res2.warmup_steps == 0 and res2.n_leapfrog == res.n_leapfrog
    with open(c.mcmc_path, "rb") as f:
        assert pickle.load(f)["chain"].shape == (16, 8, 3)
    res3 = c.run_MCMC_HMC(nsteps=8, nwalkers=4, seed=1, resume=True, warm_start=res2)
    assert res3.warmup_steps == 0
    with open(c.mcmc_path, "rb") as f:
        stored = pickle.load(f)["chain"]
    assert stored.shape == (16, 16, 3)
    np.testing.assert_array_equal(stored[:, 8:], res3.chain)
    assert not np.array_equal(res3.chain, res2.chain)
    assert np.all((stored > 0) & (stored < 1))
