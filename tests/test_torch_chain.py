"""PyTorch port: Chain posterior and HMC against the JAX package.

A toy calibration problem (2 emulators over disjoint observable blocks,
3 parameters) is trained and saved by the JAX package; the port's Chain
loads the same files.  Values and gradients are compared in float64; the
samplers, whose random streams differ, are compared one injected-noise
step at a time and statistically.
"""

import math
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpbayestools_hic_tpu.models import Emulator as JEmulator
from gpbayestools_hic_tpu.samplers import Chain as JChain
from gpbayestools_hic_tpu_torch.samplers import Chain
from gpbayestools_hic_tpu_torch.samplers import hmc as phmc
from gpbayestools_hic_tpu_torch.utils.metrics import effective_sample_size
from gpbayestools_hic_tpu_torch.utils.validation import f64_log_posterior

F64 = dict(device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """(jax_chain, port_chain_f64, paths) built from the same saved files."""
    tmp = tmp_path_factory.mktemp("chain")
    rng = np.random.default_rng(42)
    ndim, nev = 3, 35
    design = rng.uniform(0, 1, size=(nev, ndim))
    par = tmp / "pars.txt"
    par.write_text("".join(f"p{i}: $p_{i}$, 0.0, 1.0\n" for i in range(ndim)))
    truth = np.array([0.4, 0.6, 0.5])
    emus, saves, exp_obs = [], [], []
    for b, nobs in enumerate([4, 3]):
        freqs = rng.uniform(1, 2.5, size=(ndim, nobs))
        base = 2.0 + np.sin(design @ freqs) + (design**2) @ freqs * 0.2
        pkl = tmp / f"train{b}.pkl"
        with open(pkl, "wb") as f:
            pickle.dump({str(i): {"parameter": design[i],
                                  "obs": np.stack([base[i], 0.01 * np.abs(base[i])])}
                         for i in range(nev)}, f)
        e = JEmulator(str(pkl), str(par), npc=3, gp_maxiter=5)
        e.trainEmulatorAutoMask()
        path = tmp / f"emu{b}.pkl"
        e.save(str(path))
        emus.append(e)
        saves.append(str(path))
        exp_obs.append(2.0 + np.sin(truth @ freqs) + (truth**2) @ freqs * 0.2)
    exp_mean = np.concatenate(exp_obs)
    exp_pkl = tmp / "exp.pkl"
    with open(exp_pkl, "wb") as f:
        pickle.dump({"0": {"obs": np.stack([exp_mean, 0.05 * np.abs(exp_mean)])}}, f)
    jc = JChain(mcmc_path=str(tmp / "jmcmc" / "chain.pkl"), expdata_path=str(exp_pkl),
                model_parafile=str(par))
    jc.loadEmulator(emus)
    pc = Chain(mcmc_path=str(tmp / "pmcmc" / "chain.pkl"), expdata_path=str(exp_pkl),
               model_parafile=str(par), **F64)
    pc.loadEmulator(saves)
    return jc, pc, dict(saves=saves, exp=str(exp_pkl), par=str(par), tmp=tmp)


def _points(seed, n_in=8):
    rng = np.random.default_rng(seed)
    inside = rng.uniform(0.05, 0.95, size=(n_in, 3))
    outside = np.array([[1.2, 0.5, 0.5], [0.5, -0.1, 0.5], [0.3, 0.3, 1.0]])
    return np.concatenate([inside, outside])


def test_log_posterior_and_gradient_match_jax(chains):
    """log_posterior to rtol 1e-9 (f64; -inf outside the box) and its
    gradient inside the box to 1e-9 relative (f64, same factors)."""
    jc, pc, _ = chains
    X = _points(0)
    lp = pc.log_posterior(X)
    jlp = jc.log_posterior(X)
    assert np.all(np.isneginf(lp[-3:])) and np.all(np.isneginf(jlp[-3:]))
    np.testing.assert_allclose(lp[:-3], jlp[:-3], rtol=1e-9)
    np.testing.assert_allclose(pc.log_prior(X), jc.log_prior(X))
    np.testing.assert_allclose(pc.log_likelihood(X, finite=True)[-3:], -1e300)
    np.testing.assert_allclose(pc.log_likelihood(X)[:-3], jc.log_likelihood(X)[:-3], rtol=1e-9)

    fn, state = pc.posterior_with_state()
    x = torch.tensor(X[:-3], requires_grad=True)
    (g,) = torch.autograd.grad(fn(state, x).sum(), x)
    jfn, jstate = jc.posterior_with_state()
    jg = np.asarray(jax.grad(lambda q: jnp.sum(jfn(jstate, q)))(jnp.asarray(X[:-3])))
    np.testing.assert_allclose(g.numpy(), jg, rtol=1e-9, atol=1e-9 * np.abs(jg).max())


def test_log_posterior_matches_manual_cholesky(chains):
    """Woodbury posterior == hand assembly: emulator predict + diagonal exp
    cov + dense Cholesky loglike + the extra_std constant (rtol 1e-8, the
    tolerance of tests/test_chain.py:86)."""
    from scipy import linalg as sla

    _, pc, _ = chains
    X = np.random.default_rng(1).uniform(0.2, 0.8, size=(6, 3))
    got = pc.log_posterior(X)
    mean, cov = pc._predict(X)
    expected = np.empty(6)
    for i in range(6):
        c = cov[i] + pc.expdata_cov
        y = mean[i] - pc.expdata.flatten()
        L = np.linalg.cholesky(c)
        alpha = sla.cho_solve((L, True), y)
        expected[i] = -0.5 * y @ alpha - np.log(np.diag(L)).sum() + 2 * np.log(1e-16)
    np.testing.assert_allclose(got, expected, rtol=1e-8)


def test_predict_extra_std_matches_jax(chains):
    jc, pc, _ = chains
    X = np.random.default_rng(2).uniform(0.2, 0.8, size=(4, 3))
    for s in (0.0, 0.3):
        m, c = pc._predict(X, extra_std=s)
        jm, jcv = jc._predict(X, extra_std=s)
        np.testing.assert_allclose(m, jm, rtol=1e-10)
        np.testing.assert_allclose(c, jcv, rtol=1e-10, atol=1e-14)
    with pytest.raises(ValueError, match="extra_std"):
        pc._predict(X, extra_std=np.zeros(5))


def test_f32_chain_within_precision_gate_of_f64_oracle(chains):
    """The float32 chain (fused path, plain version on the CPU) stays far
    inside the 0.5 log-unit gate of the float64 oracle."""
    _, _, p = chains
    c32 = Chain(mcmc_path=str(p["tmp"] / "c32" / "chain.pkl"), expdata_path=p["exp"],
                model_parafile=p["par"], device="cpu")
    c32.loadEmulator(p["saves"])
    X = np.random.default_rng(3).uniform(0.05, 0.95, size=(16, 3))
    gap = np.abs(c32.log_posterior(X) - f64_log_posterior(c32, X)).max()
    assert gap < 0.05, gap


def _vg_numpy(pc, tf_np):
    """u -> (lp_u, lp_x, grad) through the port posterior, as numpy."""
    fn, state = pc.posterior_with_state()
    tf = {k: torch.tensor(v) for k, v in tf_np.items()}
    vg = phmc.make_value_and_grad(fn, state, tf, True)

    def f(u):
        lp_u, lp_x, g = vg(torch.tensor(u))
        return lp_u.numpy(), lp_x.numpy(), g.numpy()

    return vg, f


def test_mh_step_matches_numpy_transcription(chains):
    """One leapfrog-plus-accept step (injected momentum, step sizes, lengths
    and uniforms) equals a numpy transcription of the JAX _hmc_scan update
    on the port's posterior (f64, identical operation order: 1e-12)."""
    _, pc, _ = chains
    rng = np.random.default_rng(5)
    m, d, nl = 16, 3, 6
    chol = np.linalg.cholesky(np.diag([0.5, 0.8, 0.6]) + 0.05)
    tf_np = {"mu": rng.normal(size=d) * 0.2, "chol": chol,
             "lo": np.zeros(d), "width": np.ones(d)}
    vg, f = _vg_numpy(pc, tf_np)
    u = rng.normal(size=(m, d))
    e = 0.3 * rng.uniform(0.9, 1.1, size=(m, 1))
    p0 = rng.normal(size=(m, d))
    L = rng.integers(nl - 2, nl + 1, size=m)
    log_unif = np.log(rng.uniform(size=m))
    lp_u, lp_x, g = f(u)

    # numpy transcription of _hmc_scan's step (traj_jitter > 0 branch)
    p = p0 + 0.5 * e * g
    idx = np.arange(nl)
    active = (idx[:, None] < L[None, :]).astype(float)
    coeff = np.where(idx[:, None] == L[None, :] - 1, 0.5, 1.0) * active
    uu, pp = u.copy(), p.copy()
    for i in range(nl):
        uu = uu + active[i][:, None] * e * pp
        lpn_u, lpn_x, gn = f(uu)
        pp = pp + coeff[i][:, None] * e * gn
    dh = (lpn_u - 0.5 * (pp**2).sum(1)) - (lp_u - 0.5 * (p0**2).sum(1))
    dh = np.where(np.isnan(dh), -np.inf, dh)
    acc_prob = np.mean(np.exp(np.minimum(dh, 0.0)))
    accept = log_unif < dh
    assert 0 < accept.sum() < m   # both branches exercised

    t = torch.tensor
    out = phmc.mh_transition(vg, t(u), t(lp_u), t(lp_x), t(g), t(e), t(p0), t(L),
                             nl, t(log_unif))
    exp = (np.where(accept[:, None], uu, u), np.where(accept, lpn_u, lp_u),
           np.where(accept, lpn_x, lp_x), np.where(accept[:, None], gn, g), acc_prob)
    for got, want in zip(out, exp):
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12, atol=1e-12)


def test_run_hmc_contract_and_report(chains):
    _, pc, _ = chains
    res = pc.run_MCMC_HMC(nsteps=9, nwalkers=16, nburnsteps=8, nthin=2, seed=3)
    with open(pc.mcmc_path, "rb") as f:
        stored = pickle.load(f)["chain"]
    assert stored.shape == (16, math.ceil(9 / 2), 3)
    np.testing.assert_array_equal(stored, res.chain[:, ::2, :])
    assert res.chain.shape == (16, 9, 3) and np.isfinite(res.log_prob).all()
    assert np.all((res.chain > 0) & (res.chain < 1))
    rep = pc.convergence_report()
    assert set(rep) == {"rhat", "tau", "tau_converged", "ess", "converged"}
    with pytest.raises(NotImplementedError):
        pc.run_MCMC_HMC(nsteps=2, nwalkers=4, n_leapfrog="auto")
    with pytest.raises(NotImplementedError):
        pc.run_MCMC_HMC(nsteps=2, nwalkers=4, resume=True)


def test_hmc_posterior_moments_match_jax_hmc(chains):
    """JAX run_MCMC_HMC and the port's sample the same posterior: means and
    variances agree within 5 Monte-Carlo standard errors of their
    difference, the errors taken from the spread of the per-walker
    estimates (walkers are independent chains)."""
    jc, pc, _ = chains
    kw = dict(nsteps=150, nwalkers=64, nburnsteps=48, seed=11)
    jres = jc.run_MCMC_HMC(**kw)
    pres = pc.run_MCMC_HMC(**kw)
    assert pres.scheme == jres.scheme
    js, ps = np.asarray(jres.chain), np.asarray(pres.chain)
    assert effective_sample_size(ps) > 1000
    nw = js.shape[0]
    for stat in (lambda c: c.mean(1), lambda c: c.var(1)):
        a, b = stat(js), stat(ps)
        se = np.sqrt(a.var(0, ddof=1) / nw + b.var(0, ddof=1) / nw)
        assert np.all(np.abs(a.mean(0) - b.mean(0)) < 5 * se), (a.mean(0), b.mean(0), se)
