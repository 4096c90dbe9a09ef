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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the suite runs in
    parallel worker processes, where multi-threaded torch ops on every
    worker oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    # n_leapfrog="auto" calibrates a length in [1, l_max], and resume=True
    # appends to the pickle that run wrote
    auto = pc.run_MCMC_HMC(nsteps=2, nwalkers=4, nburnsteps=4, n_leapfrog="auto", seed=3)
    assert 1 <= auto.n_leapfrog <= 16 and auto.chain.shape == (4, 2, 3)
    resumed = pc.run_MCMC_HMC(nsteps=2, nwalkers=8, nburnsteps=4, resume=True, seed=3)
    with open(pc.mcmc_path, "rb") as f:
        stored = pickle.load(f)["chain"]
    assert resumed.chain.shape == (4, 2, 3) and stored.shape == (4, 4, 3)
    np.testing.assert_array_equal(stored[:, 2:], resumed.chain)


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


# ---------------------------------------------------------------- dense modes


def _set_mode(chain, mode):
    chain.likelihood_mode = mode
    return chain


@pytest.mark.parametrize("mode", ["generic", "stitched"])
def test_dense_modes_match_jax_and_auto(chains, mode):
    """One exact likelihood, three routes: the port's ``"generic"``
    (per-block Cholesky) and ``"stitched"`` (one nobs x nobs Cholesky)
    posterior against the JAX Chain in the same mode (rtol 1e-9, float64,
    same factors) and against the port's own ``"auto"`` Woodbury value
    (rtol 1e-8: a different algebraic route)."""
    jc, pc, _ = chains
    X = _points(5)
    try:
        auto = _set_mode(pc, "auto").log_posterior(X)
        lp = _set_mode(pc, mode).log_posterior(X)
        jlp = _set_mode(jc, mode).log_posterior(X)
        ll = pc.log_likelihood(X)
    finally:
        _set_mode(pc, "auto"), _set_mode(jc, "auto")
    assert np.all(np.isneginf(lp[-3:])) and np.all(np.isneginf(jlp[-3:]))
    np.testing.assert_allclose(lp[:-3], jlp[:-3], rtol=1e-9)
    np.testing.assert_allclose(lp[:-3], auto[:-3], rtol=1e-8)
    np.testing.assert_array_equal(ll, lp)


def test_generic_posterior_gradient_matches_jax(chains):
    """Gradient of the generic (dense per-block) posterior, autograd through
    cholesky_ex vs JAX autodiff through its Cholesky: 1e-8 relative."""
    jc, pc, _ = chains
    X = _points(6)[:-3]
    try:
        fn, state = _set_mode(pc, "generic").posterior_with_state()
        x = torch.tensor(X, requires_grad=True)
        (g,) = torch.autograd.grad(fn(state, x).sum(), x)
        jfn, jstate = _set_mode(jc, "generic").posterior_with_state()
        jg = np.asarray(jax.grad(lambda q: jnp.sum(jfn(jstate, q)))(jnp.asarray(X)))
    finally:
        _set_mode(pc, "auto"), _set_mode(jc, "auto")
    np.testing.assert_allclose(g.numpy(), jg, rtol=1e-8, atol=1e-8 * np.abs(jg).max())


def test_likelihood_mode_setter(chains):
    """The setter validates, and a mode set after an evaluation takes
    effect: the stitched functions replace the blocked ones (seen in the
    state the posterior is built from), with the same value."""
    _, pc, p = chains
    c = Chain(mcmc_path=str(p["tmp"] / "mode" / "chain.pkl"), expdata_path=p["exp"],
              model_parafile=p["par"], **F64)
    c.loadEmulator(p["saves"])
    assert c.likelihood_mode == "auto"
    X = _points(7)[:4]
    auto = c.log_posterior(X)
    fns_auto = c.device_fns
    assert len(c._like_state["blocks"]) == 2 and "p0" in c._like_state["blocks"][0]
    c.likelihood_mode = "auto"                       # same mode: nothing rebuilt
    assert c.device_fns is fns_auto
    c.likelihood_mode = "generic"
    assert c._device_fns is None
    generic = c.log_posterior(X)
    assert "exp_var_diag" in c._like_state["blocks"][0]
    c.likelihood_mode = "stitched"
    stitched = c.log_posterior(X)
    assert c._like_state["blocks"] == ()
    np.testing.assert_allclose(generic, auto, rtol=1e-8)
    np.testing.assert_allclose(stitched, auto, rtol=1e-8)
    with pytest.raises(ValueError, match="unknown likelihood_mode"):
        c.likelihood_mode = "dense"
    assert c.likelihood_mode == "stitched"


def test_dense_experimental_covariance_switches_to_stitched(chains):
    """A dense experimental covariance takes the stitched likelihood in
    every mode; values against the JAX Chain given the same covariance
    (rtol 1e-9) and against a hand assembly."""
    jc, _, p = chains
    c = Chain(mcmc_path=str(p["tmp"] / "dense" / "chain.pkl"), expdata_path=p["exp"],
              model_parafile=p["par"], **F64)
    c.loadEmulator(p["saves"])
    rng = np.random.default_rng(8)
    w = rng.normal(size=(c.nobs, c.nobs)) * 0.02
    dense = np.asarray(c.expdata_cov) + w @ w.T
    old = jc.expdata_cov
    X = _points(9)[:5]
    try:
        c.expdata_cov = dense
        jc.expdata_cov, jc._device_fns = dense, None
        lp, jlp = c.log_posterior(X), jc.log_posterior(X)
    finally:
        jc.expdata_cov, jc._device_fns = old, None
    assert c._like_state["blocks"] == () and c.likelihood_mode == "auto"
    np.testing.assert_allclose(lp, jlp, rtol=1e-9)
    mean, cov = c._predict(X)
    for i in range(len(X)):
        y = mean[i] - c.expdata.flatten()
        cc = cov[i] + dense
        want = -0.5 * y @ np.linalg.solve(cc, y) - 0.5 * np.linalg.slogdet(cc)[1] + 2 * np.log(1e-16)
        np.testing.assert_allclose(lp[i], want, rtol=1e-9)


@pytest.fixture(scope="module")
def diag_chains(tmp_path_factory):
    """JAX and port chains over a no-PCA, an exp_and_cov_diagonal and a PCA
    emulator (the diagonal block twice, the Woodbury block once)."""
    tmp = tmp_path_factory.mktemp("diag")
    rng = np.random.default_rng(21)
    ndim, nev = 3, 30
    design = rng.uniform(0, 1, size=(nev, ndim))
    par = tmp / "pars.txt"
    par.write_text("".join(f"p{i}: $p_{i}$, 0.0, 1.0\n" for i in range(ndim)))
    truth = np.array([0.45, 0.55, 0.5])
    variants = [dict(perform_no_PCA=True), dict(logTrafo=True, exp_and_cov_diagonal=True), {}]
    emus, saves, exp_obs = [], [], []
    for b, (nobs, kw) in enumerate(zip([3, 4, 5], variants)):
        freqs = rng.uniform(1, 2.5, size=(ndim, nobs))
        base = 2.0 + np.sin(design @ freqs)
        pkl = tmp / f"train{b}.pkl"
        with open(pkl, "wb") as f:
            pickle.dump({str(i): {"parameter": design[i],
                                  "obs": np.stack([base[i], 0.01 * np.abs(base[i])])}
                         for i in range(nev)}, f)
        e = JEmulator(str(pkl), str(par), npc=2, gp_maxiter=0, **kw)
        e.trainEmulatorAutoMask()
        e.save(str(tmp / f"emu{b}.pkl"))
        emus.append(e)
        saves.append(str(tmp / f"emu{b}.pkl"))
        exp_obs.append(2.0 + np.sin(truth @ freqs))
    exp_mean = np.concatenate(exp_obs)
    exp_pkl = tmp / "exp.pkl"
    with open(exp_pkl, "wb") as f:
        pickle.dump({"0": {"obs": np.stack([exp_mean, 0.05 * np.abs(exp_mean)])}}, f)
    jc = JChain(mcmc_path=str(tmp / "j" / "chain.pkl"), expdata_path=str(exp_pkl),
                model_parafile=str(par))
    jc.loadEmulator(emus)
    pc = Chain(mcmc_path=str(tmp / "p" / "chain.pkl"), expdata_path=str(exp_pkl),
               model_parafile=str(par), **F64)
    pc.loadEmulator(saves)
    return jc, pc


@pytest.mark.parametrize("mode", ["auto", "generic", "stitched"])
def test_diagonal_block_emulators_match_jax(diag_chains, mode):
    """No-PCA and exp_and_cov_diagonal emulators go through the diagonal
    block in ``"auto"`` and through the dense forms otherwise; all three
    agree with the JAX Chain in the same mode (rtol 1e-9) and with each
    other (rtol 1e-8)."""
    jc, pc = diag_chains
    X = _points(10)
    try:
        auto = _set_mode(pc, "auto").log_posterior(X)
        if mode == "auto":
            kinds = [set(b) for b in pc._like_state["blocks"]]
            assert kinds[0] == kinds[1] == {"exp_block", "exp_var_block"} and "p0" in kinds[2]
        lp = _set_mode(pc, mode).log_posterior(X)
        jlp = _set_mode(jc, mode).log_posterior(X)
    finally:
        _set_mode(pc, "auto"), _set_mode(jc, "auto")
    assert np.isfinite(lp[:-3]).all() and np.all(np.isneginf(lp[-3:]))
    np.testing.assert_allclose(lp[:-3], jlp[:-3], rtol=1e-9)
    np.testing.assert_allclose(lp[:-3], auto[:-3], rtol=1e-8)


# ------------------------------------------------------------------ run_mcmc


@pytest.fixture
def fresh_chain(chains):
    """A port chain with its own (empty) chain file, in generic mode."""
    _, _, p = chains
    n = len(list(p["tmp"].glob("mcmc_*")))
    c = Chain(mcmc_path=str(p["tmp"] / f"mcmc_{n}" / "chain.pkl"), expdata_path=p["exp"],
              model_parafile=p["par"], **F64)
    c.loadEmulator(p["saves"])
    c.likelihood_mode = "generic"
    return c


def test_run_mcmc_contract_thinning_and_resume(fresh_chain):
    """Chain pickle ``{"chain": (nwalkers, ceil(nsteps / nthin), ndim)}``;
    a second call appends and draws another stream; extra keys in the
    pickle survive; a chunked status log changes nothing."""
    c = fresh_chain
    assert c.run_mcmc(nsteps=5) is None          # no nburnsteps / nwalkers: refuses
    res = c.run_mcmc(nsteps=9, nburnsteps=6, nwalkers=12, nthin=2, seed=4, status=4)
    with open(c.mcmc_path, "rb") as f:
        stored = pickle.load(f)
    assert stored["chain"].shape == (12, math.ceil(9 / 2), 3)
    np.testing.assert_array_equal(stored["chain"], res.chain[:, ::2, :])
    assert res.chain.shape == (12, 9, 3) and res.log_prob.shape == (12, 9)
    assert res.acceptance.shape == (12,) and np.isfinite(res.log_prob).all()
    np.testing.assert_array_equal(res.final_state, res.chain[:, -1])
    np.testing.assert_allclose(c.log_posterior(res.final_state), res.final_log_prob, rtol=1e-12)

    stored["note"] = "kept"
    with open(c.mcmc_path, "wb") as f:
        pickle.dump(stored, f)
    res2 = c.run_mcmc(nsteps=4, nburnsteps=6, nwalkers=12, nthin=1, seed=4, status=0)
    with open(c.mcmc_path, "rb") as f:
        again = pickle.load(f)
    assert again["note"] == "kept" and again["chain"].shape == (12, 5 + 4, 3)
    np.testing.assert_array_equal(again["chain"][:, :5], stored["chain"])
    np.testing.assert_array_equal(again["chain"][:, 5:], res2.chain)
    res3 = c.run_mcmc(nsteps=4, nburnsteps=6, nwalkers=12, nthin=1, seed=4)
    assert not np.array_equal(res3.chain, res2.chain)   # the seed folds in the stored length
    assert c.chain.shape == (12, 13, 3)

    ll = c.compute_log_likelihood_for_chain(str(c.mcmc_path.parent / "ll.pkl"), batch_size=50)
    assert ll.shape == (12, 13) and np.isfinite(ll).all()
    np.testing.assert_allclose(ll[:, -1], c.log_likelihood(c.chain[:, -1]), rtol=1e-12)
    np.testing.assert_allclose(c.log_likelihood_point_by_point(c.chain[:, -1]), ll[:, -1],
                               rtol=1e-12)
    assert Chain.map(len, [1, 2, 3]) == 3


def test_run_mcmc_status_chunks_do_not_change_the_chain(chains):
    _, _, p = chains
    out = []
    for i, status in enumerate((None, 3, 0)):
        c = Chain(mcmc_path=str(p["tmp"] / f"status_{i}" / "chain.pkl"), expdata_path=p["exp"],
                  model_parafile=p["par"], **F64)
        c.loadEmulator(p["saves"])
        out.append(c.run_mcmc(nsteps=8, nburnsteps=4, nwalkers=8, nthin=1, seed=2,
                              status=status, move="de"))
    for r in out[1:]:
        np.testing.assert_array_equal(r.chain, out[0].chain)
        np.testing.assert_array_equal(r.log_prob, out[0].log_prob)
        np.testing.assert_allclose(r.acceptance, out[0].acceptance, rtol=1e-12)


def test_run_mcmc_refuses_bad_resume_and_bad_starts(fresh_chain, monkeypatch):
    c = fresh_chain
    # no card here: devices=2 asks for more devices than exist, and raises
    # before any work (nothing falls back to the CPU)
    with pytest.raises(ValueError, match="requested 2 devices but only 0 available"):
        c.run_mcmc(nsteps=2, nburnsteps=2, nwalkers=8, devices=2)
    assert not c.mcmc_path.exists()
    with open(c.mcmc_path, "wb") as f:
        pickle.dump({"chain": np.zeros((40, 3))}, f)
    with pytest.raises(ValueError, match="flat 2-D chain"):
        c.run_mcmc(nsteps=2, nburnsteps=2, nwalkers=8)
    with open(c.mcmc_path, "wb") as f:
        pickle.dump({"chain": np.zeros((8, 5, 4))}, f)
    with pytest.raises(ValueError, match="ndim=4"):
        c.run_mcmc(nsteps=2, nburnsteps=2, nwalkers=8)
    c.mcmc_path.unlink()

    _, state = c.posterior_with_state()
    good = c.random_pos(8, seed=0)
    bad = good.copy()
    bad[3, 0] = 1.5                                  # outside the box: -inf
    with pytest.raises(ValueError, match="1 of 8 initial walkers"):
        c._check_initial_state(state, bad)
    flat = good.copy()
    flat[:, 2] = flat[:, 0]                          # rank-deficient ensemble
    with pytest.raises(ValueError, match="linearly dependent"):
        c._check_initial_state(state, flat)
    c._check_initial_state(state, good)
    monkeypatch.setattr(c, "random_pos", lambda n, seed=None: bad)
    with pytest.raises(ValueError, match="initial walkers"):
        c.run_mcmc(nsteps=2, nburnsteps=2, nwalkers=8)
    res = c.run_mcmc(nsteps=2, nburnsteps=2, nwalkers=8, skip_initial_state_check=True)
    assert res.chain.shape == (8, 2, 3)


def test_run_mcmc_posterior_moments_match_jax(chains):
    """JAX run_mcmc and the port's, stretch move, generic likelihood: means
    and variances agree within 5 Monte-Carlo standard errors of their
    difference, from the spread over 8 groups of 6 walkers (the walkers of
    an ensemble are coupled, groups of them much less)."""
    jc, _, p = chains
    pc = Chain(mcmc_path=str(p["tmp"] / "moments" / "chain.pkl"), expdata_path=p["exp"],
               model_parafile=p["par"], **F64)
    pc.loadEmulator(p["saves"])
    kw = dict(nsteps=400, nburnsteps=100, nwalkers=48, nthin=1, seed=5, status=0)
    jpath = jc.mcmc_path
    try:
        jc.mcmc_path = p["tmp"] / "moments" / "jchain.pkl"
        _set_mode(jc, "generic"), _set_mode(pc, "generic")
        jres = jc.run_mcmc(**kw)
        pres = pc.run_mcmc(**kw)
    finally:
        jc.mcmc_path = jpath
        _set_mode(jc, "auto")
    js = np.asarray(jres.chain).reshape(8, -1, 3)
    ps = np.asarray(pres.chain).reshape(8, -1, 3)
    assert abs(float(np.mean(pres.acceptance)) - float(np.mean(jres.acceptance))) < 0.06
    for stat in (lambda c: c.mean(1), lambda c: c.var(1)):
        a, b = stat(js), stat(ps)
        se = np.sqrt(a.var(0, ddof=1) / 8 + b.var(0, ddof=1) / 8)
        assert np.all(np.abs(a.mean(0) - b.mean(0)) < 5 * se), (a.mean(0), b.mean(0), se)


def test_synthetic_chain_trained_jointly_matches_jax(tmp_path):
    """The slice as a whole: build_synthetic_chain at a small size (nev 60,
    ndim 4, two blocks, npc 2, gp_maxiter=10) trains jointly in each
    package from the same seed; the port's float64 log_posterior over 32
    walkers equals the JAX chain's (1e-8 relative: the fits agree to
    optimizer tolerance, far below that here) and its float32 chain stays
    within the precision gate of its own float64 oracle."""
    from gpbayestools_hic_tpu.utils.synthetic import build_synthetic_chain as j_build
    from gpbayestools_hic_tpu_torch.utils.synthetic import build_synthetic_chain
    from gpbayestools_hic_tpu_torch.utils.validation import PRECISION_GATE

    kw = dict(nev=60, ndim=4, nobs_blocks=(5, 3), npc=2, gp_maxiter=10, seed=0)
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    (tmp_path / "p32").mkdir()
    jc, _ = j_build(tmpdir=str(tmp_path / "j"), **kw)
    stats = {}
    pc, secs = build_synthetic_chain(tmpdir=str(tmp_path / "p"), fit_stats=stats, **kw, **F64)
    assert secs > 0 and 0 < stats["iterations"] <= 10
    for e, je in zip(pc.emuList, jc.emuList):
        np.testing.assert_allclose(e.gp_state.lml.numpy(), np.asarray(je.gp_state.lml),
                                   rtol=0, atol=1e-6)
    x = pc.random_pos(32, seed=1)
    lp = pc.log_posterior(x)
    np.testing.assert_allclose(lp, np.asarray(jc.log_posterior(x)), rtol=1e-8)
    p32, _ = build_synthetic_chain(tmpdir=str(tmp_path / "p32"), device="cpu", **kw)
    gap = np.abs(p32.log_posterior(x) - f64_log_posterior(p32, x)).max()
    assert gap < PRECISION_GATE, gap
