"""PyTorch port: flow-preconditioned SMC and its evidence against the JAX
package.  CPU, float64.  The host functions are copies and must give the
JAX package's numbers on the same inputs; the sampler's random streams
differ, so whole runs are compared statistically."""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import norm, uniform as sp_uniform

from gpbayestools_hic_tpu.samplers import smc as jsmc
from gpbayestools_hic_tpu_torch.samplers import smc as psmc
from gpbayestools_hic_tpu_torch.samplers.flows import FlowConfig
from gpbayestools_hic_tpu_torch.utils.priors import ScipyPrior

CPU64 = dict(device="cpu", dtype=torch.float64)
CFG = FlowConfig(n_layers=2, hidden=16)
SMALL = dict(n_effective=200, n_active=100, n_prior=400, n_max_steps=20, n_total=800,
             n_evidence=400, flow_config=CFG, flow_fit_steps=80, **CPU64)
MU, SD = np.array([0.4, 0.6]), 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the suite runs in
    parallel worker processes, where multi-threaded torch ops on every
    worker oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gauss_logl(state, x, finite):
    """A normalized 2-d Gaussian likelihood well inside the unit box:
    log Z = 0 under the uniform prior."""
    return (-0.5 * ((x - torch.tensor(MU, dtype=x.dtype)) ** 2).sum(1) / SD**2
            - np.log(2 * np.pi * SD**2))


# ------------------------------------------------- host functions (copies)


def test_mixture_weights_ess_and_beta_equal_jax():
    """_mixture_terms (with NaN and -inf likelihoods rejected to ~zero
    weight), _log_weights, _ess and _next_beta give JAX's numbers exactly."""
    rng = np.random.default_rng(0)
    logl = -np.abs(rng.normal(size=300)) * 50
    logl[[3, 7]] = [np.nan, -np.inf]
    betas, logzs, counts = [0.0, 0.1, 0.4], [0.0, -3.0, -9.0], [100, 100, 100]
    lc, lm = psmc._mixture_terms(logl, betas, logzs, counts)
    jlc, jlm = jsmc._mixture_terms(logl, betas, logzs, counts)
    np.testing.assert_array_equal(lc, jlc)
    np.testing.assert_array_equal(lm, jlm)
    lw = psmc._log_weights(lc, lm, 1.0)
    assert lw[3] < np.delete(lw, [3, 7]).min() - 1e5 and lw[7] < np.delete(lw, [3, 7]).min() - 1e5
    assert psmc._ess(lw) == jsmc._ess(jsmc._log_weights(jlc, jlm, 1.0))
    for target in (20.0, 80.0, 1e6):
        assert psmc._next_beta(lc, lm, 0.4, target) == jsmc._next_beta(jlc, jlm, 0.4, target)


def test_evidence_host_functions_equal_jax():
    """_ps_logz_err, _fit_t_proposal, _t_proposal_draw / _logpdf,
    _bridge_logz / _bridge_err and _systematic_resample give JAX's
    numbers on the same inputs and the same numpy generator states."""
    rng = np.random.default_rng(1)
    u = rng.multivariate_normal([1.0, -2.0, 0.5], np.diag([1.0, 2.0, 0.5]), size=600)
    lw = rng.normal(size=600)
    counts = [200, 150, 250]
    assert (psmc._ps_logz_err(lw, counts, np.random.default_rng(5))
            == jsmc._ps_logz_err(lw, counts, np.random.default_rng(5)))
    p, j = psmc._fit_t_proposal(u, lw, 5.0), jsmc._fit_t_proposal(u, lw, 5.0)
    for k in p:
        np.testing.assert_array_equal(p[k], j[k])
    np.testing.assert_array_equal(psmc._t_proposal_draw(np.random.default_rng(2), p, 50),
                                  jsmc._t_proposal_draw(np.random.default_rng(2), j, 50))
    np.testing.assert_array_equal(psmc._t_proposal_logpdf(p, u[:40]),
                                  jsmc._t_proposal_logpdf(j, u[:40]))
    lw_q, lw_p = 3.7 + rng.normal(size=400) * 0.3, 3.7 + rng.normal(size=400) * 0.3
    z = psmc._bridge_logz(lw_q, lw_p, 0.0)
    assert z == jsmc._bridge_logz(lw_q, lw_p, 0.0) and abs(z - 3.7) < 0.1
    assert (psmc._bridge_err(lw_q, lw_p, z, np.random.default_rng(3))
            == jsmc._bridge_err(lw_q, lw_p, z, np.random.default_rng(3)))
    assert np.isnan(psmc._bridge_logz(np.array([]), lw_p, 0.0))
    lw[5] = np.nan
    np.testing.assert_array_equal(psmc._systematic_resample(np.random.default_rng(4), lw, 90),
                                  jsmc._systematic_resample(np.random.default_rng(4), lw, 90))


@pytest.mark.parametrize("case", ["gpd_tail", "light_tail", "tiny", "zero_majority", "ten"])
def test_psis_smooth_equals_jax(case):
    """_psis_smooth (and through it _gpd_fit) on the JAX tests' weight
    distributions: identical smoothed weights and tail index."""
    rng = np.random.default_rng(0)
    if case == "gpd_tail":
        log_w = 0.5 * rng.exponential(size=5000)
    elif case == "light_tail":
        log_w = np.log(rng.uniform(0.5, 1.5, size=4000))
    elif case == "tiny":
        log_w = np.array([0.0, 1.0, 2.0, 0.5, 1.5])
    else:
        log_w = np.full(2000, -np.inf)
        n_fin = 120 if case == "zero_majority" else 10
        log_w[:n_fin] = rng.normal(size=n_fin)
    out, khat = psmc._psis_smooth(log_w)
    jout, jkhat = jsmc._psis_smooth(log_w)
    np.testing.assert_array_equal(out, jout)
    assert (np.isnan(khat) and np.isnan(jkhat)) or khat == jkhat
    if case == "gpd_tail":
        assert abs(khat - 0.5) < 0.12
        x = np.sort(rng.pareto(2.0, size=300))
        assert psmc._gpd_fit(x) == jsmc._gpd_fit(x)


def test_select_evidence_equals_jax():
    cases = [(10.0, 0.5, 10.2, 0.1), (10.0, 0.1, 10.2, 0.5), (759.8, 0.27, 754.4, 0.70),
             (0.0, 1.0, 2.9, 0.0), (10.0, 0.5, 10.2, 0.1, 0.9), (10.0, 0.2, 10.2, 0.1, 0.9),
             (760.3, 0.27, 754.8, 0.5, 1.98), (10.0, 0.5, 10.2, 0.1, None),
             (1.0, 0.2, None, None)]
    for c in cases:
        assert psmc._select_evidence(*c) == jsmc._select_evidence(*c)


def test_estimate_dof_and_t_logpdf_equal_jax():
    """The latent dof fit picks JAX's grid point (heavy-tailed, Gaussian
    and in-between samples) and _t_logpdf equals JAX's to 1e-14."""
    rng = np.random.default_rng(3)
    for z in (rng.standard_t(4, size=(500, 3)), rng.normal(size=(500, 3)),
              rng.standard_t(15, size=(2000, 5))):
        assert float(psmc._estimate_dof(torch.tensor(z))) == float(jsmc._estimate_dof(
            jnp.asarray(z)))
    z2 = rng.uniform(0, 20, size=50)
    for nu in (3.0, 1e6):
        np.testing.assert_allclose(psmc._t_logpdf(torch.tensor(z2), torch.tensor(nu), 4).numpy(),
                                   np.asarray(jsmc._t_logpdf(jnp.asarray(z2), nu, 4)),
                                   rtol=1e-14)


def test_scipy_prior_equals_jax():
    """ScipyPrior: the torch log-density equals the JAX one for every
    supported family (positional and keyword parameters), draws are
    seeded, and an unsupported family is refused."""
    from scipy.stats import loguniform, truncnorm

    from gpbayestools_hic_tpu.utils.priors import ScipyPrior as JPrior

    dists = [norm(loc=0.3, scale=0.05), sp_uniform(0.1, 0.8), truncnorm(-1.0, 2.0, loc=0.5,
                                                                       scale=0.2),
             loguniform(0.01, 1.0), norm(0.6, scale=0.2)]
    x = np.random.default_rng(0).uniform(-0.05, 1.05, size=(64, 5))
    np.testing.assert_allclose(ScipyPrior(dists).logpdf(x), np.asarray(JPrior(dists).logpdf(x)),
                               rtol=1e-14)
    np.testing.assert_array_equal(ScipyPrior(dists).rvs(5, np.random.default_rng(1)),
                                  ScipyPrior(dists).rvs(5, np.random.default_rng(1)))
    from scipy.stats import expon

    with pytest.raises(ValueError, match="log_prior_torch"):
        ScipyPrior([expon()])


# ------------------------------------------------------------- whole runs


def test_known_evidence_gaussian():
    """A normalized Gaussian likelihood in the unit box (log Z = 0): logz
    within 3 reported errors (plus 0.02 for the box's truncation and
    float rounding), weights summing to 1, the weighted mean within 0.02
    of the truth, and the result's keys."""
    res = psmc.run_smc(_gauss_logl, np.zeros(2), np.ones(2), seed=1, **SMALL)
    w = res["weights"]
    np.testing.assert_allclose(w.sum(), 1.0, rtol=1e-12)
    assert res["samples"].shape == (w.shape[0], 2) and np.isfinite(res["logl"]).all()
    np.testing.assert_allclose(np.average(res["samples"], axis=0, weights=w), MU, atol=0.02)
    assert abs(res["logz"]) <= 3 * res["logz_err"] + 0.02, (res["logz"], res["logz_err"])
    assert res["logz_source"] in ("ps", "is") and res["logz_is"] is not None
    assert res["ess"] >= 800 and res["total_mcmc_steps"] <= 20 * res["beta_iterations"]
    np.testing.assert_allclose(res["logp"], 0.0, atol=1e-12)


def _resume_case(tmp_path, **extra):
    knobs = dict(SMALL, n_total=500, **extra)
    full = psmc.run_smc(_gauss_logl, np.zeros(2), np.ones(2), **knobs)
    ck = tmp_path / "ck.pkl"
    part = psmc.run_smc(_gauss_logl, np.zeros(2), np.ones(2), **knobs, max_iterations=2,
                        checkpoint_path=ck)
    assert ck.exists() and part["beta_iterations"] == 2 < full["beta_iterations"]
    resumed = psmc.run_smc(_gauss_logl, np.zeros(2), np.ones(2), **knobs,
                           checkpoint_path=ck, resume=True)
    assert resumed["beta_iterations"] == full["beta_iterations"]
    for k in ("samples", "logl", "logp", "weights"):
        np.testing.assert_array_equal(resumed[k], full[k])
    for k in ("logz", "logz_err", "ess", "logz_is", "logz_bridge"):
        assert resumed[k] == full[k]
    return full


@pytest.mark.parametrize("prior", ["uniform", "scipy"])
def test_checkpoint_resume_is_bit_exact(tmp_path, prior):
    """A run stopped after 2 iterations and resumed from its checkpoint is
    bit for bit the uninterrupted run (samples, weights, every evidence
    number), with the uniform box and with a custom scipy prior (whose
    draws the restored numpy generator drives)."""
    extra = {} if prior == "uniform" else {
        "custom_prior": ScipyPrior([norm(loc=0.45, scale=0.15), sp_uniform(0, 1)])}
    full = _resume_case(tmp_path, seed=9, **extra)
    if prior == "scipy":
        assert full["logp"].std() > 0.1


def test_checkpoint_knob_mismatch_refused(tmp_path):
    path = tmp_path / "ck.pkl"
    knobs = {"n_prior": 100, "n_active": 50, "sample": "tpcn", "seed": 1,
             "flow_fit_steps": 300, "box_lo": (0.0, 0.0)}
    psmc._save_smc_checkpoint(path, {"version": 1, "knobs": knobs, "beta": 0.5})
    assert psmc._load_smc_checkpoint(path, knobs)["beta"] == 0.5
    for bad in ({"n_active": 64}, {"flow_fit_steps": 100}, {"box_lo": (0.0, -1.0)}):
        with pytest.raises(ValueError, match="different settings"):
            psmc._load_smc_checkpoint(path, {**knobs, **bad})


def test_refusals():
    """n_active above n_effective, an unknown kernel, and a numpy-only
    prior (no log_prior_torch) are refused before any work."""
    class NumpyPrior:
        dim = 2

        def logpdf(self, x):
            return np.zeros(len(x))

        def rvs(self, size):
            return np.random.default_rng(0).random((size, 2))

    for kw, match in ((dict(n_effective=100, n_active=200), "n_active"),
                      (dict(sample="hmc"), "kernel"),
                      (dict(custom_prior=NumpyPrior()), "log_prior_torch")):
        with pytest.raises(ValueError, match=match):
            psmc.run_smc(_gauss_logl, np.zeros(2), np.ones(2), **{**SMALL, **kw})


def test_prior_draws_decided_by_signature():
    """_draw_prior_in_box passes the run's generator when rvs takes
    random_state (read from its signature) and lets an error raised
    inside such an rvs propagate; an rvs without it is called with the
    size alone (the JAX package tries random_state and swallows any
    TypeError)."""
    lo, hi = np.zeros(2), np.ones(2)

    class Seeded:
        def rvs(self, size, random_state=None):
            return random_state.uniform(0, 1, (size, 2))

    class Unseeded:
        calls = 0

        def rvs(self, size):
            Unseeded.calls += 1
            return np.random.default_rng(Unseeded.calls).uniform(0, 1, (size, 2))

    class Broken:
        def rvs(self, size, random_state=None):
            raise TypeError("bad draw")

    a, frac = psmc._draw_prior_in_box(Seeded(), np.random.default_rng(3), 50, lo, hi)
    b, _ = psmc._draw_prior_in_box(Seeded(), np.random.default_rng(3), 50, lo, hi)
    np.testing.assert_array_equal(a, b)
    assert frac == 1.0
    psmc._draw_prior_in_box(Unseeded(), np.random.default_rng(3), 50, lo, hi)
    assert Unseeded.calls == 1
    with pytest.raises(TypeError, match="bad draw"):
        psmc._draw_prior_in_box(Broken(), np.random.default_rng(3), 50, lo, hi)


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """The small synthetic chain (nev 60, ndim 4, two blocks, npc 2,
    gp_maxiter=10) built by each package from the same seed."""
    from gpbayestools_hic_tpu.utils.synthetic import build_synthetic_chain as j_build
    from gpbayestools_hic_tpu_torch.utils.synthetic import build_synthetic_chain

    tmp = tmp_path_factory.mktemp("smc_chain")
    kw = dict(nev=60, ndim=4, nobs_blocks=(5, 3), npc=2, gp_maxiter=10, seed=0)
    (tmp / "j").mkdir()
    (tmp / "p").mkdir()
    jc, _ = j_build(tmpdir=str(tmp / "j"), **kw)
    pc, _ = build_synthetic_chain(tmpdir=str(tmp / "p"), **kw, **CPU64)
    return jc, pc


def test_chain_run_pocomc_matches_jax(chains):
    """Chain.run_pocoMC writes every key the JAX package writes, and its logz
    is within 4 combined reported errors of the JAX run's; the checkpoint
    is named after mcmc_path (<stem>_smc_checkpoint.pkl, where the JAX
    package writes a fixed smc_checkpoint.pkl)."""
    jc, pc = chains
    knobs = dict(n_effective=200, n_active=100, n_prior=400, n_total=600, n_evidence=400,
                 n_max_steps=20)
    jres = jc.run_pocoMC(**knobs, random_state=0, checkpoint=False)
    res = pc.run_pocoMC(**knobs, random_state=1, flow_config=CFG, flow_fit_steps=80)
    with open(pc.mcmc_path, "rb") as f:
        stored = pickle.load(f)
    assert set(stored) == set(jres) and set(res) == set(jres)
    assert stored["chain"].shape[1] == 4 and np.all((stored["chain"] > 0) & (stored["chain"] < 1))
    np.testing.assert_allclose(stored["weights"].sum(), 1.0, rtol=1e-12)
    err = np.hypot(res["logz_err"], jres["logz_err"])
    assert abs(res["logz"] - jres["logz"]) < 4 * err, (res["logz"], jres["logz"], err)
    ck = pc.mcmc_path.parent / f"{pc.mcmc_path.stem}_smc_checkpoint.pkl"
    assert ck.exists() and not (pc.mcmc_path.parent / "smc_checkpoint.pkl").exists()


def test_chain_run_pocomc_priors_and_refusals(chains, tmp_path):
    """run_pocoMC turns a list of frozen scipy distributions into a
    ScipyPrior, refuses a prior without log_prior_torch, resume without
    checkpoint, and devices= past the card count (none here); an integer
    pool with no second card leaves the run unsharded."""
    _, pc = chains
    pc.mcmc_path = tmp_path / "chain.pkl"
    with pytest.raises(ValueError, match="checkpoint"):
        pc.run_pocoMC(resume=True, checkpoint=False)
    with pytest.raises(ValueError, match="requested 2 devices but only 0 available"):
        pc.run_pocoMC(devices=2)

    class NumpyPrior:
        dim = 4

        def logpdf(self, x):
            return np.zeros(len(x))

    with pytest.raises(ValueError, match="log_prior_torch"):
        pc.run_pocoMC(prior=NumpyPrior())
    res = pc.run_pocoMC(n_effective=100, n_active=50, n_prior=200, n_total=150,
                        n_evidence=0, n_max_steps=10, pool=12, checkpoint=False,
                        prior=[norm(0.5, 0.2)] + [sp_uniform(0, 1)] * 3,
                        flow_config=CFG, flow_fit_steps=40)
    assert np.isfinite(res["logz"]) and res["logz_is"] is None and res["logp"].std() > 0
