"""PyTorch port: GP kernels, the marginal likelihood and the batched GP fit
against the JAX package (and sklearn), in float64 on the CPU.

Data: 30 points in 3 dimensions, two targets that depend on every input
(so each length scale is identified), seed 0.  The optimizer is the same
algorithm on both sides; the fits agree to ~1e-12 at ``maxiter=30`` here.
Its stop rules compare numbers at rounding level late in a fit, so on
other data a lane can stop one iteration apart from the JAX lane (the JAX
package's own batched and solo fits do the same, tests/test_gp.py:128-132)
and the optima then agree to ~1e-5 only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.gaussian_process import GaussianProcessRegressor as GPR
from sklearn.gaussian_process import kernels as skk

from gpbayestools_hic_tpu.models import gp as jgp
from gpbayestools_hic_tpu.ops import kernels as jkern
from gpbayestools_hic_tpu_torch.models import gp
from gpbayestools_hic_tpu_torch.ops import kernels as kern


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the suite runs in
    parallel worker processes, where multi-threaded torch ops on every
    worker oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KINDS = ("RBF", "Matern", "MaternProd")
MAXITER = 30
JAX_KEY = 7


def _data():
    rng = np.random.default_rng(0)
    n, d = 30, 3
    x = rng.uniform(0, 1, (n, d))
    ys = np.stack([
        np.sin(3 * x[:, 0]) + np.cos(4 * x[:, 1]) + np.sin(2 * x[:, 2] + 1),
        np.cos(2 * x[:, 1]) * x[:, 0] + x[:, 2] ** 2,
    ]) + 0.05 * rng.normal(size=(2, n))
    nd = 0.01 * rng.uniform(size=ys.shape)
    return x, ys, np.ones(d), nd


X, YS, PTP, ND = _data()
# (MAP strength, with noise_diag, restarts)
SETTINGS = {"mle": (0.0, False, 0), "map_noise": (0.5, True, 0),
            "map_noise_restarts": (0.5, True, 2)}


def _params(rng, b=None, d=3):
    shape = () if b is None else (b,)
    return {"log_amp": rng.normal(0, 0.3, shape),
            "log_ls": rng.normal(-0.3, 0.3, shape + (d,)),
            "log_noise": rng.normal(-3, 0.3, shape)}


def _t(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


@pytest.mark.parametrize("kind", KINDS)
def test_kernel_fn_batched_matches_jax(kind):
    """One batched call builds the (b, n, n) Gram stack and the (b, n, m)
    cross stack; each slice matches the JAX kernel of that GP (1e-12)."""
    rng = np.random.default_rng(1)
    p = _params(rng, b=3)
    xq = rng.uniform(0, 1, (5, 3))
    cfg = kern.KernelConfig(kind)
    gram = kern.kernel_fn(_t(p), torch.tensor(X), config=cfg)
    cross = kern.kernel_fn(_t(p), torch.tensor(X), torch.tensor(xq), config=cfg)
    diag = kern.kernel_diag(_t(p), torch.tensor(xq), config=cfg)
    assert gram.shape == (3, 30, 30) and cross.shape == (3, 30, 5) and diag.shape == (3, 5)
    for k in range(3):
        pk = {name: jnp.asarray(v[k]) for name, v in p.items()}
        jcfg = jkern.KernelConfig(kind)
        np.testing.assert_allclose(
            gram[k].numpy(), np.asarray(jkern.kernel_fn(pk, jnp.asarray(X), config=jcfg)),
            rtol=1e-12, atol=1e-13)
        np.testing.assert_allclose(
            cross[k].numpy(),
            np.asarray(jkern.kernel_fn(pk, jnp.asarray(X), jnp.asarray(xq), config=jcfg)),
            rtol=1e-12, atol=1e-13)
        np.testing.assert_allclose(
            diag[k].numpy(), np.asarray(jkern.kernel_diag(pk, jnp.asarray(xq), config=jcfg)),
            rtol=1e-14)
        # and the one-GP call gives the same slice
        one = kern.kernel_fn(_t({n: v[k] for n, v in p.items()}), torch.tensor(X), config=cfg)
        torch.testing.assert_close(one, gram[k], rtol=0, atol=0)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("with_noise", [False, True])
def test_gp_nll_value_and_gradient_match_jax(kind, with_noise):
    """Batched gp_nll and its autograd gradient in the packed
    log-hyperparameters against the JAX gp_nll and jax.grad per GP
    (value 1e-11 relative, gradient 1e-8 relative: one O(n^3) solve)."""
    rng = np.random.default_rng(2)
    p = _params(rng, b=2)
    theta = gp._pack(_t(p)).requires_grad_(True)
    nd = torch.tensor(ND) if with_noise else None
    cfg = gp.GPConfig(kernel=kern.KernelConfig(kind))
    nll = gp.gp_nll(gp._unpack(theta, 3), torch.tensor(X), torch.tensor(YS), cfg, nd)
    (g,) = torch.autograd.grad(nll.sum(), theta)
    jcfg = jgp.GPConfig(kernel=jkern.KernelConfig(kind))
    for k in range(2):
        def f(v, k=k):
            return jgp.gp_nll(jgp._unpack(v, 3), jnp.asarray(X), jnp.asarray(YS[k]), jcfg,
                              jnp.asarray(ND[k]) if with_noise else None)
        tk = jnp.asarray(theta[k].detach().numpy())
        np.testing.assert_allclose(float(nll[k].detach()), float(f(tk)), rtol=1e-11)
        np.testing.assert_allclose(g[k].numpy(), np.asarray(jax.grad(f)(tk)), rtol=1e-8,
                                   atol=1e-10)


@pytest.mark.parametrize("kind", ["RBF", "Matern"])
def test_gp_nll_matches_sklearn_lml(kind):
    """-gp_nll equals sklearn's log marginal likelihood of ``C * kernel +
    White`` with alpha 0.1 at the same hyperparameters (1e-10)."""
    ls, amp, noise = np.array([0.7, 1.3, 0.9]), 1.4, 0.07
    base = (skk.RBF(ls, length_scale_bounds="fixed") if kind == "RBF"
            else skk.Matern(ls, length_scale_bounds="fixed", nu=1.5))
    sk = GPR(kernel=skk.ConstantKernel(amp) * base + skk.WhiteKernel(noise), alpha=0.1,
             optimizer=None).fit(X, YS[0])
    params = {"log_amp": torch.tensor(np.log(amp)), "log_ls": torch.tensor(np.log(ls)),
              "log_noise": torch.tensor(np.log(noise))}
    nll = gp.gp_nll(params, torch.tensor(X), torch.tensor(YS[0]),
                    gp.GPConfig(kernel=kern.KernelConfig(kind)))
    np.testing.assert_allclose(-float(nll), sk.log_marginal_likelihood_value_, rtol=1e-10)


def test_gp_nll_non_pd_lane_gives_the_guard_and_stays_in_its_lane():
    """A lane whose K is not positive definite gives 1e30 and a NaN
    gradient (as the JAX guard over a NaN Cholesky); its neighbour's value
    and gradient are those it has alone."""
    p = _t(_params(np.random.default_rng(3), b=2))
    theta = gp._pack(p).requires_grad_(True)
    nd = torch.tensor(np.stack([ND[0], np.full(30, -50.0)]))
    nll = gp.gp_nll(gp._unpack(theta, 3), torch.tensor(X), torch.tensor(YS), gp.GPConfig(), nd)
    (g,) = torch.autograd.grad(nll.sum(), theta)
    nll = nll.detach()
    assert float(nll[1]) == 1e30 and torch.isnan(g[1]).all()
    solo_theta = theta[:1].detach().clone().requires_grad_(True)
    solo = gp.gp_nll(gp._unpack(solo_theta, 3), torch.tensor(X), torch.tensor(YS[:1]),
                     gp.GPConfig(), nd[:1])
    (gs,) = torch.autograd.grad(solo.sum(), solo_theta)
    assert float(solo[0].detach()) == float(nll[0]) and torch.equal(gs[0], g[0])


def _jax_starts(kind, nrestarts):
    """The start points the JAX gp_fit draws from PRNGKey(JAX_KEY)."""
    theta0 = jgp._pack(jkern.init_kernel_params(jnp.asarray(PTP)))
    lo, hi = (jgp._pack(b) for b in jkern.default_bounds(jnp.asarray(PTP), kind=kind))
    starts = theta0[None]
    if nrestarts:
        u = jax.random.uniform(jax.random.PRNGKey(JAX_KEY), (nrestarts, theta0.shape[0]),
                               dtype=theta0.dtype)
        starts = jnp.concatenate([starts, lo + u * (hi - lo)], axis=0)
    return torch.tensor(np.asarray(starts))


@pytest.fixture(scope="module")
def jax_fits():
    """JAX gp_fit of both targets, per (kind, setting), computed once."""
    cache = {}

    def get(kind, setting):
        if (kind, setting) not in cache:
            strength, noise, nrestarts = SETTINGS[setting]
            cfg = jgp.GPConfig(kernel=jkern.KernelConfig(kind), map_prior_strength=strength)
            cache[kind, setting] = jgp.gp_fit(
                jnp.asarray(X), jnp.asarray(YS), jnp.asarray(PTP), config=cfg,
                maxiter=MAXITER, nrestarts=nrestarts, key=jax.random.PRNGKey(JAX_KEY),
                noise_diag=jnp.asarray(ND) if noise else None)
        return cache[kind, setting]

    return get


@pytest.mark.parametrize("setting", list(SETTINGS))
@pytest.mark.parametrize("kind", KINDS)
def test_gp_fit_matches_jax(jax_fits, kind, setting):
    """The fitted state matches the JAX gp_fit: LML to 1e-6 and the
    log-hyperparameters to 1e-5 (optimizer tolerance), and the factors the
    state is built from to 1e-8.  With restarts the port is given the JAX
    start points (its own come from a torch.Generator)."""
    strength, noise, nrestarts = SETTINGS[setting]
    cfg = gp.GPConfig(kernel=kern.KernelConfig(kind), map_prior_strength=strength)
    nd = torch.tensor(ND) if noise else None
    if nrestarts:
        st = gp._fit_from_starts(torch.tensor(X), torch.tensor(YS), PTP,
                                 _jax_starts(kind, nrestarts), config=cfg,
                                 maxiter=MAXITER, noise_diag=nd)
    else:
        st = gp.gp_fit(torch.tensor(X), torch.tensor(YS), PTP, config=cfg, maxiter=MAXITER,
                       noise_diag=nd)
    ref = jax_fits(kind, setting)
    np.testing.assert_allclose(st.lml.numpy(), np.asarray(ref.lml), rtol=0, atol=1e-6)
    for name in ("log_amp", "log_ls", "log_noise"):
        np.testing.assert_allclose(st.params[name].numpy(), np.asarray(ref.params[name]),
                                   rtol=0, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(st.alpha_vec.numpy(), np.asarray(ref.alpha_vec), rtol=1e-8,
                               atol=1e-8)
    np.testing.assert_allclose(st.linv.numpy(), np.asarray(ref.linv), rtol=1e-8, atol=1e-8)


def test_batched_fit_equals_each_gp_alone():
    """Every (GP, restart) lane is independent: the two-GP fit with
    restarts gives each GP bit for bit what a fit of that GP alone gives."""
    cfg = gp.GPConfig(kernel=kern.KernelConfig("Matern"), map_prior_strength=0.5)
    starts = _jax_starts("Matern", 2)
    both = gp._fit_from_starts(torch.tensor(X), torch.tensor(YS), PTP, starts, config=cfg,
                               maxiter=MAXITER, noise_diag=torch.tensor(ND))
    for k in range(2):
        one = gp._fit_from_starts(torch.tensor(X), torch.tensor(YS[k:k + 1]), PTP, starts,
                                  config=cfg, maxiter=MAXITER,
                                  noise_diag=torch.tensor(ND[k:k + 1]))
        assert torch.equal(one.lml[0], both.lml[k])
        assert torch.equal(one.params["log_ls"][0], both.params["log_ls"][k])


def test_restarts_from_the_generator():
    """Restart points come from a torch.Generator seeded with ``seed``:
    the same seed gives the same fit, each GP keeps its best lane (so no
    GP ends below its reference-start fit), and the counts are reported."""
    cfg = gp.GPConfig()
    x, y = torch.tensor(X), torch.tensor(YS)
    stats = {}
    a = gp.gp_fit(x, y, PTP, config=cfg, maxiter=MAXITER, nrestarts=3, seed=11, stats=stats)
    b = gp.gp_fit(x, y, PTP, config=cfg, maxiter=MAXITER, nrestarts=3, seed=11)
    plain = gp.gp_fit(x, y, PTP, config=cfg, maxiter=MAXITER)
    assert torch.equal(a.lml, b.lml)
    assert (a.lml >= plain.lml - 1e-9).all()
    assert stats["iterations"] <= MAXITER and stats["host_syncs"] == stats["trials"] > 0
    gen = torch.Generator().manual_seed(11)
    c = gp.gp_fit(x, y, PTP, config=cfg, maxiter=MAXITER, nrestarts=3, generator=gen)
    assert torch.equal(a.lml, c.lml)


def test_maxiter0_keeps_the_clipped_initialization():
    """maxiter=0 builds the state at the reference start (amp 1, length
    scales = ptp, noise 0.05), as the JAX optimizer does with no budget."""
    st = gp.gp_fit(torch.tensor(X), torch.tensor(YS), PTP, maxiter=0)
    np.testing.assert_allclose(st.params["log_ls"].numpy(), 0.0, atol=0)
    np.testing.assert_allclose(st.params["log_noise"].numpy(), np.log(0.05), rtol=1e-15)
    ref = jgp.gp_fit(jnp.asarray(X), jnp.asarray(YS), jnp.asarray(PTP), maxiter=0)
    np.testing.assert_allclose(st.lml.numpy(), np.asarray(ref.lml), rtol=1e-12)


def test_gp_sample_moments_match_predict():
    """gp_sample draws (b, m, n) whose moments match gp_predict (4000
    draws: mean to 0.05, variance to 20%), from the given generator."""
    st = gp.gp_fit(torch.tensor(X), torch.tensor(YS), PTP, maxiter=MAXITER)
    xq = torch.tensor(np.random.default_rng(5).uniform(0, 1, (5, 3)))
    draws = gp.gp_sample(st, xq, 4000, generator=torch.Generator().manual_seed(0))
    assert draws.shape == (2, 5, 4000)
    mean, var = gp.gp_predict(st, xq)
    np.testing.assert_allclose(draws.mean(-1).numpy(), mean.numpy(), atol=0.05)
    np.testing.assert_allclose(draws.var(-1).numpy(), var.numpy(), rtol=0.2, atol=0.01)
    again = gp.gp_sample(st, xq, 4000, generator=torch.Generator().manual_seed(0))
    assert torch.equal(draws, again)


def test_training_refuses_tf32_on_cuda():
    """Products on the training path must not run under TF32: on a CUDA
    tensor the fit checks the flag where it starts (the check reads only
    the device type, so it runs here)."""
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="allow_tf32"):
            gp._check_no_tf32(torch.device("cuda"))
        gp._check_no_tf32(torch.device("cpu"))
        torch.backends.cuda.matmul.allow_tf32 = False
        gp._check_no_tf32(torch.device("cuda"))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
