"""PyTorch port: the batched box-constrained L-BFGS against the JAX optimizer.

The port runs a batch of lanes in one loop; the JAX package ``vmap``s its
``lax.while_loop``.  Each problem below runs as a batch of lanes that stop
at different iterations, and must give the JAX iterates (float64, x to
1e-10: the two sides differ only in the summation order of the dot
products), the same iteration counts and the same ``converged`` flags.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpbayestools_hic_tpu.ops.lbfgsb import lbfgsb_minimize as j_minimize
from gpbayestools_hic_tpu_torch.ops.lbfgsb import lbfgsb_minimize


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the suite runs in
    parallel worker processes, where multi-threaded torch ops on every
    worker oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


C = np.array([0.3, -1.7, 2.5, 0.9])
SCALE = np.array([1.0, 10.0, 0.5, 3.0])


def quad_j(x):
    return jnp.sum(jnp.asarray(SCALE, x.dtype) * (x - jnp.asarray(C, x.dtype)) ** 2)


def quad_t(x):
    s, c = torch.tensor(SCALE, dtype=x.dtype), torch.tensor(C, dtype=x.dtype)
    return (s * (x - c) ** 2).sum(-1)


def rosen_j(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)


def rosen_t(x):
    return (100.0 * (x[:, 1:] - x[:, :-1] ** 2) ** 2 + (1 - x[:, :-1]) ** 2).sum(-1)


def holey_j(x):
    # minimum at (2, 2, 2, 2); NaN where x0 + x1 > 3, i.e. over the optimum
    q = jnp.sum((x - 2.0) ** 2 * jnp.arange(1.0, 5.0))
    return jnp.where(x[0] + x[1] <= 3.0, q, jnp.nan)


def holey_t(x):
    q = ((x - 2.0) ** 2 * torch.arange(1.0, 5.0, dtype=x.dtype)).sum(-1)
    return torch.where(x[:, 0] + x[:, 1] <= 3.0, q, torch.full_like(q, float("nan")))


# (port fun, JAX fun, lower, upper, start box, maxiter)
PROBLEMS = {
    # the optimum sits outside the box in two coordinates: active bounds
    "quadratic_active_bounds": (quad_t, quad_j, [-1.0, -1.0, -3.0, -3.0],
                                [1.0, 1.0, 2.0, 3.0], (-1.0, 1.0), 100),
    # 2-d, the bound x1 <= 0.8 cuts the valley off before (1, 1)
    "rosenbrock_boxed": (rosen_t, rosen_j, [-1.5, -1.5], [1.5, 0.8], (-1.5, 0.6), 200),
    "nonfinite_region": (holey_t, holey_j, [-1.0] * 4, [4.0] * 4, (-1.0, 1.0), 100),
}


def _starts(lo, hi, dim=4, seed=0, lanes=6):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, size=(lanes, dim))


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_batched_lanes_match_jax_vmap(name):
    """The three problems at seed 0.  On Rosenbrock's curved valley a
    one-ulp difference in the objective's rounding (XLA and torch fuse
    differently) can flip a late Armijo or ftol decision, after which the
    two paths end at the same optimum only to the optimizer's tolerance;
    :func:`test_rosenbrock_optima_agree_across_starts` holds that across
    seeds."""
    fun_t, fun_j, lo, hi, box, maxiter = PROBLEMS[name]
    lo, hi = np.asarray(lo), np.asarray(hi)
    x0 = _starts(*box, dim=len(lo))
    ref = jax.vmap(lambda x: j_minimize(fun_j, x, jnp.asarray(lo), jnp.asarray(hi),
                                        maxiter=maxiter))(jnp.asarray(x0))
    stats = {}
    res = lbfgsb_minimize(fun_t, torch.tensor(x0), torch.tensor(lo), torch.tensor(hi),
                          maxiter=maxiter, stats=stats)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=0, atol=1e-10)
    # f to 1e-9: x's 1e-10 times the objective's gradient at an active
    # bound (O(1) on the Rosenbrock bound)
    np.testing.assert_allclose(res.fun.numpy(), np.asarray(ref.fun), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(res.num_iters.numpy(), np.asarray(ref.num_iters))
    np.testing.assert_array_equal(res.converged.numpy(), np.asarray(ref.converged))
    # the lanes really stop at different iterations
    assert len(set(res.num_iters.tolist())) > 1
    assert stats["iterations"] == int(res.num_iters.max())
    assert stats["converged"] == int(res.converged.sum())
    # one host read per objective evaluation: the start's plus one per trial
    assert stats["host_syncs"] == stats["trials"]


def test_iterates_stay_in_the_box_and_bounds_are_active():
    fun_t, _, lo, hi, box, maxiter = PROBLEMS["quadratic_active_bounds"]
    res = lbfgsb_minimize(fun_t, torch.tensor(_starts(*box, seed=3)), torch.tensor(lo),
                          torch.tensor(hi), maxiter=maxiter)
    x = res.x.numpy()
    assert (x >= np.asarray(lo)).all() and (x <= np.asarray(hi)).all()
    # C[1] = -1.7 < -1 and C[2] = 2.5 > 2: both coordinates end on a bound
    np.testing.assert_allclose(x[:, 1], -1.0)
    np.testing.assert_allclose(x[:, 2], 2.0)


def test_a_lane_alone_takes_the_path_it_takes_in_the_batch():
    """Lanes are independent: each lane of a batch ends where it ends when
    run alone (bit for bit), whatever its neighbours do."""
    fun_t, _, lo, hi, box, maxiter = PROBLEMS["nonfinite_region"]
    x0 = torch.tensor(_starts(*box, seed=3))
    batch = lbfgsb_minimize(fun_t, x0, torch.tensor(lo), torch.tensor(hi), maxiter=maxiter)
    for i in range(x0.shape[0]):
        solo = lbfgsb_minimize(fun_t, x0[i:i + 1], torch.tensor(lo), torch.tensor(hi),
                               maxiter=maxiter)
        assert torch.equal(solo.x[0], batch.x[i])
        assert int(solo.num_iters[0]) == int(batch.num_iters[i])


def test_rosenbrock_optima_agree_across_starts():
    """Over eight start seeds (48 lanes) the port and the JAX optimizer
    reach the same constrained optimum to the optimizer's tolerance.  The
    ftol rule stops a lane once a step gains less than 2.2e-9; along the
    flat valley that leaves the last iterate up to ~1e-7 above the optimum
    in f and ~1e-3 from it in x, on either side, so those are the
    tolerances here."""
    fun_t, fun_j, lo, hi, box, maxiter = PROBLEMS["rosenbrock_boxed"]
    lo, hi = np.asarray(lo), np.asarray(hi)
    x0 = np.concatenate([_starts(*box, dim=2, seed=s) for s in range(8)])
    ref = jax.vmap(lambda x: j_minimize(fun_j, x, jnp.asarray(lo), jnp.asarray(hi),
                                        maxiter=maxiter))(jnp.asarray(x0))
    res = lbfgsb_minimize(fun_t, torch.tensor(x0), torch.tensor(lo), torch.tensor(hi),
                          maxiter=maxiter)
    assert np.asarray(ref.converged).all() and res.converged.all()
    np.testing.assert_allclose(res.fun.numpy(), np.asarray(ref.fun), rtol=0, atol=1e-7)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=0, atol=1e-3)


def test_nan_gradient_stays_in_its_lane():
    """A lane whose objective and gradient are NaN at its start stops
    there; the other lanes converge."""
    def fun(x):
        q = ((x - 0.5) ** 2).sum(-1)
        # log(2 - x0) is NaN past x0 = 2, and so is its gradient; times 0
        # it changes no finite value
        return q * (1.0 + 0.0 * torch.log(2.0 - x[:, 0]))

    x0 = torch.tensor([[0.0, 0.0], [3.0, 0.0], [1.0, 1.0]], dtype=torch.float64)
    res = lbfgsb_minimize(fun, x0, torch.full((2,), -5.0), torch.full((2,), 5.0))
    assert not bool(res.converged[1]) and int(res.num_iters[1]) == 0
    np.testing.assert_allclose(res.x[[0, 2]].numpy(), 0.5, atol=1e-8)
    assert torch.isnan(res.fun[1]) and torch.equal(res.x[1], x0[1])
    assert bool(res.converged[0]) and bool(res.converged[2])


def test_float32_defaults_follow_the_jax_optimizer():
    """In float32 the JAX tol/ftol defaults (1e-4, 20 eps) apply: on the
    quadratic the lanes stop where the JAX lanes stop, to the accuracy
    those rules leave in float32 (a step that gains less than 2.4e-6 of f
    ends the lane, about 3e-4 in x here: 1e-3), with the same
    ``converged`` flags."""
    fun_t, fun_j, lo, hi, box, maxiter = PROBLEMS["quadratic_active_bounds"]
    x0 = _starts(*box, seed=3).astype(np.float32)
    lo32, hi32 = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    ref = jax.vmap(lambda x: j_minimize(fun_j, x, jnp.asarray(lo32), jnp.asarray(hi32),
                                        maxiter=maxiter))(jnp.asarray(x0))

    res = lbfgsb_minimize(fun_t, torch.tensor(x0), torch.tensor(lo32), torch.tensor(hi32),
                          maxiter=maxiter)
    assert res.x.dtype == torch.float32
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), atol=1e-3)
    np.testing.assert_array_equal(res.converged.numpy(), np.asarray(ref.converged))
