"""PyTorch port: dense linear algebra against the JAX package's ops/linalg.

The same numpy-seeded inputs go through both packages, in float64 where
the point is the algorithm (tests/conftest.py enables x64).  The port
factors with ``torch.linalg.cholesky_ex`` and masks on ``info``; JAX gets
NaN from its Cholesky.  Both must land on the same values: NaN factors,
``-inf`` likelihoods, never a raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpbayestools_hic_tpu.ops import linalg as jl
from gpbayestools_hic_tpu_torch.ops import linalg as pl


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the suite runs in
    parallel worker processes, where multi-threaded torch ops on every
    worker oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spd(rng, n, shift=None):
    a = rng.normal(size=(n, n))
    return a @ a.T + (n if shift is None else shift) * np.eye(n)


def test_mvn_loglike_variants_match_jax():
    """mvn_loglike / _fast / _batch, float64, rtol 1e-12 (same Cholesky,
    same formula)."""
    rng = np.random.default_rng(0)
    cov = np.stack([_spd(rng, 9) for _ in range(4)])
    y = rng.normal(size=(4, 9))
    for i in range(2):
        for name in ("mvn_loglike", "mvn_loglike_fast"):
            got = getattr(pl, name)(torch.tensor(y[i]), torch.tensor(cov[i]))
            want = getattr(jl, name)(jnp.asarray(y[i]), jnp.asarray(cov[i]))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    got = pl.mvn_loglike_batch(torch.tensor(y), torch.tensor(cov))
    want = jl.mvn_loglike_batch(jnp.asarray(y), jnp.asarray(cov))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    # the port's mvn_loglike also takes a batch
    got = pl.mvn_loglike(torch.tensor(y), torch.tensor(cov))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


def _rescuable(rng, n=6):
    """A float32 matrix with one eigenvalue at -4e-7, beyond float32
    rounding of its O(1) entries: the plain Cholesky fails, the 1e-6 *
    mean(diag) bump (~1.3e-6) rescues it."""
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    ev = np.array([-4e-7] + list(rng.uniform(1.0, 2.0, size=n - 1)))
    return ((q * ev) @ q.T).astype(np.float32)


def test_cholesky_jittered_matches_jax_including_rescue():
    """A batch of one healthy, one rescuable and one hopeless matrix
    (float32, where the 1e-6 jitter acts): healthy factor equal, bit
    for bit, to its factor in a batch without bad neighbours, rescued factor finite in
    both packages and reproducing the bumped matrix to 5e-6 (its last
    pivot, ~1e-3, is rounding noise in float32, so the factors themselves
    are compared through L L^T), hopeless one NaN in both packages."""
    rng = np.random.default_rng(1)
    good = _spd(rng, 6).astype(np.float32)
    fix = _rescuable(rng)
    lost = -np.eye(6, dtype=np.float32)
    batch = np.stack([good, fix, lost])
    got = pl.cholesky_jittered(torch.tensor(batch)).numpy()
    want = np.asarray(jl.cholesky_jittered(jnp.asarray(batch)))
    alone = pl.cholesky_jittered(torch.tensor(good[None])).numpy()[0]
    np.testing.assert_array_equal(got[0], alone)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    assert np.isfinite(got[1]).all() and np.isfinite(want[1]).all()
    bumped = fix + 1e-6 * np.mean(np.diagonal(fix)) * np.eye(6, dtype=np.float32)
    np.testing.assert_allclose(got[1] @ got[1].T, bumped, atol=5e-6)
    np.testing.assert_allclose(want[1] @ want[1].T, bumped, atol=5e-6)
    np.testing.assert_allclose(got[1][:, :5], want[1][:, :5], rtol=1e-4, atol=1e-5)
    assert np.isnan(got[2]).all() and np.isnan(np.diagonal(want[2])).any()
    # mvn_loglike rides the rescue: finite where rescued, -inf where lost
    y = rng.normal(size=(3, 6)).astype(np.float32)
    lp = pl.mvn_loglike(torch.tensor(y), torch.tensor(batch)).numpy()
    jlp = np.asarray(jax.vmap(jl.mvn_loglike)(jnp.asarray(y), jnp.asarray(batch)))
    assert np.isfinite(lp[:2]).all() and lp[2] == -np.inf and jlp[2] == -np.inf
    np.testing.assert_allclose(lp[0], jlp[0], rtol=1e-5)
    # the no-rescue path rejects the rescuable matrix as JAX does
    fast = pl.mvn_loglike_batch(torch.tensor(y), torch.tensor(batch)).numpy()
    jfast = np.asarray(jl.mvn_loglike_batch(jnp.asarray(y), jnp.asarray(batch)))
    np.testing.assert_array_equal(np.isfinite(fast), np.isfinite(jfast))
    assert list(np.isfinite(fast)) == [True, False, False]


def test_cholesky_jittered_gradient_is_nan_free_and_matches_jax():
    """Double-where: the gradient through a batch that needed the rescue is
    finite for the healthy and the rescued matrix and equals JAX's
    (float64, rtol 1e-8)."""
    rng = np.random.default_rng(2)
    n = 5
    good = _spd(rng, n)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    fix = (q * np.array([-1e-14, 1.0, 1.3, 1.7, 2.0])) @ q.T
    fix = 0.5 * (fix + fix.T)
    batch = np.stack([good, fix])
    w = rng.normal(size=(2, n, n))

    a = torch.tensor(batch, requires_grad=True)
    chol = pl.cholesky_jittered(a)
    assert torch.isfinite(chol).all()
    (g,) = torch.autograd.grad((chol * torch.tensor(w)).sum(), a)
    assert torch.isfinite(g).all()
    jg = jax.grad(lambda m: jnp.sum(jl.cholesky_jittered(m) * w))(jnp.asarray(batch))
    sym = lambda t: 0.5 * (t + np.swapaxes(t, -1, -2))  # noqa: E731
    np.testing.assert_allclose(sym(g.numpy())[0], sym(np.asarray(jg))[0], rtol=1e-8, atol=1e-12)
    # the rescued factor's last pivot is ~1e-6: its gradient is large and
    # ill-conditioned, so compare loosely
    np.testing.assert_allclose(sym(g.numpy())[1], sym(np.asarray(jg))[1], rtol=1e-3,
                               atol=1e-3 * np.abs(np.asarray(jg)[1]).max())


def test_triangular_solves_match_jax():
    rng = np.random.default_rng(3)
    chol = np.linalg.cholesky(_spd(rng, 7))
    for b in (rng.normal(size=7), rng.normal(size=(7, 3))):
        for name in ("solve_lower_triangular", "solve_cholesky"):
            got = getattr(pl, name)(torch.tensor(chol), torch.tensor(b))
            want = getattr(jl, name)(jnp.asarray(chol), jnp.asarray(b))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-11, atol=1e-13)


def test_nonpd_never_raises():
    bad = torch.tensor(-np.eye(4))
    y = torch.ones(4, dtype=torch.float64)
    assert pl.mvn_loglike(y, bad) == -torch.inf
    assert pl.mvn_loglike_fast(y, bad) == -torch.inf
    assert torch.isnan(pl.cholesky_jittered(bad)).all()
    with pytest.raises(torch.linalg.LinAlgError):
        torch.linalg.cholesky(bad)   # what the port must never call unguarded
