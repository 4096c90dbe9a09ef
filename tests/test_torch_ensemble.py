"""PyTorch port: the ensemble sampler against the JAX package's.

The two packages' random streams differ, so chains are never bit-equal.
One half-update of each move is checked with injected random numbers
against a numpy transcription of the JAX package's ``samplers/ensemble.py``
(:func:`_propose_stretch`, :func:`_propose_de`, :func:`_propose_snooker`,
:func:`_half_update`); whole runs are checked for their invariants and
statistically, against a known Gaussian and against the JAX sampler.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpbayestools_hic_tpu.samplers.ensemble import run_ensemble as j_run_ensemble
from gpbayestools_hic_tpu_torch.samplers import ensemble as pe


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the suite runs in
    parallel worker processes, where multi-threaded torch ops on every
    worker oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MOVES = ("stretch", "de", "snooker", "de-snooker")


# ---- numpy transcription of the JAX moves, random numbers as arguments

def np_stretch(active, passive, a, u, picks):
    ndim = active.shape[1]
    z = ((a - 1.0) * u + 1.0) ** 2 / a
    partners = passive[picks]
    return partners + z[:, None] * (active - partners), (ndim - 1.0) * np.log(z)


def np_de(active, passive, ia, r2, jump_u, eps):
    ndim, n_pass = active.shape[1], passive.shape[0]
    ib = np.mod(ia + 1 + r2, n_pass)
    gamma = np.where(jump_u < 0.1, 1.0, 2.38 / np.sqrt(2.0 * ndim))
    prop = active + gamma[:, None] * (passive[ia] - passive[ib]) + 1e-5 * eps
    return prop, np.zeros(active.shape[0])


def np_snooker(active, passive, iz, r1, r2):
    ndim, n_pass = active.shape[1], passive.shape[0]
    i1 = np.mod(iz + 1 + r1, n_pass)
    i2 = np.mod(iz + 1 + r2, n_pass)
    delta = active - passive[iz]
    norm = np.linalg.norm(delta, axis=1)
    safe = np.maximum(norm, 1e-30)
    u = delta / safe[:, None]
    step = 1.7 * np.einsum("ij,ij->i", u, passive[i1] - passive[i2])
    step = np.where(norm > 0, step, 0.0)
    prop = active + step[:, None] * u
    ynorm = np.abs(norm + step)
    return prop, (ndim - 1.0) * (np.log(np.maximum(ynorm, 1e-30)) - np.log(safe))


def np_half_update(active, passive, lp_active, logp, a, move, d):
    if move == "stretch":
        prop, lh = np_stretch(active, passive, a, d["u"], d["picks"])
    elif move == "de":
        prop, lh = np_de(active, passive, d["ia"], d["de_r2"], d["jump_u"], d["eps"])
    elif move == "snooker":
        prop, lh = np_snooker(active, passive, d["iz"], d["sn_r1"], d["sn_r2"])
    else:
        p_de, lh_de = np_de(active, passive, d["ia"], d["de_r2"], d["jump_u"], d["eps"])
        p_sn, lh_sn = np_snooker(active, passive, d["iz"], d["sn_r1"], d["sn_r2"])
        use_de = d["select_u"] < 0.8
        prop = np.where(use_de[:, None], p_de, p_sn)
        lh = np.where(use_de, lh_de, lh_sn)
    lp_prop = logp(prop)
    with np.errstate(divide="ignore", invalid="ignore"):
        accept = np.log(d["accept_u"]) < lh + lp_prop - lp_active
    return (np.where(accept[:, None], prop, active), np.where(accept, lp_prop, lp_active),
            accept)


def _np_draws(rng, n_active, n_pass, ndim):
    """Every random number any move consumes (a superset per move)."""
    ints = lambda hi: rng.integers(0, hi, size=n_active)  # noqa: E731
    return dict(
        u=rng.uniform(size=n_active), picks=ints(n_pass),
        ia=ints(n_pass), de_r2=ints(n_pass - 1), jump_u=rng.uniform(size=n_active),
        eps=rng.normal(size=(n_active, ndim)),
        iz=ints(n_pass), sn_r1=ints(n_pass - 1), sn_r2=ints(n_pass - 1),
        select_u=rng.uniform(size=n_active), accept_u=rng.uniform(size=n_active),
    )


_PREC = np.array([[2.0, 0.6, 0.0], [0.6, 1.0, -0.3], [0.0, -0.3, 1.5]])


def _np_logp(x):
    lp = -0.5 * np.einsum("ij,jk,ik->i", x, _PREC, x)
    return np.where(x[:, 0] > 1.2, -np.inf, lp)   # a wall: some -inf proposals


def _t_logp(x):
    prec = torch.as_tensor(_PREC, dtype=x.dtype)
    lp = -0.5 * torch.einsum("ij,jk,ik->i", x, prec, x)
    return torch.where(x[:, 0] > 1.2, torch.full_like(lp, -torch.inf), lp)


@pytest.mark.parametrize("move", MOVES)
def test_half_update_matches_numpy_transcription(move):
    """One half-update with injected random numbers, float64: proposal
    acceptance, new positions and log-probs equal the transcription of the
    JAX move to 1e-12 (same formulas); both branches of the accept step
    and a coincident walker (snooker's no-op guard) are exercised."""
    rng = np.random.default_rng(7)
    n_active, n_pass, ndim = 24, 20, 3
    active = rng.normal(size=(n_active, ndim))
    passive = rng.normal(size=(n_pass, ndim))
    d = _np_draws(rng, n_active, n_pass, ndim)
    active[0] = passive[d["iz"][0]]          # |X - z| = 0 for the snooker anchor
    d["jump_u"][:3] = 0.05                   # some g = 1 mode jumps
    lp_active = _np_logp(active)
    want = np_half_update(active, passive, lp_active, _np_logp, 2.0, move, d)
    assert 0 < want[2].sum() < n_active

    td = {k: torch.as_tensor(v) for k, v in d.items()}
    got = pe._half_update(torch.tensor(active), torch.tensor(passive),
                          torch.tensor(lp_active), _t_logp, 2.0, move, td)
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got[1].numpy(), want[1], rtol=1e-12, atol=1e-12)
    assert np.isfinite(got[0].numpy()).all()


@pytest.mark.parametrize("move", MOVES)
def test_draws_have_the_shapes_and_ranges_the_moves_need(move):
    gen = torch.Generator().manual_seed(3)
    d = pe.draw_half_update(gen, move, 50, 7, 4, torch.float64, "cpu")
    assert d["accept_u"].shape == (50,)
    for k, v in d.items():
        if v.dtype == torch.int64:
            hi = 7 if k in ("picks", "ia", "iz") else 6
            assert v.min() >= 0 and v.max() < hi and v.max() == hi - 1, k
        elif k != "eps":
            assert v.min() >= 0 and v.max() < 1, k
    want = {"stretch": {"u", "picks"}, "de": {"ia", "de_r2", "jump_u", "eps"},
            "snooker": {"iz", "sn_r1", "sn_r2"},
            "de-snooker": {"ia", "de_r2", "jump_u", "eps", "iz", "sn_r1", "sn_r2", "select_u"}}
    assert set(d) == want[move] | {"accept_u"}


def test_argument_checks():
    """Even walker count, minimum ensemble sizes per move, unknown move:
    the JAX package's checks, same messages."""
    x = torch.zeros((6, 2), dtype=torch.float64)
    logp = lambda q: -0.5 * (q * q).sum(1)  # noqa: E731
    with pytest.raises(ValueError, match="must be even"):
        pe.run_ensemble(logp, torch.zeros((5, 2)), 2, 0)
    with pytest.raises(ValueError, match="needs at least 4"):
        pe.run_ensemble(logp, x[:2], 2, 0)
    for move in ("snooker", "de-snooker"):
        with pytest.raises(ValueError, match="needs at least 6"):
            pe.run_ensemble(logp, x[:4], 2, 0, move=move)
        with pytest.raises(ValueError, match="needs at least 6"):
            j_run_ensemble(lambda q: -0.5 * jnp.sum(q * q, 1), jnp.zeros((4, 2)), 2,
                           jax.random.PRNGKey(0), move=move)
    with pytest.raises(ValueError, match="unknown move"):
        pe.run_ensemble(logp, x, 2, 0, move="walk")
    res = pe.run_ensemble(logp, x + torch.arange(6.0, dtype=torch.float64)[:, None], 0, 0)
    assert res.chain.shape == (6, 0, 2) and res.final_state.shape == (6, 2)


@pytest.mark.parametrize("move", MOVES)
def test_chunked_run_equals_unchunked_run_bit_for_bit(move):
    """Segments with the same seed and absolute step offsets reproduce the
    unsegmented run exactly; another seed gives another chain; the state
    form (log_prob_fn(state, x)) equals the closure form."""
    rng = np.random.default_rng(1)
    x0 = torch.tensor(rng.normal(size=(12, 3)))
    whole = pe.run_ensemble(_t_logp, x0, 11, 5, move=move)
    assert whole.chain.shape == (12, 11, 3) and whole.log_prob.shape == (12, 11)
    x, chains, lps, acc = x0, [], [], 0
    for off, n in ((0, 4), (4, 4), (8, 3)):
        part = pe.run_ensemble(_t_logp, x, n, 5, move=move, step_offset=off)
        chains.append(part.chain)
        lps.append(part.log_prob)
        acc = acc + part.acceptance * n
        x = part.final_state
    assert torch.equal(torch.cat(chains, 1), whole.chain)
    assert torch.equal(torch.cat(lps, 1), whole.log_prob)
    assert torch.equal(x, whole.final_state)
    np.testing.assert_allclose((acc / 11).numpy(), whole.acceptance.numpy(), rtol=1e-12)
    assert torch.equal(whole.chain[:, -1], whole.final_state)
    other = pe.run_ensemble(_t_logp, x0, 11, 6, move=move)
    assert not torch.equal(other.chain, whole.chain)
    stateful = pe.run_ensemble(lambda s, q: _t_logp(q) + s, x0, 11, 5, move=move,
                               state=torch.tensor(0.0, dtype=torch.float64))
    assert torch.equal(stateful.chain, whole.chain)


def test_derive_seed_is_deterministic_and_spreads():
    seeds = {pe.derive_seed(s, i) for s in range(20) for i in range(200)}
    assert len(seeds) == 4000 and all(0 <= s < 2**63 for s in seeds)
    assert pe.derive_seed(3, 9) == pe.derive_seed(3, 9)


_COV = np.array([[1.0, 0.8], [0.8, 2.0]])
_MU = np.array([0.5, -1.0])


@pytest.mark.parametrize("move", MOVES)
def test_known_gaussian_moments(move):
    """64 walkers x 1500 steps on a correlated 2-d Gaussian: mean and
    covariance within 5 Monte-Carlo standard errors plus 0.02 (the
    standard error is itself estimated from only 8 groups of 8 walkers),
    after 300 burn-in steps."""
    prec = torch.tensor(np.linalg.inv(_COV))
    mu = torch.tensor(_MU)

    def logp(x):
        d = x - mu
        return -0.5 * torch.einsum("ij,jk,ik->i", d, prec, d)

    x0 = torch.tensor(np.random.default_rng(2).normal(size=(64, 2)))
    res = pe.run_ensemble(logp, x0, 1500, 3, move=move)
    acc = res.acceptance.mean().item()
    assert 0.15 < acc < 0.95, acc
    s = res.chain[:, 300:].numpy().reshape(8, -1, 2)            # 8 walker groups
    means = s.mean(1)
    covs = np.stack([np.cov(g.T) for g in s])
    for est, truth in ((means, _MU), (covs, _COV)):
        se = est.std(0, ddof=1) / np.sqrt(8)
        assert np.all(np.abs(est.mean(0) - truth) < 5 * se + 0.02), (est.mean(0), truth, se)


@pytest.mark.parametrize("move", ["stretch", "de"])
def test_moments_match_jax_sampler(move):
    """The JAX sampler and the port on the same banana-shaped target from
    the same start: per-group means and variances agree within 5 standard
    errors of their difference plus 0.02 (8 groups: a noisy error
    estimate), acceptance within 0.05 (chains are never bit-equal)."""
    def t_logp(x):
        return -0.5 * (x[:, 0] ** 2 / 1.5 + (x[:, 1] - 0.3 * x[:, 0] ** 2) ** 2 / 0.5)

    def j_logp(x):
        return -0.5 * (x[:, 0] ** 2 / 1.5 + (x[:, 1] - 0.3 * x[:, 0] ** 2) ** 2 / 0.5)

    x0 = np.random.default_rng(4).normal(size=(48, 2))
    pres = pe.run_ensemble(t_logp, torch.tensor(x0), 1200, 1, move=move)
    jres = j_run_ensemble(j_logp, jnp.asarray(x0), 1200, jax.random.PRNGKey(1), move=move)
    ps = pres.chain[:, 200:].numpy().reshape(8, -1, 2)
    js = np.asarray(jres.chain)[:, 200:].reshape(8, -1, 2)
    for stat in (lambda c: c.mean(1), lambda c: c.var(1)):
        a, b = stat(js), stat(ps)
        se = np.sqrt(a.var(0, ddof=1) / 8 + b.var(0, ddof=1) / 8)
        assert np.all(np.abs(a.mean(0) - b.mean(0)) < 5 * se + 0.02), (a.mean(0), b.mean(0), se)
    assert abs(float(pres.acceptance.mean()) - float(np.mean(jres.acceptance))) < 0.05
