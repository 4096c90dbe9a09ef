"""Affine-invariant ensemble sampler (Goodman & Weare stretch move).

PyTorch port of the JAX package's ``samplers/ensemble.py``, an
emcee-parity sampler.  Semantics:

- stretch move with scale ``a = 2``: ``z = ((a-1) u + 1)^2 / a`` so
  ``g(z) ~ 1/sqrt(z)`` on ``[1/a, a]``;
- two-half ("red-black") ensemble update: each half is moved against the
  *current* state of the other half, so one step costs two batched
  log-posterior evaluations;
- acceptance ``log r < (ndim - 1) log z + logp(Y) - logp(X)``.

``move="de"`` selects a differential-evolution proposal (emcee ``DEMove``
plus ter Braak's 10% ``gamma = 1`` mode jumps), ``move="snooker"`` the
DE-snooker proposal (ter Braak & Vrugt 2008 unit-direction form with the
``(d-1) log(|Y-z|/|X-z|)`` Jacobian factor), and ``move="de-snooker"`` the
classic 80/20 mixture (each walker draws its kernel independently each
step).  The stretch move stays the default.

Where the JAX run is one ``lax.scan`` with per-step keys folded from the
absolute step index, the port is a Python step loop over a
``torch.Generator`` on the walkers' device that is re-seeded at every step
from ``(seed, absolute step index)``.  A run split into segments with the
same seed and the right ``step_offset`` therefore draws the numbers of the
unsegmented run and reproduces it bit for bit.  Every draw is made on the
device and nothing is read back inside a step.  Each proposal takes its
random numbers as arguments, so tests can inject them.  With a ``mesh``
the two half-ensemble calls are sharded over its devices
(:func:`..parallel.mesh.sharded_log_prob`); the draws stay where the
walkers are, so a seed gives the same chain sharded and unsharded.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..utils.profiling import span

MOVES = ("stretch", "de", "snooker", "de-snooker")

# de needs two DISTINCT partners per half (>= 4 walkers) and snooker an
# anchor plus two partners (>= 6): below that the mod-trick index draws
# collide and the move silently degenerates to frozen walkers
_MIN_WALKERS = {"stretch": 4, "de": 4, "snooker": 6, "de-snooker": 6}

_MASK63 = (1 << 63) - 1


class EnsembleResult(NamedTuple):
    chain: torch.Tensor           # (nwalkers, nsteps, ndim)
    log_prob: torch.Tensor        # (nwalkers, nsteps)
    acceptance: torch.Tensor      # (nwalkers,) accepted-move fraction
    final_state: torch.Tensor     # (nwalkers, ndim)
    final_log_prob: torch.Tensor  # (nwalkers,)


def derive_seed(seed: int, index: int) -> int:
    """A 63-bit seed from ``(seed, index)`` (splitmix64 finalizer), the
    port's counterpart of ``jax.random.fold_in``: deterministic, and
    well-mixed so that neighbouring indices give unrelated streams."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(index) + 0x632BE59BD9B4E019) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) & _MASK63


def _propose_stretch(active, passive, a, u, picks):
    """``u`` (n_active,) uniforms, ``picks`` (n_active,) partner indices."""
    ndim = active.shape[1]
    z = ((a - 1.0) * u + 1.0) ** 2 / a
    partners = passive[picks]
    proposal = partners + z[:, None] * (active - partners)
    return proposal, (ndim - 1.0) * torch.log(z)


def _propose_de(active, passive, ia, r2, jump_u, eps):
    """x' = x + g (a - b) with g = 2.38 / sqrt(2 d), a tiny isotropic
    jitter, and a 10% g = 1 mode-jump mixture.  ``ia`` in [0, n_pass),
    ``r2`` in [0, n_pass - 1) (the second partner is ``ia + 1 + r2`` mod
    n_pass, never ``ia``), ``jump_u`` uniforms, ``eps`` standard normals
    (n_active, ndim).  Symmetric proposal: no Hastings term."""
    ndim = active.shape[1]
    n_pass = passive.shape[0]
    ib = torch.remainder(ia + 1 + r2, n_pass)
    gamma0 = 2.38 / math.sqrt(2.0 * ndim)
    gamma = torch.where(jump_u < 0.1, torch.ones_like(jump_u),
                        torch.full_like(jump_u, gamma0))
    proposal = active + gamma[:, None] * (passive[ia] - passive[ib]) + 1e-5 * eps
    return proposal, torch.zeros_like(jump_u)


def _propose_snooker(active, passive, iz, r1, r2):
    """Slide X along the unit line u through an anchor walker z by
    ``1.7 (u.z1 - u.z2)``; the Jacobian factor ``(d - 1) log(|Y - z| / |X -
    z|)`` keeps detailed balance.  ``iz`` in [0, n_pass), ``r1``/``r2`` in
    [0, n_pass - 1) (partners ``iz + 1 + r`` mod n_pass, never the anchor).
    Coincident walkers (|X - z| = 0) keep the proposal at X."""
    ndim = active.shape[1]
    n_pass = passive.shape[0]
    i1 = torch.remainder(iz + 1 + r1, n_pass)
    i2 = torch.remainder(iz + 1 + r2, n_pass)
    delta = active - passive[iz]
    norm = torch.linalg.vector_norm(delta, dim=1)
    safe = torch.clamp(norm, min=1e-30)
    u = delta / safe[:, None]
    step = 1.7 * (u * (passive[i1] - passive[i2])).sum(1)
    step = torch.where(norm > 0, step, torch.zeros_like(step))
    proposal = active + step[:, None] * u
    ynorm = torch.abs(norm + step)  # |Y - z| along the same line
    log_hastings = (ndim - 1.0) * (torch.log(torch.clamp(ynorm, min=1e-30)) - torch.log(safe))
    return proposal, log_hastings


def draw_half_update(gen: torch.Generator, move: str, n_active: int, n_pass: int,
                     ndim: int, dtype: torch.dtype, device) -> dict:
    """The random numbers one :func:`_half_update` of ``move`` consumes, drawn
    on ``device`` from ``gen``."""
    def unif(*shape):
        return torch.rand(shape, generator=gen, dtype=dtype, device=device)

    def ints(high):
        return torch.randint(0, high, (n_active,), generator=gen, device=device)

    draws = {}
    if move == "stretch":
        draws.update(u=unif(n_active), picks=ints(n_pass))
    if move in ("de", "de-snooker"):
        draws.update(ia=ints(n_pass), de_r2=ints(n_pass - 1), jump_u=unif(n_active),
                     eps=torch.randn((n_active, ndim), generator=gen, dtype=dtype,
                                     device=device))
    if move in ("snooker", "de-snooker"):
        draws.update(iz=ints(n_pass), sn_r1=ints(n_pass - 1), sn_r2=ints(n_pass - 1))
    if move == "de-snooker":
        draws["select_u"] = unif(n_active)
    draws["accept_u"] = unif(n_active)
    return draws


def _half_update(active, passive, lp_active, log_prob_fn, a, move, draws):
    """Move ``active`` walkers against the ``passive`` half with the random
    numbers in ``draws`` (see :func:`draw_half_update`)."""
    d = draws
    if move == "stretch":
        proposal, log_hastings = _propose_stretch(active, passive, a, d["u"], d["picks"])
    elif move == "de":
        proposal, log_hastings = _propose_de(active, passive, d["ia"], d["de_r2"],
                                             d["jump_u"], d["eps"])
    elif move == "snooker":
        proposal, log_hastings = _propose_snooker(active, passive, d["iz"], d["sn_r1"],
                                                  d["sn_r2"])
    elif move == "de-snooker":
        # each walker draws its kernel; only the selected proposal is evaluated
        p_de, lh_de = _propose_de(active, passive, d["ia"], d["de_r2"], d["jump_u"],
                                  d["eps"])
        p_sn, lh_sn = _propose_snooker(active, passive, d["iz"], d["sn_r1"], d["sn_r2"])
        use_de = d["select_u"] < 0.8
        proposal = torch.where(use_de[:, None], p_de, p_sn)
        log_hastings = torch.where(use_de, lh_de, lh_sn)
    else:
        raise ValueError(f"unknown move: {move}")
    lp_prop = log_prob_fn(proposal)
    log_ratio = log_hastings + lp_prop - lp_active
    accept = torch.log(d["accept_u"]) < log_ratio
    new_active = torch.where(accept[:, None], proposal, active)
    new_lp = torch.where(accept, lp_prop, lp_active)
    return new_active, new_lp, accept


def run_ensemble(
    log_prob_fn: Callable[..., torch.Tensor],
    x0: torch.Tensor,
    nsteps: int,
    seed: int,
    *,
    a: float = 2.0,
    move: str = "stretch",
    state=None,
    step_offset: int = 0,
    mesh=None,
) -> EnsembleResult:
    """Run ``nsteps`` ensemble updates from walker positions ``x0``.

    ``log_prob_fn`` maps (m, ndim) -> (m,); each step calls it twice on half
    the ensemble, without recording gradients.  ``x0`` (nwalkers, ndim)
    with nwalkers even; its device and dtype are the run's.  With
    ``state``, the function is called as ``log_prob_fn(state, x)``.

    Step ``i`` draws from a generator seeded with ``derive_seed(seed,
    step_offset + i)``: a run split into segments with the same ``seed``
    reproduces the unsegmented run exactly, so a status-log cadence cannot
    change the samples.

    ``mesh``: a :class:`..parallel.mesh.WalkerMesh`; each half-ensemble
    call is split over its devices (the halves need not divide), against
    replicas of ``state`` built once for this run.
    """
    if mesh is not None:
        from ..parallel.mesh import sharded_log_prob

        log_prob_fn, state = sharded_log_prob(log_prob_fn, mesh, state), None
    if state is not None:
        base_fn = log_prob_fn

        def log_prob_fn(x):
            return base_fn(state, x)

    if move not in MOVES:
        raise ValueError(f"unknown move: {move}")
    nwalkers, ndim = x0.shape
    need = _MIN_WALKERS[move]
    if nwalkers < need:
        raise ValueError(
            f"move={move!r} needs at least {need} walkers (got {nwalkers}): "
            "smaller ensembles make the partner draws collide and freeze "
            "the chain"
        )
    if nwalkers % 2:
        raise ValueError(
            f"nwalkers must be even (got {nwalkers}): the ensemble updates "
            "half against half"
        )
    half = nwalkers // 2
    dtype, device = x0.dtype, x0.device
    gen = torch.Generator(device=device)
    xs, lps = [], []
    with torch.no_grad():
        x = x0
        lp = log_prob_fn(x)
        n_acc = torch.zeros((nwalkers,), dtype=dtype, device=device)
        for i in range(nsteps):
            with span("hic.step"):
                gen.manual_seed(derive_seed(seed, step_offset + i))
                d1 = draw_half_update(gen, move, half, half, ndim, dtype, device)
                d2 = draw_half_update(gen, move, half, half, ndim, dtype, device)
                first, lp_first, acc1 = _half_update(
                    x[:half], x[half:], lp[:half], log_prob_fn, a, move, d1)
                second, lp_second, acc2 = _half_update(
                    x[half:], first, lp[half:], log_prob_fn, a, move, d2)
                x = torch.cat([first, second])
                lp = torch.cat([lp_first, lp_second])
                n_acc = n_acc + torch.cat([acc1, acc2]).to(dtype)
                xs.append(x)
                lps.append(lp)
    if nsteps:
        chain = torch.stack(xs, dim=1)
        log_prob = torch.stack(lps, dim=1)
    else:
        chain = x0.new_zeros((nwalkers, 0, ndim))
        log_prob = x0.new_zeros((nwalkers, 0))
    return EnsembleResult(
        chain=chain,
        log_prob=log_prob,
        acceptance=n_acc / max(nsteps, 1),
        final_state=x,
        final_log_prob=lp,
    )
