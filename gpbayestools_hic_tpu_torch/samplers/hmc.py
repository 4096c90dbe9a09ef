"""Preconditioned Hamiltonian Monte Carlo over the differentiable posterior.

PyTorch port of the JAX package's ``samplers/hmc.py`` on the path that
``Chain.run_MCMC_HMC``'s defaults reach:

- **Reparametrization**: box-constrained parameters are mapped to
  unbounded space through ``x = lo + width * sigmoid(z)`` with the
  log-Jacobian folded into the target.
- **Preconditioning**: ``z = chol @ u + mu`` whitens the posterior (dense
  metric).  Phase A adapts the step size under the identity metric and
  estimates ``(mu, chol)`` from its second half; phase B re-adapts the
  step size under the new metric.
- **Step size**: dual averaging (``gamma=0.05, t0=10, kappa=0.75``) toward
  ``target_accept``, plus a +-10% per-walker step-size jitter;
  ``warmup="auto"`` stops each phase once the averaged step size has
  settled with acceptance on target.
- **Production**: endpoint Metropolis (``"mh"``), or Neal's windowed HMC
  (``"windowed"``, optionally with Horowitz persistent momentum) or the
  multinomial baseline; ``scheme="auto"`` picks windowed + persist 0.7 at
  adapted acceptance >= 0.75 and MH otherwise.
- ``warmup_walkers`` adapts on a walker subset and tiles it up.
- ``n_leapfrog="auto"`` calibrates the production trajectory length: a
  probe phase runs walker ``w`` at step ``s`` with length
  ``1 + ((w + s) mod l_max)`` and :func:`_select_leapfrog` picks the
  length with the most effective samples per gradient.
- ``warm_start`` reuses a previous run's metric, step size and length and
  skips every adaptation phase.

The JAX sampler is one compiled ``lax.scan``; here each phase is a Python
loop over steps, with every random draw taken from one explicitly seeded
``torch.Generator``.  The transition functions take their random inputs
as arguments, so a single step can be checked against a transcription.
With a ``mesh`` the posterior's value-and-gradient evaluations are
sharded over its devices (:func:`make_sharded_value_and_grad`); every
draw, the positions, the u -> x transform and the adaptation stay on the
run's device.
"""

from __future__ import annotations

import logging
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import new_generator, resolve_device, resolve_dtype
from ..utils.profiling import span

logger = logging.getLogger(__name__)


class HMCResult(NamedTuple):
    chain: np.ndarray         # (nwalkers, nsteps, ndim) in x-space
    log_prob: np.ndarray      # (nwalkers, nsteps) x-space log posterior
    acceptance: np.ndarray    # (nsteps,) mean accept statistic per step
    final_state: np.ndarray   # (nwalkers, ndim) x-space
    step_size: float
    precond_chol: np.ndarray  # (ndim, ndim) adapted metric Cholesky
    precond_mu: np.ndarray    # (ndim,)
    n_leapfrog: int
    warmup_steps: int = 0     # adaptation steps run (both phases)
    scheme: str = "mh"        # production kernel actually run
    persist: float = 0.0      # production momentum persistence actually run


_AUTO_ACC_MIN = 0.75
_AUTO_PERSIST = 0.7

_WARMUP_CHUNK = 16
_WARMUP_MIN_CHUNKS = 2
_WARMUP_MAX_CHUNKS = 16
_WARMUP_EPS_TOL = 0.02
_WARMUP_ACC_TOL = 0.10


def _softplus(z):
    return torch.logaddexp(z, torch.zeros_like(z))


def _u_to_x(u, tf, bounded):
    """Whitened-unbounded u -> parameter x, plus log|dx/du| (per sample)."""
    z = u @ tf["chol"].T + tf["mu"]
    if not bounded:
        return z, torch.zeros(u.shape[:-1], dtype=u.dtype, device=u.device)
    x = tf["lo"] + tf["width"] * torch.sigmoid(z)
    logjac = (torch.log(tf["width"]) - _softplus(z) - _softplus(-z)).sum(-1)
    return x, logjac


def _to_unbounded_np(x, lo, hi):
    p = np.clip((x - lo) / (hi - lo), 1e-7, 1 - 1e-7)
    return np.log(p) - np.log1p(-p)


def _x_to_u(x, lo, width, mu, chol):
    """Host-side inverse of :func:`_u_to_x` (numpy; used for starts)."""
    x = np.asarray(x, dtype=np.float64)
    z = _to_unbounded_np(x, lo, lo + width) if lo is not None else x
    return np.linalg.solve(chol, (z - mu).T).T


def make_value_and_grad(log_prob_fn, state, tf, bounded):
    """u -> (lp_u, lp_x, grad_u lp_u), all detached; a non-finite target
    gets a zero gradient so leapfrog arithmetic stays finite."""

    def value_and_grad_u(u):
        with torch.enable_grad():
            uu = u.detach().requires_grad_(True)
            x, logjac = _u_to_x(uu, tf, bounded)
            lp_x = log_prob_fn(state, x)
            total = lp_x + logjac
            with span("hic.grad"):
                (g,) = torch.autograd.grad(total.sum(), uu)
        lp_u = total.detach()
        g = torch.where(torch.isfinite(lp_u)[:, None], g, torch.zeros_like(g))
        return lp_u, lp_x.detach(), g

    return value_and_grad_u


def make_sharded_value_and_grad(x_value_and_grad, tf, bounded):
    """:func:`make_value_and_grad` over a sharded posterior:
    ``x_value_and_grad`` maps x (m, ndim) to ``(lp_x, grad_x lp_x)`` shard
    by shard (a ``sharded_log_prob``'s ``value_and_grad``).  The u -> x
    transform, its logit Jacobian and the chain rule back to u run here,
    over the whole batch, so only the posterior is split: a matrix product
    over a shard's rows may round otherwise than over the whole batch."""

    def value_and_grad_u(u):
        with torch.enable_grad():
            uu = u.detach().requires_grad_(True)
            x, logjac = _u_to_x(uu, tf, bounded)
            lp_x, g_x = x_value_and_grad(x.detach())
            with span("hic.grad"):
                (g,) = torch.autograd.grad((x * g_x).sum() + logjac.sum(), uu)
        lp_u = lp_x + logjac.detach()
        g = torch.where(torch.isfinite(lp_u)[:, None], g, torch.zeros_like(g))
        return lp_u, lp_x, g

    return value_and_grad_u


def mh_transition(vg, u, lp_u, lp_x, g, e, p0, L, n_leapfrog, log_unif):
    """One endpoint-Metropolis HMC step with injected randomness.

    ``e`` (m, 1) per-walker step sizes, ``p0`` (m, d) momenta, ``L`` (m,)
    per-walker trajectory lengths or None (all ``n_leapfrog``),
    ``log_unif`` (m,) log-uniforms for the accept test.  Walkers shorter
    than ``n_leapfrog`` idle on masked iterations (position frozen, no
    kick), as in the JAX scan.  Returns ``(u, lp_u, lp_x, g, acc_prob)``.
    """
    dtype, dev = u.dtype, u.device
    p = p0 + 0.5 * e * g
    lf = torch.arange(n_leapfrog, device=dev)
    if L is None:
        active = torch.ones((n_leapfrog, 1), dtype=dtype, device=dev)
        coeff = torch.where(lf == n_leapfrog - 1, 0.5, 1.0).to(dtype)[:, None]
    else:
        active = (lf[:, None] < L[None, :]).to(dtype)
        coeff = torch.where(lf[:, None] == L[None, :] - 1, 0.5, 1.0).to(dtype) * active
    uu, pp, lpn_u, lpn_x, gn = u, p, lp_u, lp_x, g
    for i in range(n_leapfrog):
        uu = uu + active[i][:, None] * e * pp
        lpn_u, lpn_x, gn = vg(uu)
        pp = pp + coeff[i][:, None] * e * gn
    dh = (lpn_u - 0.5 * (pp**2).sum(1)) - (lp_u - 0.5 * (p0**2).sum(1))
    dh = torch.where(torch.isnan(dh), torch.full_like(dh, -torch.inf), dh)
    acc_prob = torch.exp(torch.clamp(dh, max=0.0)).mean()
    accept = log_unif < dh
    return (
        torch.where(accept[:, None], uu, u),
        torch.where(accept, lpn_u, lp_u),
        torch.where(accept, lpn_x, lp_x),
        torch.where(accept[:, None], gn, g),
        acc_prob,
    )


def probe_transition(vg, u, lp_u, lp_x, g, e, p0, step, l_max, log_unif):
    """One probe step of ``n_leapfrog="auto"``: :func:`mh_transition` with
    walker ``w`` at the rotating length ``1 + ((w + step) mod l_max)``, so
    every length is probed with any walker count and each transition is
    attributable to one length (:func:`_select_leapfrog`)."""
    L = 1 + (torch.arange(u.shape[0], device=u.device) + step) % l_max
    return mh_transition(vg, u, lp_u, lp_x, g, e, p0, L, l_max, log_unif)


def _select_leapfrog(us: np.ndarray, l_max: int) -> int:
    """Pick the trajectory length maximizing effective samples per gradient.

    ``us``: probe-phase u-space chain (nsteps, nwalkers, ndim); the
    transition into ``us[s]`` ran walker ``w`` at length ``1 + ((w + s)
    mod l_max)``.  Each length is scored by the AR(1) mixing rate per
    gradient of its worst coordinate, ``min_d (1 - rho_1[d]) / ((1 +
    rho_1[d]) L)``, with the lag-1 autocorrelation pooled over the
    transitions of that length.  Lengths with fewer than 8 lag pairs are
    ignored; if every length is starved, ``max(l_max // 2, 1)``.  A copy
    of the JAX package's function (host numpy).
    """
    us = np.asarray(us, np.float64)
    nsteps, nwalkers, _ = us.shape
    c = us - us.mean(axis=(0, 1))
    a, b = c[:-1], c[1:]
    grp = (np.arange(nwalkers)[None, :] + np.arange(1, nsteps)[:, None]) % l_max
    score = np.full(l_max + 1, -np.inf)
    for L in range(1, l_max + 1):
        mask = grp == L - 1
        if mask.sum() < 8:
            continue
        m3 = mask[:, :, None]
        num = np.sum(a * b * m3, axis=(0, 1))
        den = np.sqrt(np.sum(a**2 * m3, axis=(0, 1)) * np.sum(b**2 * m3, axis=(0, 1)))
        rho = np.clip(num / np.maximum(den, 1e-300), -0.999, 0.999)
        score[L] = np.min((1.0 - rho) / ((1.0 + rho) * L))
    if not np.isfinite(score).any():
        return max(l_max // 2, 1)
    return int(np.argmax(score))


def trajectory_transition(vg, u, p_prev, lp_u, lp_x, g, e, xi, s, gumbel_u,
                          acc_u, *, n_leapfrog, window, persist):
    """One windowed (``window > 0``) or multinomial (``window == 0``) HMC
    step with injected randomness (Neal 1994; see the JAX package's
    ``_hmc_scan_trajectory`` for the detailed-balance argument).

    ``e`` (m, 1) step sizes, ``xi`` (m, d) fresh normals, ``s`` (m,) start
    offsets, ``gumbel_u`` (L + 1, m) uniforms for the Gumbel-max selection,
    ``acc_u`` (m,) uniforms for the window accept test.  Returns ``(u,
    p_next, lp_u, lp_x, g, acc_stat)``.
    """
    L = n_leapfrog
    neg_inf = -torch.inf
    p0 = persist * p_prev + math.sqrt(1.0 - persist**2) * xi if persist > 0.0 else xi

    def log_w(lp, p):
        lw = lp - 0.5 * (p**2).sum(1)
        return torch.where(torch.isnan(lw), torch.full_like(lw, neg_inf), lw)

    def gumbel(i):
        return -torch.log(-torch.log(gumbel_u[i]))

    def in_r(t):
        return torch.ones_like(t, dtype=torch.bool) if window == 0 else t <= window - 1

    def in_a(t):
        return torch.ones_like(t, dtype=torch.bool) if window == 0 else t >= L - window + 1

    def upd_best(best, member, score, un, lpn_u, lpn_x, gn, pn):
        take = member & (score > best[0])
        t2 = take[:, None]
        return (
            torch.where(take, score, best[0]),
            torch.where(t2, un, best[1]),
            torch.where(take, lpn_u, best[2]),
            torch.where(take, lpn_x, best[3]),
            torch.where(t2, gn, best[4]),
            torch.where(t2, pn, best[5]),
        )

    def masked(member, lw):
        return torch.where(member, lw, torch.full_like(lw, neg_inf))

    lw0 = log_w(lp_u, p0)
    score0 = lw0 + gumbel(0)
    empty = (torch.full_like(lw0, neg_inf), u, lp_u, lp_x, g, p0)
    # reject-window candidates carry the reversed momentum
    best_r = upd_best(empty, in_r(s), score0, u, lp_u, lp_x, g, -p0)
    best_a = upd_best(empty, in_a(s), score0, u, lp_u, lp_x, g, p0)
    lse_r = masked(in_r(s), lw0)
    lse_a = masked(in_a(s), lw0)

    back = (u, -p0, g, lp_u, lp_x)
    fwd = (u, p0, g, lp_u, lp_x)
    for i in range(L):
        back1 = i < s
        back2 = back1[:, None]

        def sel(a, b):
            return torch.where(back2 if a.dim() == 2 else back1, a, b)

        u_c, p_c, g_c = sel(back[0], fwd[0]), sel(back[1], fwd[1]), sel(back[2], fwd[2])
        ph = p_c + 0.5 * e * g_c
        un = u_c + e * ph
        lpn_u, lpn_x, gn = vg(un)
        pn = ph + 0.5 * e * gn
        new_vals = (un, pn, gn, lpn_u, lpn_x)
        back = tuple(sel(n, o) for n, o in zip(new_vals, back))
        fwd = tuple(sel(o, n) for n, o in zip(new_vals, fwd))
        t = torch.where(back1, s - (i + 1), torch.full_like(s, i + 1))
        lw = log_w(lpn_u, pn)
        score = lw + gumbel(i + 1)
        best_r = upd_best(best_r, in_r(t), score, un, lpn_u, lpn_x, gn,
                          torch.where(back2, pn, -pn))
        best_a = upd_best(best_a, in_a(t), score, un, lpn_u, lpn_x, gn, pn)
        lse_r = torch.logaddexp(lse_r, masked(in_r(t), lw))
        lse_a = torch.logaddexp(lse_a, masked(in_a(t), lw))
    if window == 0:
        chosen = best_a
        acc_stat = torch.exp(torch.clamp(lse_a - math.log(L + 1.0) - lw0, max=0.0)).mean()
    else:
        log_acc = torch.clamp(lse_a - lse_r, max=0.0)
        accept = torch.log(acc_u) < log_acc
        chosen = tuple(
            torch.where(accept[:, None] if a.dim() == 2 else accept, a, r)
            for a, r in zip(best_a, best_r)
        )
        acc_stat = torch.exp(log_acc).mean()
    _, u, lp_u, lp_x, g, p_next = chosen
    return u, p_next, lp_u, lp_x, g, acc_stat


def _uniform(gen, shape, dtype, device, lo=0.0, hi=1.0):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=dtype, device=device)


def _mh_phase(vg, tf, bounded, u0, gen, log_eps0, *, nsteps, n_leapfrog,
              adapt, target_accept, traj_jitter, da0=None, probe=False):
    """``nsteps`` endpoint-MH steps from ``u0``.

    Returns ``(xs (nsteps, m, d), lp_x (nsteps, m), acc (nsteps,), u_final,
    da)`` with ``da = (hbar, log_eps, log_eps_bar, t)`` the dual-averaging
    state (with ``adapt=False`` the step size stays ``log_eps0``).  With
    ``probe`` the steps are :func:`probe_transition`s at ``l_max =
    n_leapfrog`` and ``xs`` holds the u-space positions.
    """
    dtype, dev = u0.dtype, u0.device
    u = u0
    lp_u, lp_x, g = vg(u)
    mu_da = log_eps0 + math.log(10.0)
    hbar, log_eps, log_eps_bar, t = da0 if da0 is not None else (0.0, log_eps0, log_eps0, 0.0)
    m = u.shape[0]
    xs, lps, accs = [], [], []
    for step in range(nsteps):
        with span("hic.step"):
            e = math.exp(log_eps) * _uniform(gen, (m, 1), dtype, dev, 0.9, 1.1)
            p0 = torch.randn(u.shape, generator=gen, dtype=dtype, device=dev)
            if traj_jitter > 0 and not probe:
                lo_L = max(n_leapfrog - traj_jitter, 1)
                L = torch.randint(lo_L, n_leapfrog + 1, (m,), generator=gen, device=dev)
            else:
                L = None
            log_unif = torch.log(_uniform(gen, (m,), dtype, dev))
            if probe:
                u, lp_u, lp_x, g, acc_prob = probe_transition(
                    vg, u, lp_u, lp_x, g, e, p0, step, n_leapfrog, log_unif
                )
            else:
                u, lp_u, lp_x, g, acc_prob = mh_transition(
                    vg, u, lp_u, lp_x, g, e, p0, L, n_leapfrog, log_unif
                )
            with span("hic.readback"):
                acc = float(acc_prob)
            if adapt:
                t = t + 1.0
                hbar = (1 - 1 / (t + 10.0)) * hbar + (target_accept - acc) / (t + 10.0)
                log_eps = mu_da - math.sqrt(t) / 0.05 * hbar
                w = t**-0.75
                log_eps_bar = w * log_eps + (1 - w) * log_eps_bar
            xs.append(u if probe else _u_to_x(u, tf, bounded)[0])
            lps.append(lp_x)
            accs.append(acc)
    return (torch.stack(xs), torch.stack(lps), np.asarray(accs), u,
            (hbar, log_eps, log_eps_bar, t))


def _trajectory_phase(vg, tf, bounded, u0, gen, log_eps, *, nsteps,
                      n_leapfrog, window, persist):
    """Production phase of the windowed / multinomial kernel."""
    if window < 0 or 2 * window > n_leapfrog + 1:
        raise ValueError(
            f"window must satisfy 0 <= 2*window <= n_leapfrog + 1 "
            f"(got window={window}, n_leapfrog={n_leapfrog})"
        )
    if persist > 0.0 and window == 0:
        raise ValueError("persist > 0 requires the windowed scheme")
    dtype, dev = u0.dtype, u0.device
    tiny = torch.finfo(dtype).tiny
    u = u0
    m = u.shape[0]
    lp_u, lp_x, g = vg(u)
    p = torch.randn(u.shape, generator=gen, dtype=dtype, device=dev)
    eps = math.exp(log_eps)
    s_hi = (n_leapfrog + 1) if window == 0 else window
    xs, lps, accs = [], [], []
    for _ in range(nsteps):
        with span("hic.step"):
            e = eps * _uniform(gen, (m, 1), dtype, dev, 0.9, 1.1)
            xi = torch.randn(u.shape, generator=gen, dtype=dtype, device=dev)
            s = torch.randint(0, s_hi, (m,), generator=gen, device=dev)
            gumbel_u = _uniform(gen, (n_leapfrog + 1, m), dtype, dev).clamp(min=tiny)
            acc_u = _uniform(gen, (m,), dtype, dev).clamp(min=tiny)
            u, p, lp_u, lp_x, g, acc = trajectory_transition(
                vg, u, p, lp_u, lp_x, g, e, xi, s, gumbel_u, acc_u,
                n_leapfrog=n_leapfrog, window=window, persist=persist,
            )
            xs.append(_u_to_x(u, tf, bounded)[0])
            lps.append(lp_x)
            with span("hic.readback"):
                accs.append(float(acc))
    return torch.stack(xs), torch.stack(lps), np.asarray(accs), u


def _adaptive_phase(vg, tf, bounded, u0, gen, log_eps_anchor, *, n_leapfrog,
                    target_accept, traj_jitter):
    """One warmup phase with the automatic stopping rule (``warmup="auto"``).

    Adapts in ``_WARMUP_CHUNK``-step chunks, carrying the dual-averaging
    state, and stops once the averaged log step size moved less than
    ``_WARMUP_EPS_TOL`` over a chunk with the chunk's acceptance within
    ``_WARMUP_ACC_TOL`` of the target (2 to 16 chunks).  Returns ``(xs_all
    numpy, u_final, log_eps_bar, nsteps_done, last_acc)``.
    """
    xs_chunks = []
    u, da = u0, None
    prev_bar = None
    delta_bar = float("nan")
    stopped = False
    for c in range(_WARMUP_MAX_CHUNKS):
        xs, _, accs, u, da = _mh_phase(
            vg, tf, bounded, u, gen, log_eps_anchor, nsteps=_WARMUP_CHUNK,
            n_leapfrog=n_leapfrog, adapt=True, target_accept=target_accept,
            traj_jitter=traj_jitter, da0=da,
        )
        xs_chunks.append(xs.cpu().numpy())
        bar = da[2]
        acc = float(np.mean(accs))
        delta_bar = abs(bar - prev_bar) if prev_bar is not None else float("nan")
        if (c + 1 >= _WARMUP_MIN_CHUNKS and prev_bar is not None
                and delta_bar < _WARMUP_EPS_TOL
                and abs(acc - target_accept) < _WARMUP_ACC_TOL):
            stopped = True
            break
        prev_bar = bar
    nsteps_done = len(xs_chunks) * _WARMUP_CHUNK
    logger.info(
        "HMC auto warmup phase: %d steps (eps_bar %.4f, last-chunk "
        "acceptance %.3f)", nsteps_done, math.exp(bar), acc,
    )
    if not stopped:
        logger.warning(
            "HMC auto warmup phase exhausted the %d-step cap without "
            "stabilizing (|delta log eps_bar| %.4f vs tol %.2g, acceptance "
            "%.3f vs target %.2f +- %.2f); production may be poorly adapted "
            "-- consider a fixed, larger warmup.",
            _WARMUP_MAX_CHUNKS * _WARMUP_CHUNK, delta_bar, _WARMUP_EPS_TOL,
            acc, target_accept, _WARMUP_ACC_TOL,
        )
    return np.concatenate(xs_chunks, axis=0), u, bar, nsteps_done, acc


def run_hmc(
    log_prob_fn: Callable,
    x0,
    nsteps: int,
    seed: int = 0,
    *,
    state=None,
    lo=None,
    hi=None,
    n_leapfrog: int | str = 8,
    warmup: int | str = 128,
    warmup_leapfrog: int | None = None,
    warmup_walkers: int | None = None,
    eps0: float = 0.1,
    target_accept: float = 0.8,
    traj_jitter: int = 1,
    l_max: int = 16,
    probe_steps: int = 64,
    warm_start: HMCResult | None = None,
    scheme: str = "mh",
    window: int | None = None,
    persist: float = 0.0,
    mesh=None,
    device=None,
    dtype=None,
) -> HMCResult:
    """Run preconditioned HMC: warmup (metric + step size), then ``nsteps``
    production steps from walker positions ``x0`` (nwalkers, ndim).

    ``log_prob_fn(state, x)`` maps an (m, ndim) tensor to (m,) and must be
    differentiable by autograd; with ``state=None`` it is called as
    ``log_prob_fn(x)``.  ``lo``/``hi`` activate the bounded (logit)
    reparametrization; samples are returned in x-space as numpy arrays.
    Knobs and their semantics follow the JAX package's ``run_hmc``
    (warmup at ``max(n_leapfrog // 2, 1)`` leapfrog steps unless
    ``warmup_leapfrog`` is given; ``traj_jitter`` draws per-walker lengths
    from ``{max(L - traj_jitter, 1), ..., L}``; ``window`` defaults to
    ``min(2, (L + 1) // 2)``).

    ``n_leapfrog="auto"``: warmup runs at ``max(l_max // 2, 1)``, then a
    probe of ``probe_steps`` steps at the rotating lengths ``1 .. l_max``
    picks the production length (:func:`_select_leapfrog`, reported as
    ``result.n_leapfrog``).  An explicit ``window`` is checked for
    ``window >= 1`` before any warmup runs; its upper limit ``2 window <=
    L + 1`` is checked once ``L`` is known.

    ``warm_start``: an :class:`HMCResult` of an earlier run on the same
    posterior.  Its metric, step size and (under ``"auto"``) length are
    reused and every adaptation phase is skipped (``warmup_steps == 0``);
    ``scheme="auto"`` decides on its production acceptance.  An integer
    ``n_leapfrog`` overrides its length.

    All randomness comes from one generator seeded with ``seed`` on
    ``device`` (default CUDA).

    ``mesh``: a :class:`..parallel.mesh.WalkerMesh` over which the walkers'
    posterior value-and-gradient evaluations are sharded (replicas of the
    posterior built once per run); the walker count and ``warmup_walkers`` must
    divide over it.  The warmed subset is tiled up to the full batch as
    without a mesh.
    """
    if scheme not in ("mh", "multinomial", "windowed", "auto"):
        raise ValueError(
            f"scheme must be 'auto', 'mh', 'windowed', or 'multinomial', "
            f"got {scheme!r}"
        )
    if not 0.0 <= persist < 1.0:
        raise ValueError(f"persist must be in [0, 1), got {persist}")
    if persist > 0.0 and scheme not in ("windowed", "auto"):
        raise ValueError("persist > 0 requires scheme='windowed' (or 'auto')")
    auto_l = isinstance(n_leapfrog, str)
    if auto_l and n_leapfrog != "auto":
        raise ValueError(f"n_leapfrog must be an int or 'auto', got {n_leapfrog!r}")
    if auto_l and l_max < 1:
        raise ValueError(f"l_max must be >= 1, got {l_max}")
    windowed_asked = scheme == "windowed" or (scheme == "auto" and window is not None)
    if windowed_asked and auto_l:
        # the length is not known before the probe, but a window below 1
        # fails whatever it picks: refuse before any warmup runs
        if window is not None and window < 1:
            raise ValueError(f"window={window} needs 1 <= window")
    elif windowed_asked:
        w_eff = window if window is not None else min(2, (int(n_leapfrog) + 1) // 2)
        if w_eff < 1 or 2 * w_eff > int(n_leapfrog) + 1:
            raise ValueError(
                f"window={w_eff} needs 1 <= window and 2*window <= "
                f"n_leapfrog + 1 (n_leapfrog={n_leapfrog})"
            )
    auto_warmup = isinstance(warmup, str)
    if auto_warmup and warmup != "auto":
        raise ValueError(f"warmup must be an int or 'auto', got {warmup!r}")
    if not auto_warmup and int(warmup) < 1 and warm_start is None:
        raise ValueError(
            f"warmup must be >= 1 (got {warmup}); to skip adaptation pass "
            "warm_start= from a previous HMCResult"
        )
    if state is None:
        fn = log_prob_fn

        def log_prob_fn(_s, x):
            return fn(x)

    dev = resolve_device(device)
    dtype = resolve_dtype(dtype)
    x0 = np.asarray(x0.detach().cpu() if torch.is_tensor(x0) else x0, dtype=np.float64)
    nwalkers, ndim = x0.shape
    if auto_l:
        # the adapted step size must carry over to probe lengths up to l_max
        l_warm = max(l_max // 2, 1)
    elif warmup_leapfrog is not None:
        l_warm = int(warmup_leapfrog)
        if l_warm < 1:
            raise ValueError(f"warmup_leapfrog must be >= 1, got {warmup_leapfrog}")
    else:
        l_warm = max(int(n_leapfrog) // 2, 1)
    n_warm_walk = nwalkers if warmup_walkers is None else int(warmup_walkers)
    if not 1 <= n_warm_walk <= nwalkers:
        raise ValueError(
            f"warmup_walkers must be in [1, nwalkers={nwalkers}], got {warmup_walkers}"
        )
    if mesh is not None:
        from ..parallel.mesh import check_divisible, sharded_log_prob

        check_divisible(mesh, nwalkers, "walkers")
        if warmup_walkers is not None:
            check_divisible(mesh, n_warm_walk, "warmup_walkers")
        sharded = sharded_log_prob(log_prob_fn, mesh, state)
    bounded = lo is not None
    lo_np = np.asarray(lo, np.float64) if bounded else None
    width_np = np.asarray(hi, np.float64) - lo_np if bounded else None
    gen = new_generator(dev, seed)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    def tf_of(mu, chol):
        tf = {"mu": t(mu), "chol": t(chol)}
        if bounded:
            tf["lo"], tf["width"] = t(lo_np), t(width_np)
        return tf

    def vg_of(tf):
        if mesh is not None:
            return make_sharded_value_and_grad(sharded.value_and_grad, tf, bounded)
        return make_value_and_grad(log_prob_fn, state, tf, bounded)

    if warm_start is not None:
        # ---- reuse an earlier run's adaptation: no warmup phase runs
        mu_z = np.asarray(warm_start.precond_mu, np.float64)
        chol_z = np.asarray(warm_start.precond_chol, np.float64)
        if mu_z.shape != (ndim,) or chol_z.shape != (ndim, ndim):
            raise ValueError(
                f"warm_start metric is for ndim={mu_z.shape[0]}, x0 has ndim={ndim}"
            )
        tf = tf_of(mu_z, chol_z)
        vg = vg_of(tf)
        uf = t(_x_to_u(x0, lo_np, width_np, mu_z, chol_z))
        log_eps = math.log(warm_start.step_size)
        n_warm_total = 0
        # the earlier run's production acceptance stands in for the
        # adapted one in the scheme="auto" choice
        adapted_acc = float(np.mean(np.asarray(warm_start.acceptance)))
        if auto_l:
            n_leapfrog = int(warm_start.n_leapfrog)
    else:
        # ---- phase A: identity metric, adapt eps, estimate the metric
        mu0, chol0 = np.zeros(ndim), np.eye(ndim)
        tf = tf_of(mu0, chol0)
        u0 = t(_x_to_u(x0[:n_warm_walk], lo_np, width_np, mu0, chol0))
        log_eps0 = math.log(eps0)
        if auto_warmup:
            xs_np, _, log_eps, n_done, _ = _adaptive_phase(
                vg_of(tf), tf, bounded, u0, gen, log_eps0, n_leapfrog=l_warm,
                target_accept=target_accept, traj_jitter=traj_jitter,
            )
        else:
            xs, _, _, _, da = _mh_phase(
                vg_of(tf), tf, bounded, u0, gen, log_eps0, nsteps=int(warmup),
                n_leapfrog=l_warm, adapt=True, target_accept=target_accept,
                traj_jitter=traj_jitter,
            )
            xs_np, n_done, log_eps = xs.cpu().numpy(), int(warmup), da[2]
        half = xs_np[n_done // 2:].reshape(-1, ndim).astype(np.float64)
        z = _x_to_u(half, lo_np, width_np, mu0, chol0)
        mu_z = z.mean(0)
        cov_z = np.atleast_2d(np.cov(z.T)) + 1e-10 * np.eye(ndim)
        chol_z = np.linalg.cholesky(cov_z)

        # ---- phase B: new metric, re-adapt eps from the phase-A end state
        tf = tf_of(mu_z, chol_z)
        vg = vg_of(tf)
        u0 = t(_x_to_u(xs_np[-1].astype(np.float64), lo_np, width_np, mu_z, chol_z))
        if auto_warmup:
            _, uf, log_eps, n_done_b, adapted_acc = _adaptive_phase(
                vg, tf, bounded, u0, gen, log_eps, n_leapfrog=l_warm,
                target_accept=target_accept, traj_jitter=traj_jitter,
            )
        else:
            _, _, accs_b, uf, da = _mh_phase(
                vg, tf, bounded, u0, gen, log_eps, nsteps=int(warmup),
                n_leapfrog=l_warm, adapt=True, target_accept=target_accept,
                traj_jitter=traj_jitter,
            )
            log_eps, n_done_b = da[2], int(warmup)
            adapted_acc = float(np.mean(accs_b[-max(len(accs_b) // 4, 1):]))
        n_warm_total = n_done + n_done_b

        # ---- probe: calibrate the production trajectory length
        if auto_l:
            us, _, _, uf, _ = _mh_phase(
                vg, tf, bounded, uf, gen, log_eps, nsteps=probe_steps,
                n_leapfrog=l_max, adapt=False, target_accept=target_accept,
                traj_jitter=0, probe=True,
            )
            n_leapfrog = _select_leapfrog(us.cpu().numpy(), l_max)
            logger.info("HMC n_leapfrog='auto': probe of %d steps picked L = %d",
                        probe_steps, n_leapfrog)
        if n_warm_walk < nwalkers:
            uf = uf[torch.arange(nwalkers, device=dev) % n_warm_walk]
    n_leapfrog = int(n_leapfrog)

    # ---- resolve scheme="auto" from the adapted acceptance
    persist_eff = float(persist)
    if scheme == "auto":
        if adapted_acc >= _AUTO_ACC_MIN:
            scheme = "windowed"
            if persist_eff == 0.0:
                persist_eff = _AUTO_PERSIST
        else:
            scheme, persist_eff = "mh", 0.0
        logger.info(
            "HMC scheme='auto': adapted acceptance %.3f -> %s (persist %.2f)",
            adapted_acc, scheme, persist_eff,
        )

    # ---- production: fixed eps
    if scheme in ("multinomial", "windowed"):
        if scheme == "multinomial":
            w_eff = 0
        else:
            # n_leapfrog may come from the probe: check against the final length
            w_eff = window if window is not None else min(2, (n_leapfrog + 1) // 2)
            if w_eff < 1 or 2 * w_eff > n_leapfrog + 1:
                raise ValueError(
                    f"window={w_eff} needs 1 <= window and 2*window <= "
                    f"n_leapfrog + 1 (n_leapfrog={n_leapfrog})"
                )
        xs, lps, accs, _ = _trajectory_phase(
            vg, tf, bounded, uf, gen, log_eps, nsteps=nsteps,
            n_leapfrog=n_leapfrog, window=w_eff, persist=persist_eff,
        )
    else:
        xs, lps, accs, _, _ = _mh_phase(
            vg, tf, bounded, uf, gen, log_eps, nsteps=nsteps,
            n_leapfrog=n_leapfrog, adapt=False, target_accept=target_accept,
            traj_jitter=traj_jitter,
        )
    with span("hic.readback"):
        xs_np = xs.cpu().numpy().astype(np.float64)
    with span("hic.readback"):
        lps_np = lps.cpu().numpy().astype(np.float64)
    return HMCResult(
        chain=np.transpose(xs_np, (1, 0, 2)),
        log_prob=lps_np.T,
        acceptance=accs,
        final_state=xs_np[-1],
        step_size=float(math.exp(log_eps)),
        precond_chol=chol_z,
        precond_mu=mu_z,
        n_leapfrog=n_leapfrog,
        warmup_steps=int(n_warm_total),
        scheme=scheme,
        persist=persist_eff if scheme == "windowed" else 0.0,
    )
