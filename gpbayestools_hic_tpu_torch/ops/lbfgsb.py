"""Box-constrained L-BFGS over a batch of independent problems.

Port of the JAX package's ``ops/lbfgsb.py``: projected-gradient L-BFGS
with a circular ``(s, y)`` history, a projected backtracking Armijo line
search, curvature-guarded history updates, and convergence on the
projected-gradient infinity norm or on scipy's ``factr`` improvement rule.

The JAX optimizer is one ``lax.while_loop`` that callers ``vmap`` over
restarts and GPs.  Here the batch is explicit: every tensor carries a
leading lane axis, ``fun`` maps (B, p) to (B,), and one
``torch.autograd.grad`` of the sum gives every lane's gradient (the lanes
are independent).  The loop keeps ``vmap``'s semantics: a lane that is done
is frozen, a lane whose line search accepted keeps its accepted trial while
the others go on searching, and the loop ends when every lane is done or at
``maxiter``.  Each lane therefore takes the path it would take alone.

Every decision is selected per lane with ``torch.where``, never by
multiplying with a mask, so a rejected trial's NaN gradient stays in its
own lane.  The host learns whether to go on once per line-search trial:
each trial reads one two-flag tensor (any lane still searching, any lane
still running after this iteration), and nothing else in the loop waits
for the device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class LBFGSBResult(NamedTuple):
    x: torch.Tensor          # (B, p) final iterates
    fun: torch.Tensor        # (B,) final objective values
    num_iters: torch.Tensor  # (B,) iterations taken
    converged: torch.Tensor  # (B,) bool


class _State(NamedTuple):
    k: torch.Tensor          # (B,) iteration counters
    x: torch.Tensor          # (B, p)
    f: torch.Tensor          # (B,)
    g: torch.Tensor          # (B, p)
    s_hist: torch.Tensor     # (B, m, p)
    y_hist: torch.Tensor     # (B, m, p)
    rho_hist: torch.Tensor   # (B, m)
    num_corrs: torch.Tensor  # (B,) number of correction pairs stored so far
    gamma: torch.Tensor      # (B,) initial Hessian scaling
    t0: torch.Tensor         # (B,) warm-started initial line-search step
    stalled: torch.Tensor    # (B,) bool: stopped via the ftol improvement rule
    done: torch.Tensor       # (B,) bool


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _rows(hist: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """hist[b, idx[b]] for every lane b: (B, m, p) -> (B, p)."""
    return torch.gather(hist, 1, idx[:, None, None].expand(-1, 1, hist.shape[2]))[:, 0]


def _two_loop(state: _State, m: int) -> torch.Tensor:
    """Two-loop recursion: approximate -H^{-1} g from each lane's history."""
    q = state.g
    nc = state.num_corrs
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    alphas = torch.zeros(q.shape[0], m, dtype=q.dtype, device=q.device)
    for i in range(m):
        # newest pair first: logical index num_corrs-1-i in the rolled buffer
        idx = torch.remainder(nc - 1 - i, m)
        valid = i < nc
        rho = torch.gather(state.rho_hist, 1, idx[:, None])[:, 0]
        alpha = torch.where(valid, rho * _dot(_rows(state.s_hist, idx), q), zero)
        q = q - alpha[:, None] * _rows(state.y_hist, idx)
        alphas = alphas.scatter(1, idx[:, None], alpha[:, None])
    r = state.gamma[:, None] * q
    ncm = torch.clamp(nc, max=m)
    for i in range(m):
        idx = torch.remainder(nc - ncm + i, m)
        valid = i < ncm
        rho = torch.gather(state.rho_hist, 1, idx[:, None])[:, 0]
        beta = torch.where(valid, rho * _dot(_rows(state.y_hist, idx), r), zero)
        a_i = torch.gather(alphas, 1, idx[:, None])[:, 0]
        r = r + torch.where(valid, a_i - beta, zero)[:, None] * _rows(state.s_hist, idx)
    return -r


def lbfgsb_minimize(
    fun: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    lower: torch.Tensor,
    upper: torch.Tensor,
    *,
    maxiter: int = 200,
    history: int = 10,
    tol: float | None = None,
    ftol: float | None = None,
    max_linesearch: int = 25,
    ls_growth: float = 2.0,
    stats: dict | None = None,
) -> LBFGSBResult:
    """Minimize each lane of ``fun`` over the box [lower, upper] from ``x0``.

    ``x0`` is (B, p); ``lower`` / ``upper`` broadcast against it.  ``fun``
    maps (B, p) to (B,) and must be differentiable with autograd, each
    output depending on its own row only.  Non-finite objective values
    during the line search are rejected steps, so a failed Cholesky at an
    extreme hyperparameter only shortens that lane's step.

    ``tol`` (projected-gradient infinity norm) defaults by dtype: 1e-6 in
    float64, 1e-4 in float32.  ``ftol`` (scipy L-BFGS-B ``factr``
    semantics: stop after an accepted step with ``f_old - f_new <= ftol *
    max(|f_old|, |f_new|, 1)``) defaults to 2.2e-9 in float64 and 2.4e-6
    in float32; in float32 it is the stop that fires.  Each line search
    starts at ``min(1, ls_growth * last accepted step)``.

    ``stats``, when given, receives the counts of the run: ``iterations``
    (the largest lane count), ``trials`` (batched objective evaluations,
    the first included), ``host_syncs`` and ``converged`` lanes.
    """
    m = history
    f64 = x0.dtype == torch.float64
    if tol is None:
        tol = 1e-6 if f64 else 1e-4
    if ftol is None:
        ftol = 1e7 * 2.22e-16 if f64 else 20 * 1.19e-7
    dtype, device = x0.dtype, x0.device
    nlanes, d = x0.shape
    lower = torch.as_tensor(lower, dtype=dtype, device=device).expand_as(x0)
    upper = torch.as_tensor(upper, dtype=dtype, device=device).expand_as(x0)
    counts = {"iterations": 0, "trials": 0, "host_syncs": 0}

    def clip(x):
        return torch.minimum(torch.maximum(x, lower), upper)

    def vg(x):
        counts["trials"] += 1
        with torch.enable_grad():
            xr = x.detach().requires_grad_(True)
            f = fun(xr)
            (g,) = torch.autograd.grad(f.sum(), xr)
        return f.detach(), g.detach()

    def proj_grad_norm(x, g):
        return torch.abs(x - clip(x - g)).amax(-1)

    x0 = clip(x0)
    f0, g0 = vg(x0)
    lane = dict(dtype=dtype, device=device)
    state = _State(
        k=torch.zeros(nlanes, dtype=torch.int64, device=device),
        x=x0, f=f0, g=g0,
        s_hist=torch.zeros(nlanes, m, d, **lane),
        y_hist=torch.zeros(nlanes, m, d, **lane),
        rho_hist=torch.zeros(nlanes, m, **lane),
        num_corrs=torch.zeros(nlanes, dtype=torch.int64, device=device),
        gamma=torch.ones(nlanes, **lane),
        t0=torch.ones(nlanes, **lane),
        stalled=torch.zeros(nlanes, dtype=torch.bool, device=device),
        done=~torch.isfinite(f0) | (proj_grad_norm(x0, g0) < tol),
    )
    one = torch.ones((), **lane)
    zero = torch.zeros((), **lane)
    armijo_c1 = 1e-4

    def finish(state: _State, active, t_next, x_new, f_new, g_try, ok) -> _State:
        """The iteration's update once the line search has ended, selected
        into the lanes that were still running."""
        t_acc = 2.0 * t_next  # the search halves t after every trial
        t0_next = torch.where(ok, torch.clamp(ls_growth * t_acc, 1e-8, 1.0), one)
        # a fully clipped trial (dx == 0) passes Armijo but makes no progress
        ok = ok & (x_new != state.x).any(-1)
        # failed search: stay put; clear the history and retry from steepest
        # descent, and stop only when even that fails
        retry = ~ok & (state.num_corrs > 0)
        x_new = torch.where(ok[:, None], x_new, state.x)
        f_new = torch.where(ok, f_new, state.f)
        g_new = torch.where(ok[:, None], g_try, state.g)
        s = x_new - state.x
        y = g_new - state.g
        sy = _dot(s, y)
        curv_ok = ok & (sy > 1e-10 * torch.linalg.vector_norm(s, dim=-1)
                        * torch.linalg.vector_norm(y, dim=-1) + 1e-38)
        slot = torch.remainder(state.num_corrs, m)
        at_slot = (torch.arange(m, device=device)[None, :] == slot[:, None]) & curv_ok[:, None]
        s_hist = torch.where(at_slot[:, :, None], s[:, None, :], state.s_hist)
        y_hist = torch.where(at_slot[:, :, None], y[:, None, :], state.y_hist)
        rho = 1.0 / torch.where(sy == 0, one, sy)
        rho_hist = torch.where(at_slot, rho[:, None], state.rho_hist)
        num_corrs = state.num_corrs + curv_ok.to(torch.int64)
        gamma = torch.where(curv_ok, sy / torch.clamp(_dot(y, y), min=1e-38), state.gamma)
        num_corrs = torch.where(retry, 0, num_corrs)
        gamma = torch.where(retry, one, gamma)
        pg_converged = proj_grad_norm(x_new, g_new) < tol
        f_stalled = ok & (
            (state.f - f_new)
            <= ftol * torch.clamp(torch.maximum(state.f.abs(), f_new.abs()), min=1.0)
        )
        done = (~ok & ~retry) | pg_converged | f_stalled
        new = _State(
            k=state.k + 1, x=x_new, f=f_new, g=g_new, s_hist=s_hist,
            y_hist=y_hist, rho_hist=rho_hist, num_corrs=num_corrs, gamma=gamma,
            t0=t0_next, stalled=state.stalled | f_stalled, done=done,
        )
        # lanes that were done before this iteration stay frozen
        return _State(*(
            torch.where(active.view(-1, *([1] * (a.dim() - 1))), a, b)
            for a, b in zip(new, state)
        ))

    counts["host_syncs"] += 1
    running = maxiter > 0 and bool((~state.done).any())
    while running:
        active = ~state.done
        p = _two_loop(state, m)
        # fall back to steepest descent on non-descent directions
        descent = (_dot(p, state.g) < 0.0) & torch.isfinite(p).all(-1)
        p = torch.where(descent[:, None], p, -state.g)

        def trial(t):
            x_try = clip(state.x + t[:, None] * p)
            f_try, g_try = vg(x_try)
            # Armijo on the projected displacement, its directional term
            # clamped at 0 so that a clip-distorted step never accepts an
            # increase
            ok = torch.isfinite(f_try) & (
                f_try <= state.f + armijo_c1 * torch.clamp(_dot(state.g, x_try - state.x), max=0.0)
            )
            return x_try, f_try, g_try, ok

        t = state.t0
        x_try, f_try, g_try, ok = trial(t)
        t = t * 0.5
        n_ls = 1
        while True:
            searching = active & ~ok & (n_ls < max_linesearch)
            # the update as it stands if no lane searches on; its `done`
            # and `searching` come back in one read
            new = finish(state, active, t, x_try, f_try, g_try, ok)
            flags = torch.stack([searching.any(), (~new.done).any()]).tolist()
            counts["host_syncs"] += 1
            if not flags[0]:
                break
            x2, f2, g2, ok2 = trial(t)
            x_try = torch.where(searching[:, None], x2, x_try)
            f_try = torch.where(searching, f2, f_try)
            g_try = torch.where(searching[:, None], g2, g_try)
            ok = torch.where(searching, ok2, ok)
            t = torch.where(searching, t * 0.5, t)
            n_ls += 1
        state = new
        counts["iterations"] += 1
        running = flags[1] and counts["iterations"] < maxiter

    # converged: the projected gradient met the tolerance or the ftol rule
    # stopped the lane -- not merely that the loop ended
    converged = ((proj_grad_norm(state.x, state.g) < tol) | state.stalled) & torch.isfinite(state.f)
    if stats is not None:
        stats.update(counts, converged=int(converged.sum()))
    return LBFGSBResult(x=state.x, fun=state.f, num_iters=state.k, converged=converged)
