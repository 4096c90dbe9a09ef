"""Parallel-tempering Langevin Monte Carlo (PTLMC), surmise semantics.

PyTorch port of the JAX package's ``samplers/ptlmc.py``:

- temperature ladder ``exp(linspace(log maxtemp, log maxtemp/(numtemps+1),
  numtemps))`` followed by ``numchain`` ones;
- pre-optimization: starts ranked by log-posterior plus ``ndim * N(0,1)^2``
  noise, bounded L-BFGS of every chain in whitened coordinates (the chains
  are the lanes of one batched :func:`..ops.lbfgsb.lbfgsb_minimize`, and
  one posterior call over all lanes serves each line-search trial), then a
  jitter off the mode with step-halving acceptance ``delta < 3 * ndim``;
- proposal ``theta' = theta + sqrt(2) * adjrho * (N(0,1) @ hc)`` with
  ``hc = cov^1/2`` of the optimized starts, optionally with the Langevin
  drift and its MH correction (``use_gradients``), tempered MH acceptance,
  5 sequential temperature-swap passes per step, and rho adaptation every
  10 tuning steps;
- 2x tuning steps before ``sampperchain`` production steps; only the
  ``T = 1`` chains are kept.

The JAX sampler is one compiled ``lax.scan`` whose swap pass is a
``lax.fori_loop`` of ``5 (ntemps + nchains)`` dependent swaps.  Here each
step is a host iteration: the proposal and the posterior run on the
device, the swap pass runs in numpy on the host over the ladder (one copy
of the untempered log-posteriors and the draws to the host, one copy of
the permutation back), and :func:`ptlmc_step` takes its random draws as
arguments so that a step can be held against the JAX scan's.  With a
``mesh`` the chains' posterior evaluations (the pre-optimization's trials,
the jitter, every step) are sharded over its devices; the draws, the swap
pass and the adaptation stay as they are.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import new_generator, resolve_device, resolve_dtype
from ..ops.lbfgsb import lbfgsb_minimize
from ..utils.tensors import value_and_grad
from .ensemble import derive_seed

logger = logging.getLogger(__name__)

_SWAP_PASSES = 5


def _temperature_ladder(numtemps: int, numchain: int, maxtemp: float) -> np.ndarray:
    """(numtemps + numchain,) float64: the tempered rungs, then ones."""
    temps = np.exp(
        np.linspace(np.log(maxtemp), np.log(maxtemp) / (numtemps + 1), numtemps)
    )
    return np.concatenate([temps, np.ones(numchain)])


def _temp_exchange(order, lpostf, temps, rtv, log_u):
    """Sequential parallel-tempering swap pass on the host.

    ``lpostf`` are untempered log posteriors indexed by chain id, ``order``
    maps ladder slot -> chain id, ``rtv`` the upper slots of the proposed
    swaps (in ``[1, n)``) and ``log_u`` their log-uniforms.  Returns the
    revised order and the number of swaps made."""
    order = np.array(order, dtype=np.int64)
    lpostf = np.asarray(lpostf, dtype=np.float64)
    inv_t = 1.0 / np.asarray(temps, dtype=np.float64)
    swaps = 0
    for rt, lu in zip(np.asarray(rtv, dtype=np.int64), np.asarray(log_u, dtype=np.float64)):
        a, b = order[rt - 1], order[rt]
        if (lpostf[b] - lpostf[a]) * (inv_t[rt - 1] - inv_t[rt]) > lu:
            order[rt - 1], order[rt] = b, a
            swaps += 1
    return order, swaps


def _preopt(lp_fn, whitened, thetacen, thetas, bound_l, bound_u, *, maxiter, stats=None):
    """Bounded L-BFGS of every chain at once, in whitened coordinates: the
    chains are the optimizer's lanes, and each trial is one posterior call
    with the lanes as walkers.  Returns ``(x (lanes, ndim), -log posterior
    (lanes,))``."""

    def nlp(xw):
        return -lp_fn(thetacen + thetas * xw)

    res = lbfgsb_minimize(nlp, whitened, bound_l, bound_u, maxiter=maxiter, stats=stats)
    return res.x, res.fun


def _jitter(lp_fn, xw_opt, l0, gen, thetacen, thetas, bound_l, bound_u):
    """Move each chain off its optimum: try ``stepadj * r`` with a fresh
    standard normal direction ``r`` per attempt, accept while ``-log
    posterior`` rises less than ``3 ndim``, else halve ``stepadj`` (4 down
    to 1/16: at most 7 attempts).  Each attempt is one posterior call over
    the lanes still searching.  Chain 0 keeps the raw optimum.  Returns
    ``(xw, accepted lanes)``."""
    nlanes, ndim = xw_opt.shape
    stepadj = torch.full((nlanes,), 4.0, dtype=xw_opt.dtype, device=xw_opt.device)
    searching = torch.ones(nlanes, dtype=torch.bool, device=xw_opt.device)
    xw = xw_opt.clone()
    for _ in range(7):
        rv = torch.randn(xw_opt.shape, generator=gen, dtype=xw_opt.dtype, device=xw_opt.device)
        idx = searching.nonzero()[:, 0]
        if idx.numel() == 0:
            break
        trial = torch.minimum(torch.maximum(xw_opt[idx] + stepadj[idx, None] * rv[idx],
                                            bound_l), bound_u)
        with torch.no_grad():
            ok = (-lp_fn(thetacen + thetas * trial) - l0[idx]) < 3.0 * ndim
        xw[idx] = torch.where(ok[:, None], trial, xw[idx])
        stepadj[idx] = torch.where(ok, stepadj[idx], stepadj[idx] / 2.0)
        searching[idx] = ~ok
    xw[0] = xw_opt[0]
    return xw, int(nlanes - searching.sum())


class PTLMCState(NamedTuple):
    thetac: torch.Tensor    # (totnum, ndim)
    fval: torch.Tensor      # (totnum,) tempered log posteriors
    dfval: torch.Tensor     # (totnum, ndim) tempered gradients (zeros without)
    tau: float
    adjrho: torch.Tensor    # (totnum,)
    numtimes: float
    swaps: int = 0          # swaps made so far (a statistic, not dynamics)


def _value_and_grad(lp_fn, x):
    # a sharded posterior brings its twin: each shard's gradient on its device
    vg = getattr(lp_fn, "value_and_grad", None) or value_and_grad(lp_fn)
    f, g = vg(x)
    return f, torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0)


def ptlmc_step(lp_fn, carry: PTLMCState, k: int, rvalo, log_u, rtv, log_u_swap, *,
               temps, temps_np, hc, covmat0, samptunning: int, taracc: float,
               use_gradients: bool) -> PTLMCState:
    """One PTLMC step with injected randomness.

    ``rvalo`` (totnum, ndim) standard normals, ``log_u`` (totnum,)
    log-uniforms of the accept test, ``rtv`` (5 totnum,) swap slots in
    ``[1, totnum)`` and ``log_u_swap`` (5 totnum,) their log-uniforms;
    ``temps`` the ladder on the device, ``temps_np`` the same on the host.
    One copy to the host carries the untempered log posteriors, the accept
    flags and the swap draws; one copy back carries the permutation."""
    thetac, fval, dfval, tau, adjrho, numtimes, swaps = carry
    totnum = thetac.shape[0]
    rval = math.sqrt(2.0) * adjrho[:, None] * (rvalo @ hc)
    thetap = thetac + rval
    if use_gradients:
        thetap = thetap + (adjrho[:, None] ** 2) * (dfval @ covmat0)
        lpp, gp = _value_and_grad(lp_fn, thetap)
        fvalp = lpp / temps
        dfvalp = gp / temps[:, None]
        term1 = rvalo / math.sqrt(2.0)
        term2 = (adjrho[:, None] / 2.0) * ((dfval + dfvalp) @ hc)
        qadj = -(2.0 * (term1 * term2).sum(1) + (term2**2).sum(1))
    else:
        with torch.no_grad():
            fvalp = lp_fn(thetap) / temps
        dfvalp = dfval
        qadj = torch.zeros_like(fvalp)
    accept = log_u < (fvalp - fval + qadj)
    thetac = torch.where(accept[:, None], thetap, thetac)
    fval = torch.where(accept, fvalp, fval)
    if use_gradients:
        dfval = torch.where(accept[:, None], dfvalp, dfval)

    # temperature swaps on the untempered log posteriors, on the host
    fvaln = fval * temps
    host = torch.cat([fvaln, accept.to(fvaln.dtype),
                      rtv.to(device=fvaln.device, dtype=fvaln.dtype),
                      log_u_swap.to(device=fvaln.device, dtype=fvaln.dtype)]).cpu().numpy()
    n_swap = rtv.shape[0]
    numtimes = numtimes + float(host[totnum:2 * totnum].sum()) / totnum
    order, made = _temp_exchange(np.arange(totnum), host[:totnum], temps_np,
                                 host[2 * totnum:2 * totnum + n_swap].round(),
                                 host[2 * totnum + n_swap:])
    order_t = torch.as_tensor(order, device=thetac.device)
    fval = fvaln[order_t] / temps
    thetac = thetac[order_t]
    if use_gradients:
        dfval = (temps[:, None] * dfval)[order_t] / temps[:, None]

    # rho adaptation every 10 tuning steps
    if k < samptunning and k % 10 == 0:
        tau = tau + 1.0 / math.sqrt(1.0 + k / 10.0) * (numtimes / 10.0 - taracc)
        rho = 2.0 * (1.0 + math.tanh(tau))
        adjrho = rho * temps ** (1.0 / 3.0)
        numtimes = 0.0
    return PTLMCState(thetac, fval, dfval, tau, adjrho, numtimes, swaps + made)


def run_ptlmc(
    logpost_fn: Callable,
    draw_fn: Callable[[int], np.ndarray],
    *,
    numtemps: int = 32,
    numchain: int = 16,
    sampperchain: int = 400,
    maxtemp: float = 30.0,
    nstartparameters: int = 1000,
    seed: int = 0,
    state=None,
    taracc: float | None = None,
    use_gradients: bool = False,
    preopt_maxiter: int = 100,
    mesh=None,
    device=None,
    dtype=None,
    stats: dict | None = None,
) -> np.ndarray:
    """Run PTLMC; returns the ``T = 1`` chains (numchain, sampperchain,
    ndim) as float64 numpy.

    ``logpost_fn(state, x)`` (or ``logpost_fn(x)`` with ``state=None``)
    maps an (m, ndim) tensor to (m,), differentiable by autograd when
    ``use_gradients``.  ``draw_fn(n)`` draws ``n`` start candidates on the
    host.  The set-up (ranking, whitening, bounds, proposal covariance)
    is float64 numpy on the host, as in the JAX package.  Randomness: the
    ranking noise from a numpy generator seeded with ``derive_seed(seed,
    1)``, everything else from one ``torch.Generator`` seeded with
    ``seed`` on ``device`` (default CUDA).  ``stats``, when given,
    receives the pre-optimization's counts (``preopt``: iterations,
    trials, converged lanes, host syncs, seconds, each lane's log
    posterior before and after), the jitter's accepted lanes, the swap
    acceptance and the milliseconds per step.

    ``mesh``: a :class:`..parallel.mesh.WalkerMesh` over which every
    posterior evaluation of the (numtemps + numchain) chains is sharded
    (replicas built once per run); that count must divide over it.
    """
    if taracc is None:
        taracc = 0.60 if use_gradients else 0.25
    if state is None:
        base = logpost_fn

        def logpost_fn(_s, x):
            return base(x)

        state = ()  # a placeholder, so a mesh binds it like a real state

    dev = resolve_device(device)
    dtype = resolve_dtype(dtype)

    if mesh is not None:
        from ..parallel.mesh import check_divisible, sharded_log_prob

        check_divisible(mesh, numtemps + numchain, "chains (numtemps + numchain)")
        lp_fn = sharded_log_prob(logpost_fn, mesh, state)
    else:
        def lp_fn(x):
            return logpost_fn(state, x)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    theta0 = np.asarray(draw_fn(nstartparameters), dtype=np.float64)
    ndim = theta0.shape[1]
    totnum = numtemps + numchain
    if nstartparameters < totnum:
        raise ValueError(
            f"nstartparameters ({nstartparameters}) must be >= numtemps + "
            f"numchain ({totnum}): every ladder slot needs a start point"
        )
    temps_np = _temperature_ladder(numtemps, numchain, maxtemp)
    temps = t(temps_np)
    # the device ladder as the host sees it (float32 on the card)
    temps_host = temps.cpu().numpy().astype(np.float64)
    gen = new_generator(dev, seed)
    host_rng = np.random.default_rng(derive_seed(seed, 1))
    info = {}

    # --- pre-optimization (set-up on the host in float64)
    logger.info("Begin PTLMC pre-optimization ...")
    with torch.no_grad():
        lp0 = lp_fn(t(theta0)).cpu().numpy().astype(np.float64)
    noise = ndim * host_rng.standard_normal(nstartparameters) ** 2
    # a NaN log posterior ranks last, not at 0
    order0 = np.argsort(-np.nan_to_num(lp0, nan=-1e300, neginf=-1e300) + noise)
    starts = theta0[order0[:totnum]]
    thetacen_np = starts.mean(axis=0)
    thetas_np = np.maximum(starts.std(axis=0), 1e-8 * starts.std())
    whitened_np = (starts - thetacen_np) / thetas_np
    bound_l_np = np.maximum(-10.0 * np.ones(ndim), whitened_np.min(axis=0))
    bound_u_np = np.minimum(10.0 * np.ones(ndim), whitened_np.max(axis=0))
    thetacen, thetas = t(thetacen_np), t(thetas_np)
    bound_l, bound_u = t(bound_l_np), t(bound_u_np)

    t0 = time.perf_counter()
    opt_stats = {}
    xw_opt, l0 = _preopt(lp_fn, t(whitened_np), thetacen, thetas, bound_l, bound_u,
                         maxiter=preopt_maxiter, stats=opt_stats)
    lp_after = (-l0).cpu().numpy().astype(np.float64)
    opt_stats.update(seconds=time.perf_counter() - t0, lp_before=lp0[order0[:totnum]],
                     lp_after=lp_after)
    info["preopt"] = opt_stats
    logger.info(
        "PTLMC pre-optimization: %d chains, %d iterations, %d trials, %d "
        "converged, %.2f s; log posterior median %.3f -> %.3f, lowest %.3f -> %.3f",
        totnum, opt_stats["iterations"], opt_stats["trials"], opt_stats["converged"],
        opt_stats["seconds"], np.median(opt_stats["lp_before"]), np.median(lp_after),
        np.min(opt_stats["lp_before"]), np.min(lp_after),
    )
    logger.debug("PTLMC pre-optimization, log posterior per chain before %s, after %s",
                 opt_stats["lp_before"], lp_after)
    xw_jit, info["jitter_accepted"] = _jitter(lp_fn, xw_opt, l0, gen, thetacen, thetas,
                                              bound_l, bound_u)
    thetac = thetacen + thetas * xw_jit

    # --- proposal covariance (host float64)
    thetac_np = thetac.cpu().numpy().astype(np.float64)
    covmat0_np = np.atleast_2d(np.cov(thetac_np.T))
    if ndim > 1:
        covmat0_np = 0.9 * covmat0_np + 0.1 * np.diag(np.diag(covmat0_np))
        w, v = np.linalg.eigh(covmat0_np)
        hc_np = v @ np.diag(np.sqrt(np.maximum(w, 0.0))) @ v.T
    else:
        hc_np = np.sqrt(covmat0_np).reshape(1, 1)
    hc, covmat0 = t(hc_np), t(covmat0_np)

    samptunning = int(np.ceil(sampperchain * 2.0))
    total_steps = samptunning + sampperchain
    logger.info(
        "Run PTLMC: %d chains (%d tempered + %d cold), %d tuning + %d "
        "production steps ...", totnum, numtemps, numchain, samptunning, sampperchain,
    )
    tau0 = -1.0
    adjrho0 = 2.0 * (1.0 + math.tanh(tau0)) * temps ** (1.0 / 3.0)
    if use_gradients:
        lpc, gc = _value_and_grad(lp_fn, thetac)
        fval0, dfval0 = lpc / temps, gc / temps[:, None]
    else:
        with torch.no_grad():
            fval0 = lp_fn(thetac) / temps
        dfval0 = torch.zeros_like(thetac)
    carry = PTLMCState(thetac, fval0, dfval0, tau0, adjrho0, 0.0)
    n_swap = _SWAP_PASSES * totnum
    saved = []
    t0 = time.perf_counter()
    for k in range(total_steps):
        rvalo = torch.randn((totnum, ndim), generator=gen, dtype=dtype, device=dev)
        log_u = torch.log(torch.rand((totnum,), generator=gen, dtype=dtype, device=dev))
        rtv = torch.randint(1, totnum, (n_swap,), generator=gen, device=dev)
        log_u_swap = torch.log(torch.rand((n_swap,), generator=gen, dtype=dtype, device=dev))
        carry = ptlmc_step(lp_fn, carry, k, rvalo, log_u, rtv, log_u_swap,
                           temps=temps, temps_np=temps_host, hc=hc, covmat0=covmat0,
                           samptunning=samptunning, taracc=taracc,
                           use_gradients=use_gradients)
        if k >= samptunning:
            saved.append(carry.thetac[numtemps:])
    chain = torch.stack(saved).cpu().numpy().astype(np.float64)
    info["ms_per_step"] = 1e3 * (time.perf_counter() - t0) / total_steps
    info["swap_acceptance"] = carry.swaps / (n_swap * total_steps)
    logger.info("PTLMC: %.2f ms per step, swap acceptance %.3f",
                info["ms_per_step"], info["swap_acceptance"])
    if stats is not None:
        stats.update(info)
    return np.transpose(chain, (1, 0, 2))
