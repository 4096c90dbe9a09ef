"""Timed loop: HMC production over the auto (Woodbury) posterior.

Set-up runs ``samplers/hmc.py::run_hmc`` as ``bench.py`` configures it
(``warmup="auto"`` on a ``warmup_walkers`` subset, ``n_leapfrog`` fixed,
``scheme="windowed"`` with persistent momentum), one production chunk at
the cell's walker count, which warms every shape the window uses, and
``burnin_chunks`` more, so that the window samples a chain past its
burn-in (``hmc_ess_per_s`` reads the window's chain alone).  The window
chains production chunks of ``chunk_steps`` steps by ``warm_start``
(each chunk a ``run_hmc`` call from the last one's walkers, with its own
seed) until ``--seconds`` have passed, and stops at the end of a chunk.

The timed path's own outputs are checked: a sample, drawn from the seed,
of the value-and-gradient calls that the leapfrog made in the window
(their whitened positions u, the sampler's metric, ``lp_x`` and the
gradient), ``check_walkers`` walkers of each drawn from the seed, held
against the reference's at the same u, and whether every walker moved.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import check as chk
from benchmark.harness.autocorr import max_tau
from benchmark.harness.calls import CallSample, PosteriorCalls, sub_seed, sync
from benchmark.harness.problem import build_chain
from benchmark.harness.trace import WINDOW_SPAN, traced
from benchmark.reference.posterior import Posterior, evaluate_u

MODE = "auto"


def _kwargs(run, t):
    return dict(state=run.like_state, lo=run.chain.min, hi=run.chain.max,
                n_leapfrog=int(t["n_leapfrog"]), scheme="windowed",
                persist=float(t["persist"]), device=run.device, dtype=torch.float32)


def setup(run) -> None:
    from gpbayestools_hic_tpu_torch.samplers import hmc

    t = run.workload["traffic_params"]
    run.chain = build_chain(run.problem, run.cfg, run.tmpdir, run.device, MODE)
    log_post, run.like_state = run.chain.posterior_with_state()
    run.calls = PosteriorCalls(log_post)
    run.sample = CallSample(int(t["check_calls"]), sub_seed(run.seed, 3))

    # observe the leapfrog's value-and-gradient calls (references only)
    make = hmc.make_value_and_grad

    def observed(log_prob_fn, state, tf, bounded):
        vg = make(log_prob_fn, state, tf, bounded)

        def value_and_grad_u(u):
            lp_u, lp_x, g = vg(u)
            run.sample.offer((u, tf["mu"], tf["chol"], lp_u, lp_x, g))
            return lp_u, lp_x, g

        return value_and_grad_u

    run.restore = (hmc, "make_value_and_grad", make)
    hmc.make_value_and_grad = observed
    gen = np.random.default_rng(sub_seed(run.seed, 1))
    x0 = gen.uniform(run.chain.min, run.chain.max, (int(t["walkers"]), run.chain.ndim))
    run.res = hmc.run_hmc(
        run.calls, x0, int(t["chunk_steps"]), sub_seed(run.seed, 2),
        warmup="auto", warmup_walkers=int(t["warmup_walkers"]), **_kwargs(run, t))
    run.chunk = 1
    for _ in range(int(t["burnin_chunks"])):
        run.res = _chunk(run, t)
    sync(run.device)


def _chunk(run, t):
    from gpbayestools_hic_tpu_torch.samplers import hmc

    res = hmc.run_hmc(run.calls, run.res.final_state, int(t["chunk_steps"]),
                      sub_seed(run.seed, 100 + run.chunk), warm_start=run.res,
                      **_kwargs(run, t))
    run.chunk += 1
    return res


def window(run, seconds: float, trace: bool) -> dict:
    t = run.workload["traffic_params"]
    steps = int(t["chunk_steps"])
    run.x_start = run.res.final_state.copy()
    chains, lps, accs, out = [], [], [], {}
    run.sample.active = True
    t0 = time.perf_counter()
    if trace:
        run.calls.counting = run.calls.spans = True
        with traced(True) as prof:
            with torch.profiler.record_function(WINDOW_SPAN):
                run.res = _chunk(run, t)
                sync(run.device)
        run.calls.counting = run.calls.spans = False
        chains.append(run.res.chain)
        lps.append(run.res.log_prob)
        accs.append(run.res.acceptance)
        out.update(prof=prof, traced_steps=steps, calls=dict(run.calls.counts))
    times = []
    while time.perf_counter() - t0 < seconds:
        tc = time.perf_counter()
        run.res = _chunk(run, t)
        times.append(time.perf_counter() - tc)
        chains.append(run.res.chain)
        lps.append(run.res.log_prob)
        accs.append(run.res.acceptance)
    elapsed = time.perf_counter() - t0
    run.sample.active = False
    chain = np.concatenate(chains, axis=1)
    nwalkers, nsteps = chain.shape[:2]
    run.x_end = run.res.final_state
    run.attempted = nwalkers * nsteps
    run.failed = int(np.sum(~np.isfinite(np.concatenate(lps, axis=1))))
    tau = max_tau(chain)
    out.update(
        seconds=elapsed, steps=nsteps, walkers=nwalkers, tau=tau,
        step_size=run.res.step_size, chunk_s=times,
        acceptance=float(np.mean(np.concatenate(accs))),
        e2e={"hmc_samples_per_s": nwalkers * nsteps / elapsed,
             "hmc_ess_per_s": nwalkers * nsteps / tau / elapsed},
    )
    return out


def release(run) -> None:
    """Drop the program's state; keep only what the check reads."""
    kept = [tuple(a.detach().cpu() for a in item) for item in run.sample.kept]
    run.sample.kept = kept
    setattr(*run.restore)
    del run.chain, run.like_state, run.calls, run.res


def check(run, control: bool = False) -> dict:
    """``{"numbers": ..., "control": ..., "checked": positions}``: the
    numbers compared, and with ``control`` the same numbers with the
    reference computed in float32 with TF32 products in the program's
    place."""
    ref = Posterior(run.problem, run.cfg, device=run.device)
    ctl = Posterior(run.problem, run.cfg, device=run.device, dtype=torch.float32,
                    tf32=True) if control else None
    lp_port, lp_ref, g_port, g_ref, lp_ctl, g_ctl = [], [], [], [], [], []
    pick = np.random.default_rng(sub_seed(run.seed, 4))
    k = int(run.workload["traffic_params"]["check_walkers"])
    for item in run.sample.kept:
        rows = torch.as_tensor(np.sort(pick.choice(item[0].shape[0], k, replace=False)))
        u, lp_x, g = item[0][rows], item[4][rows], item[5][rows]
        mu, chol = item[1], item[2]
        _, lpx_r, g_r = evaluate_u(ref, u.double(), mu.double(), chol.double())
        lp_ref.append(lpx_r)
        g_ref.append(g_r)
        lp_port.append(lp_x.double().numpy())
        g_port.append(g.double().numpy())
        if ctl is not None:
            _, lpx_c, g_c = evaluate_u(ctl, u, mu, chol)
            lp_ctl.append(lpx_c)
            g_ctl.append(g_c)
    lp_ref, g_ref = np.concatenate(lp_ref), np.concatenate(g_ref)
    out = {"numbers": {
        "lp_gap": chk.lp_gap(np.concatenate(lp_port), lp_ref),
        "grad_gap": chk.grad_gap(np.concatenate(g_port), g_ref),
        "stuck_share": chk.stuck_share(run.x_start, run.x_end, run.problem["hi"] - run.problem["lo"]),
    }, "control": None, "checked": int(lp_ref.shape[0])}
    if ctl is not None:
        out["control"] = {"lp_gap": chk.lp_gap(np.concatenate(lp_ctl), lp_ref),
                          "grad_gap": chk.grad_gap(np.concatenate(g_ctl), g_ref)}
    return out
