"""Timed loop: the stretch-move ensemble sampler over a dense likelihood.

``samplers/ensemble.py::run_ensemble``, what ``Chain.run_mcmc`` drives,
over the posterior that the cell's ``mode`` selects (``"generic"``: a
dense matrix per emulator's block and walker; ``"stitched"``: one matrix
of all observables per walker).  Each step evaluates the posterior twice,
on a half of the walkers each.  Set-up draws the walkers from the prior
and runs ``warmup_steps`` steps, which warms every shape the window uses;
the window runs chunks of ``chunk_steps`` steps, each a ``run_ensemble``
call carrying the step offset (as ``Chain.run_mcmc``'s status chunks do),
until ``--seconds`` have passed, and stops at the end of a chunk.  The
samples per second go under the cell's ``rate_metric``.

The check holds a sample, drawn from the seed, of the window's samples
(the positions and the log posterior that the timed path produced for
them) against the reference at those positions, and whether every walker
moved.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import check as chk
from benchmark.harness.calls import PosteriorCalls, sub_seed, sync
from benchmark.harness.problem import build_chain
from benchmark.harness.trace import WINDOW_SPAN, traced
from benchmark.reference.posterior import Posterior, evaluate


def setup(run) -> None:
    from gpbayestools_hic_tpu_torch.samplers.ensemble import run_ensemble

    t = run.workload["traffic_params"]
    run.chain = build_chain(run.problem, run.cfg, run.tmpdir, run.device, t["mode"])
    log_post, run.like_state = run.chain.posterior_with_state()
    run.calls = PosteriorCalls(log_post)
    gen = np.random.default_rng(sub_seed(run.seed, 1))
    x0 = gen.uniform(run.chain.min, run.chain.max, (int(t["walkers"]), run.chain.ndim))
    run.seed_run = sub_seed(run.seed, 2)
    run.done = int(t["warmup_steps"])
    res = run_ensemble(run.calls, torch.as_tensor(x0, dtype=torch.float32, device=run.device),
                       run.done, run.seed_run, state=run.like_state, move="stretch")
    run.x = res.final_state
    sync(run.device)


def _chunk(run, t):
    from gpbayestools_hic_tpu_torch.samplers.ensemble import run_ensemble

    steps = int(t["chunk_steps"])
    res = run_ensemble(run.calls, run.x, steps, run.seed_run, state=run.like_state,
                       move="stretch", step_offset=run.done)
    sync(run.device)
    run.done += steps
    run.x = res.final_state
    return res


def window(run, seconds: float, trace: bool) -> dict:
    t = run.workload["traffic_params"]
    run.x_start = run.x.clone()
    chains, lps, out = [], [], {}
    t0 = time.perf_counter()
    if trace:
        run.calls.counting = run.calls.spans = True
        with traced(True) as prof:
            with torch.profiler.record_function(WINDOW_SPAN):
                res = _chunk(run, t)
        run.calls.counting = run.calls.spans = False
        chains.append(res.chain)
        lps.append(res.log_prob)
        out.update(prof=prof, traced_steps=int(t["chunk_steps"]), calls=dict(run.calls.counts))
    times = []
    while time.perf_counter() - t0 < seconds:
        tc = time.perf_counter()
        res = _chunk(run, t)
        times.append(time.perf_counter() - tc)
        chains.append(res.chain)
        lps.append(res.log_prob)
    elapsed = time.perf_counter() - t0
    run.chain_out = torch.cat(chains, dim=1).cpu()
    run.lp_out = torch.cat(lps, dim=1).cpu()
    run.x_end = run.x.cpu()
    nwalkers, nsteps = run.lp_out.shape
    run.attempted = nwalkers * nsteps
    run.failed = int((~torch.isfinite(run.lp_out)).sum())
    out.update(seconds=elapsed, steps=nsteps, walkers=nwalkers, chunk_s=times,
               e2e={t["rate_metric"]: nwalkers * nsteps / elapsed})
    return out


def release(run) -> None:
    del run.chain, run.like_state, run.calls, run.x


def check(run, control: bool = False) -> dict:
    """As in the HMC driver: ``{"numbers", "control", "checked"}``."""
    t = run.workload["traffic_params"]
    nwalkers, nsteps = run.lp_out.shape
    k = min(int(t["check_samples"]), nwalkers * nsteps)
    pick = np.random.default_rng(sub_seed(run.seed, 3)).choice(nwalkers * nsteps, k,
                                                                replace=False)
    w, s = pick // nsteps, pick % nsteps
    x = run.chain_out[w, s]
    lp_port = run.lp_out[w, s].double().numpy()
    ref = Posterior(run.problem, run.cfg, device=run.device)
    lp_ref = evaluate(ref, x.double())
    out = {"numbers": {"lp_gap": chk.lp_gap(lp_port, lp_ref),
                       "stuck_share": chk.stuck_share(run.x_start.cpu().numpy(), run.x_end.numpy(),
                                                      run.problem["hi"] - run.problem["lo"])},
           "control": None, "checked": k}
    if control:
        ctl = Posterior(run.problem, run.cfg, device=run.device, dtype=torch.float32, tf32=True)
        out["control"] = {"lp_gap": chk.lp_gap(evaluate(ctl, x), lp_ref)}
    return out
