"""Where the time goes in the PyTorch port's flagship posterior (one GPU).

Run from the repository root on a CUDA machine:

    python3 tools/torch_profile_posterior.py [--mode auto|generic|stitched|stitched-wide]

Builds the flagship chain with the port (17 parameters, 9 emulators x 4
PCs on 1000 design points, 544 observables, ``gp_maxiter=0``).  With
``--mode auto`` (the default: the Woodbury posterior that HMC samples) it
measures at 1024 walkers

- kernel launches per posterior value and per posterior gradient;
- wall time per value and per value-and-gradient (host clock around
  synchronized calls, median of repeats);
- a ``torch.profiler`` trace of a few value-and-gradient calls: device
  busy time per call, the device's idle share of the wall time, the number
  of device kernels per call and the top kernels by device time;
- wall time of one windowed-HMC production step (L = 8);
- the same value-and-gradient and HMC-step walls, device busy time and
  device kernels with the Woodbury block's (4, 4) factorization unrolled
  per entry (the JAX package's TPU form, copied here) in place of the
  library factorization the port uses, in turns in one process.

With ``--mode generic`` (dense per-block likelihood) or ``--mode stitched``
(one 544 x 544 matrix per walker), the posterior the ensemble sampler
calls, it measures the value only, on a half-ensemble of 512 walkers (what
each of a step's two calls sees): kernel launches and wall time per call,
the same ``torch.profiler`` breakdown, and the wall time of one
stretch-move step of ``run_ensemble`` at 1024 walkers.  ``--mode
stitched-wide`` does the same on the synthetic chain of ``chip_smoke.py``'s
fifth path: the flagship's blocks twice (18 emulators, 1088 observables,
seed 1), one 1088 x 1088 matrix per walker (the MVN kernel's wide route).

Prints one JSON object as its last line (with the card's name and power
limit).  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BLOCKS = (28, 28, 12, 170, 14, 21, 28, 73, 170)
NWALKERS = 1024


def unrolled_qform_logdet(s, z):
    """``(z^T S^-1 z, log det S)`` with the Cholesky-Crout recurrence written
    out per entry (the JAX package's form for the TPU): the arm that the
    port's library factorization is timed against."""
    import torch

    k = s.shape[-1]
    lo = [[None] * k for _ in range(k)]
    w = [None] * k
    logdet_half = None
    for j in range(k):
        d = s[..., j, j]
        for p in range(j):
            d = d - lo[j][p] * lo[j][p]
        dj = torch.sqrt(d)
        wj = z[..., j]
        for p in range(j):
            wj = wj - lo[j][p] * w[p]
        w[j] = wj / dj
        lg = torch.log(dj)
        logdet_half = lg if logdet_half is None else logdet_half + lg
        for i in range(j + 1, k):
            off = s[..., i, j]
            for p in range(j):
                off = off - lo[i][p] * lo[j][p]
            lo[i][j] = off / dj
    q = w[0] * w[0]
    for j in range(1, k):
        q = q + w[j] * w[j]
    return q, 2.0 * logdet_half


def profile_calls(f, n_prof=5):
    """Device busy ms, wall ms and device kernels per call of ``f``, with
    the top kernels by device time, from a ``torch.profiler`` trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    f()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            f()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = {}
    n_kernels = 0
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            dev_us[e.name] = dev_us.get(e.name, 0.0) + e.time_range.elapsed_us()
            n_kernels += 1
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": 1e3 * wall / n_prof, "busy_ms": sum(dev_us.values()) / 1e3 / n_prof,
            "kernels": n_kernels / n_prof,
            "top": {k[:80]: v / 1e3 / n_prof for k, v in top}}


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--mode", choices=("auto", "generic", "stitched", "stitched-wide"),
                        default="auto")
    mode = parser.parse_args().mode
    if not torch.cuda.is_available():
        print("torch_profile_posterior: no CUDA device", file=sys.stderr)
        return 2
    from gpbayestools_hic_tpu_torch.ops import registry
    from gpbayestools_hic_tpu_torch.samplers import hmc
    from gpbayestools_hic_tpu_torch.samplers.ensemble import run_ensemble
    from gpbayestools_hic_tpu_torch.utils.synthetic import build_synthetic_chain

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "nwalkers": NWALKERS, "mode": mode}
    with tempfile.TemporaryDirectory() as tmp:
        chain, _ = build_synthetic_chain(
            nev=1000, ndim=17, nobs_blocks=BLOCKS * (2 if mode == "stitched-wide" else 1),
            npc=4, gp_maxiter=0, seed=1 if mode == "stitched-wide" else 0, tmpdir=tmp,
            device=dev,
        )
        chain.likelihood_mode = "stitched" if mode == "stitched-wide" else mode
        dense = mode != "auto"
        fn, state = chain.posterior_with_state()
        x_all = torch.tensor(chain.random_pos(NWALKERS, seed=1), dtype=torch.float32, device=dev)
        x = x_all[: NWALKERS // 2] if dense else x_all
        out["walkers_per_call"] = x.shape[0]

        def value():
            with torch.no_grad():
                return fn(state, x)

        def value_and_grad():
            xx = x.clone().requires_grad_(True)
            lp = fn(state, xx)
            (g,) = torch.autograd.grad(lp.sum(), xx)
            return lp, g

        def wall_ms(f, reps=15):
            f()
            torch.cuda.synchronize()
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                f()
                torch.cuda.synchronize()
                ts.append(1e3 * (time.perf_counter() - t0))
            return float(np.median(ts))

        registry.reset_launch_counts()
        value()
        out["launches_per_value"] = dict(registry.LAUNCH_COUNTS)
        out["value_wall_ms"] = wall_ms(value)
        if not dense:
            registry.reset_launch_counts()
            value_and_grad()
            out["launches_per_value_and_grad"] = dict(registry.LAUNCH_COUNTS)
            out["value_and_grad_wall_ms"] = wall_ms(value_and_grad)
        profiled = value if dense else value_and_grad
        out["profiled_call"] = profiled.__name__

        n_prof = 5
        prof = profile_calls(profiled, n_prof)
        busy_ms = prof["busy_ms"]
        out["profile_calls"] = n_prof
        out["profile_wall_ms_per_call"] = prof["wall_ms"]
        out["device_busy_ms_per_call"] = busy_ms
        out["device_idle_share"] = 1.0 - busy_ms / prof["wall_ms"]
        unprofiled = out["value_wall_ms" if dense else "value_and_grad_wall_ms"]
        out["device_idle_share_of_unprofiled_wall"] = 1.0 - busy_ms / unprofiled
        out["device_kernels_per_call"] = prof["kernels"]
        out["top_device_ms_per_call"] = prof["top"]

        if dense:
            # one stretch-move step = two half-ensemble posterior calls
            n_ens = 8
            out["ensemble_step_wall_ms"] = wall_ms(
                lambda: run_ensemble(fn, x_all, n_ens, 0, state=state), reps=3) / n_ens
            print(json.dumps(out))
            return 0

        # one windowed-HMC production step (L = 8, persist 0.7)
        tf = {"mu": torch.full((17,), 0.0, device=dev), "chol": torch.eye(17, device=dev),
              "lo": torch.zeros(17, device=dev), "width": torch.ones(17, device=dev)}
        vg = hmc.make_value_and_grad(fn, state, tf, True)
        u = torch.zeros((NWALKERS, 17), device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        lp_u, lp_x, g = vg(u)
        p = torch.randn(u.shape, generator=gen, device=dev)

        def step():
            e = 0.1 * torch.ones((NWALKERS, 1), device=dev)
            xi = torch.randn(u.shape, generator=gen, device=dev)
            s = torch.randint(0, 2, (NWALKERS,), generator=gen, device=dev)
            gu = torch.rand((9, NWALKERS), generator=gen, device=dev).clamp(min=1e-30)
            au = torch.rand((NWALKERS,), generator=gen, device=dev).clamp(min=1e-30)
            return hmc.trajectory_transition(vg, u, p, lp_u, lp_x, g, e, xi, s, gu, au,
                                             n_leapfrog=8, window=2, persist=0.7)

        out["hmc_windowed_step_wall_ms"] = wall_ms(step, reps=5)

        # the Woodbury block's factorization: library (the port) against
        # unrolled per entry, in turns (library, unrolled, unrolled, library)
        from gpbayestools_hic_tpu_torch.samplers import chain as chain_mod

        routes = {"library": chain_mod.spd_qform_logdet, "unrolled": unrolled_qform_logdet}
        ab = {r: {"value_ms": [], "value_and_grad_ms": [], "hmc_step_ms": []} for r in routes}
        for r in ("library", "unrolled", "unrolled", "library"):
            chain_mod.spd_qform_logdet = routes[r]
            ab[r]["value_ms"].append(wall_ms(value))
            ab[r]["value_and_grad_ms"].append(wall_ms(value_and_grad))
            ab[r]["hmc_step_ms"].append(wall_ms(step, reps=5))
        for r in routes:
            chain_mod.spd_qform_logdet = routes[r]
            prof = profile_calls(value_and_grad, n_prof)
            ab[r].update(busy_ms_per_value_and_grad=prof["busy_ms"],
                         kernels_per_value_and_grad=prof["kernels"])
        chain_mod.spd_qform_logdet = routes["library"]
        lp_lib, g_lib = value_and_grad()
        chain_mod.spd_qform_logdet = routes["unrolled"]
        lp_unr, g_unr = value_and_grad()
        chain_mod.spd_qform_logdet = routes["library"]
        ab["max_abs_lp_diff"] = float((lp_lib - lp_unr).abs().max())
        ab["max_abs_grad_diff_rel"] = float((g_lib - g_unr).abs().max() / g_lib.abs().max())
        out["woodbury_factorization"] = ab
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
