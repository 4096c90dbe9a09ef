"""Where the time goes in the PyTorch port's flagship posterior (one GPU).

Run from the repository root on a CUDA machine:

    python3 tools/torch_profile_posterior.py

Builds the flagship chain with the port (17 parameters, 9 emulators x 4
PCs on 1000 design points, 544 observables, ``gp_maxiter=0``), then at
1024 walkers measures

- kernel launches per posterior value and per posterior gradient;
- wall time per value and per value-and-gradient (host clock around
  synchronized calls, median of repeats);
- a ``torch.profiler`` trace of a few value-and-gradient calls: device
  busy time per call, the device's idle share of the wall time, the number
  of device kernels per call and the top kernels by device time;
- wall time of one windowed-HMC production step (L = 8).

Prints one JSON object as its last line (with the card's name and power
limit).  Imports nothing of JAX.
"""

from __future__ import annotations

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_profile_posterior: no CUDA device", file=sys.stderr)
        return 2
    from gpbayestools_hic_tpu_torch.ops import fused_predict as fp
    from gpbayestools_hic_tpu_torch.samplers import hmc
    from gpbayestools_hic_tpu_torch.utils.synthetic import build_synthetic_chain

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "nwalkers": NWALKERS}
    with tempfile.TemporaryDirectory() as tmp:
        chain, _ = build_synthetic_chain(
            nev=1000, ndim=17, nobs_blocks=BLOCKS, npc=4, gp_maxiter=0,
            seed=0, tmpdir=tmp, device=dev,
        )
        fn, state = chain.posterior_with_state()
        x = torch.tensor(chain.random_pos(NWALKERS, seed=1), dtype=torch.float32, device=dev)

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

        fp.reset_launch_counts()
        value()
        out["launches_per_value"] = dict(fp.LAUNCH_COUNTS)
        fp.reset_launch_counts()
        value_and_grad()
        out["launches_per_value_and_grad"] = dict(fp.LAUNCH_COUNTS)
        out["value_wall_ms"] = wall_ms(value)
        out["value_and_grad_wall_ms"] = wall_ms(value_and_grad)

        from torch.profiler import ProfilerActivity, profile

        n_prof = 5
        value_and_grad()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_prof):
                value_and_grad()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dev_us = {}
        n_kernels = 0
        for e in prof.events():
            if str(getattr(e, "device_type", "")).endswith("CUDA"):
                dev_us[e.name] = dev_us.get(e.name, 0.0) + e.time_range.elapsed_us()
                n_kernels += 1
        busy_ms = sum(dev_us.values()) / 1e3 / n_prof
        out["profile_calls"] = n_prof
        out["profile_wall_ms_per_call"] = 1e3 * wall / n_prof
        out["device_busy_ms_per_call"] = busy_ms
        out["device_idle_share"] = 1.0 - busy_ms / (1e3 * wall / n_prof)
        out["device_kernels_per_call"] = n_kernels / n_prof
        top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
        out["top_device_ms_per_call"] = {k[:80]: v / 1e3 / n_prof for k, v in top}

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
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
