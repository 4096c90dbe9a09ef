"""The SMC evidence on a Gaussian of known evidence, in either package.

Runs ``run_smc`` of the JAX package (CPU, float64) and/or of the PyTorch
port (``--device cpu`` or ``cuda``, ``--dtype float64`` or ``float32``) on
``utils/synthetic.py::gaussian_evidence_problem`` (a normalized 17-d
correlated Gaussian well inside the unit box, log Z = -1.2e-5) and prints,
per run, the persistent-sampling, importance-sampling and bridge estimates
with their errors, the selected ``logz``, the truth, the iterations and
the MCMC steps.  Both packages share the problem's numbers; their random
streams differ.

    python tools/smc_evidence_gap.py --package both --seeds 0 1 \\
        --knobs 1024 256 512 1024 1024
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _summary(res, truth, seconds, label):
    keys = ("logz", "logz_err", "logz_source", "logz_ps", "logz_err_ps", "logz_is",
            "logz_err_is", "logz_khat", "logz_bridge", "logz_err_bridge")
    out = {"run": label, "truth": truth, "seconds": round(seconds, 2),
           "iterations": res["beta_iterations"], "mcmc_steps": res["total_mcmc_steps"]}
    out.update({k: res[k] for k in keys})
    return out


def run_jax(prob, knobs, seed):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from gpbayestools_hic_tpu.samplers.smc import run_smc

    prec, mu = jnp.asarray(prob["prec"]), jnp.asarray(prob["mu"])
    const = prob["const"]

    def logl(state, x, finite):
        r = x - mu
        return -0.5 * jnp.sum((r @ prec) * r, axis=1) + const

    d = mu.shape[0]
    return run_smc(logl, jnp.zeros(d), jnp.ones(d), seed=seed, **knobs)


def run_port(prob, knobs, seed, device, dtype):
    import torch

    from gpbayestools_hic_tpu_torch.samplers.smc import run_smc

    dt = getattr(torch, dtype)
    prec = torch.tensor(prob["prec"], dtype=dt, device=device)
    mu = torch.tensor(prob["mu"], dtype=dt, device=device)
    const = prob["const"]

    def logl(state, x, finite):
        r = x - mu
        return -0.5 * ((r @ prec) * r).sum(1) + const

    d = mu.shape[0]
    return run_smc(logl, np.zeros(d), np.ones(d), seed=seed, device=device, dtype=dt, **knobs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("jax", "port", "both"), default="both")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--dtype", default="float64")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--knobs", type=int, nargs=5, default=[1024, 256, 512, 1024, 1024],
                    metavar=("N_PRIOR", "N_ACTIVE", "N_EFFECTIVE", "N_TOTAL", "N_EVIDENCE"))
    ap.add_argument("--ndim", type=int, default=17)
    ap.add_argument("--sample", default="tpcn", choices=("tpcn", "pcn", "rwm"))
    ap.add_argument("--sd", type=float, nargs=2, default=[0.05, 0.1],
                    help="range of the Gaussian's standard deviations")
    args = ap.parse_args()
    from gpbayestools_hic_tpu_torch.utils.synthetic import gaussian_evidence_problem

    prob = gaussian_evidence_problem(args.ndim, seed=0, sd_range=tuple(args.sd))
    knobs = dict(zip(("n_prior", "n_active", "n_effective", "n_total", "n_evidence"), args.knobs))
    knobs["sample"] = args.sample
    for seed in args.seeds:
        for pkg in (("jax", "port") if args.package == "both" else (args.package,)):
            t0 = time.perf_counter()
            if pkg == "jax":
                res, label = run_jax(prob, knobs, seed), "jax cpu float64"
            else:
                res = run_port(prob, knobs, seed, args.device, args.dtype)
                label = f"port {args.device} {args.dtype}"
            print(json.dumps(_summary(res, prob["truth"], time.perf_counter() - t0,
                                      f"{label} seed {seed} {knobs}")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
