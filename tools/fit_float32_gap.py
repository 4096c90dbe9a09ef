"""How far the float32 GP fit stops from the float64 optimum, in both packages.

For GP 0 of emulators 0, 3 and 8 of the flagship chain (17 parameters,
1000 design points, seed 0: the float32 targets of the port's
``build_synthetic_chain``), fit each GP on the CPU with

- the JAX package's ``gp_fit`` in float32 (x64 off), maxiter 200;
- the port's ``gp_fit`` in float32 and in float64, maxiter 200;
- scipy's L-BFGS-B in float64 numpy from the same start and bounds, to its
  own convergence (``chip_smoke._scipy_fit``),

and print one JSON line with each LML (the float32 fits' also evaluated
in float64 at their hyperparameters).  ``chip_smoke.py`` holds the port's
float32 fit on the card to the JAX float32 LMLs this prints.

    python tools/fit_float32_gap.py      # about a minute on 8 CPU cores
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    import chip_smoke as cs
    from gpbayestools_hic_tpu.models import gp as jgp
    from gpbayestools_hic_tpu_torch.models import gp as gpm
    from gpbayestools_hic_tpu_torch.utils.synthetic import build_synthetic_chain

    with tempfile.TemporaryDirectory() as tmp:
        chain, _ = build_synthetic_chain(nev=cs.NEV, ndim=cs.NDIM, nobs_blocks=cs.BLOCKS,
                                         npc=cs.NPC, gp_maxiter=0, seed=0, tmpdir=tmp,
                                         device="cpu")
    x = chain.emuList[0].gp_state.x
    ys = torch.stack([chain.emuList[i].gp_state.y[0] for i in cs.SCIPY_EMULATORS])
    ptp = np.ones(cs.NDIM)
    cfg = gpm.GPConfig()
    port32 = gpm.gp_fit(x, ys, ptp, config=cfg, maxiter=200)
    port64 = gpm.gp_fit(x.double(), ys.double(), ptp, config=cfg, maxiter=200)
    jax32 = jgp.gp_fit(jnp.asarray(x.numpy()), jnp.asarray(ys.numpy()),
                       jnp.ones(cs.NDIM, jnp.float32), config=jgp.GPConfig(), maxiter=200)
    j_theta = gpm._pack({k: torch.tensor(np.asarray(v)) for k, v in jax32.params.items()})
    p_theta = gpm._pack(port32.params)
    theta0, lower, upper = gpm._start_and_bounds(ptp, cfg, torch.float64, "cpu")
    rows = []
    for k, emu in enumerate(cs.SCIPY_EMULATORS):
        yk = ys[k].double().numpy()
        _, nll, res, f = cs._scipy_fit(x.double().numpy(), yk, theta0.numpy(),
                                       lower.numpy(), upper.numpy(), cs.NDIM)
        rows.append({
            "emulator": emu, "gp": 0,
            "scipy_f64": -nll, "scipy_iterations": int(res.nit),
            "jax_f32": float(jax32.lml[k]),
            "jax_f32_at_f64": -f(j_theta[k].double().numpy())[0],
            "port_f32": float(port32.lml[k]),
            "port_f32_at_f64": -f(p_theta[k].double().numpy())[0],
            "port_f64": float(port64.lml[k]),
        })
    print(json.dumps({"flagship_gp_fit_lml": rows}))


if __name__ == "__main__":
    main()
