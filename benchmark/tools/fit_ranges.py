"""Where each configuration's ``hyper_ranges`` come from.

Fits the port's synthetic chain (``utils/synthetic.py::build_synthetic_chain``,
seed 0, ``gp_maxiter=30``, float32 on the card) at a configuration's sizes
and prints, as one JSON line per configuration, the 0th, 5th, 25th, 50th,
75th, 95th and 100th percentiles of each GP hyperparameter's fitted values
(log amplitude, log length scale, log white noise) over all GPs (and, for
the length scales, all parameters), with the fit's log marginal
likelihoods.  A configuration's ``hyper_ranges`` are the 5th to 95th
percentiles: the run draws each GP's values uniformly within them, so
that the emulators are about as smooth as fitted ones (the fit's few
extreme length scales, up to e^4.2, drawn for every parameter, make a far
rougher posterior: HMC's step size fell from 0.27 to 0.12).  Run from the repository root on a CUDA machine:

    python3 benchmark/tools/fit_ranges.py auau-bes
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def fit(cfg: dict) -> dict:
    import torch

    from gpbayestools_hic_tpu_torch.utils.synthetic import build_synthetic_chain

    with tempfile.TemporaryDirectory() as tmp:
        stats: dict = {}
        t0 = time.perf_counter()
        chain, fit_s = build_synthetic_chain(
            nev=cfg["n_design"], ndim=cfg["ndim"], nobs_blocks=tuple(cfg["blocks"]),
            npc=cfg["npc"], gp_maxiter=30, seed=0, tmpdir=tmp,
            device=torch.device("cuda", 0), fit_stats=stats,
        )
        total_s = time.perf_counter() - t0
        import numpy as np

        amp, ls, noise, lml = [], [], [], []
        for e in chain.emuList:
            p = e.gp_state.params
            amp += p["log_amp"].double().cpu().tolist()
            ls += p["log_ls"].double().cpu().flatten().tolist()
            noise += p["log_noise"].double().cpu().tolist()
            lml += e.gp_state.lml.double().cpu().tolist()
    q = [0, 5, 25, 50, 75, 95, 100]
    return {
        "config": cfg["name"], "gps": len(amp), "fit_s": fit_s, "total_s": total_s,
        "percentiles": q,
        "log_amp": np.percentile(amp, q).tolist(), "log_ls": np.percentile(ls, q).tolist(),
        "log_noise": np.percentile(noise, q).tolist(),
        "lml_sum": sum(lml), "lml_range": [min(lml), max(lml)],
        "device": torch.cuda.get_device_name(0),
    }


def main(names) -> int:
    for name in names:
        cfg = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
        print(json.dumps(fit(cfg)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
