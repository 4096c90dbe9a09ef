"""Where a PCSK configuration's ``hyper_ranges`` come from.

``fit_ranges.py`` for the PCSK heads: draws the configuration's problem
(``benchmark/harness/problem.py::base_problem``, its ``problem_seed``;
the outputs and errors do not depend on the ranges), builds one
``EmulatorBAND(method=<method>, kernel_kind=<kernel>)`` head per block on
the card in float32 with the configuration's ``target_variance``, fits
each head's GPs (``trainEmulatorAutoMask``, ``gp_maxiter=30``: the
per-design noise from the errors in the Gram diagonal) and prints one JSON
line: the PC count of each block, and the 0th, 5th, 25th, 50th, 75th, 95th
and 100th percentiles of each hyperparameter's fitted values over all GPs
(the length scales over all GPs and parameters), with the fit's log
marginal likelihoods and seconds.  The configuration's ``hyper_ranges``
are the 5th to 95th percentiles.  Run from the repository root on a CUDA
machine:

    python3 benchmark/tools/fit_ranges_pcsk.py auau-bes-pcsk
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def fit(cfg: dict, maxiter: int = 30, device: str = "cuda") -> dict:
    import numpy as np
    import torch

    from benchmark.harness.problem import base_problem
    from gpbayestools_hic_tpu_torch.models.emulator_band import EmulatorBAND
    from gpbayestools_hic_tpu_torch.utils.synthetic import (
        write_parameter_file, write_training_pickle,
    )

    problem = base_problem(cfg)
    dev = torch.device(device)
    amp, ls, noise, lml, npcs, secs = [], [], [], [], [], []
    with tempfile.TemporaryDirectory() as tmp:
        parfile = write_parameter_file(os.path.join(tmp, "pars.txt"), int(cfg["ndim"]))
        i0 = 0
        for b, nobs in enumerate(cfg["blocks"]):
            i1 = i0 + int(nobs)
            pkl = write_training_pickle(
                os.path.join(tmp, f"train{b}.pkl"), problem["design"],
                problem["outputs"][:, i0:i1], problem["train_err"][:, i0:i1])
            emu = EmulatorBAND(pkl, parfile, method=cfg["method"], kernel_kind=cfg["kernel"],
                               target_variance=float(cfg["target_variance"]),
                               gp_maxiter=maxiter, device=dev, dtype=torch.float32)
            emu.gp_alpha = float(cfg["gp_alpha"])
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            emu.trainEmulatorAutoMask()
            p = emu.gp_state.params
            amp += p["log_amp"].double().cpu().tolist()
            ls += p["log_ls"].double().cpu().flatten().tolist()
            noise += p["log_noise"].double().cpu().tolist()
            lml += emu.gp_state.lml.double().cpu().tolist()
            secs.append(time.perf_counter() - t0)
            npcs.append(int(emu._npc_used))
            del emu
            i0 = i1
    q = [0, 5, 25, 50, 75, 95, 100]
    return {
        "config": cfg["name"], "npc_blocks": npcs, "gps": len(amp), "fit_s": sum(secs),
        "fit_s_blocks": secs, "percentiles": q,
        "log_amp": np.percentile(amp, q).tolist(), "log_ls": np.percentile(ls, q).tolist(),
        "log_noise": np.percentile(noise, q).tolist(),
        "lml_sum": sum(lml), "lml_range": [min(lml), max(lml)],
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }


def main(names) -> int:
    for name in names:
        cfg = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
        print(json.dumps(fit(cfg)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
