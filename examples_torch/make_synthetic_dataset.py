"""Build a synthetic heavy-ion-like calibration dataset.

Writes the training and experimental-data pickles every other example
reads, so nothing needs the external physics simulator:

- ``training_data_<group>.pkl``: {event_id: {"parameter", "obs" (2, nobs)}}
- ``exp_data.pkl``: one pseudo-experiment from a held-out truth point
- ``model_params.txt``: the parameter space; ``truth_parameters.txt``

The observable groups mimic the flagship's block structure.  Host numpy
only (no device).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from gpbayestools_hic_tpu_torch.utils.synthetic import (
    write_exp_pickle,
    write_parameter_file,
    write_training_pickle,
)

GROUPS = {"dNdy": 10, "meanpT": 8, "vn": 6}
NDIM = 6
NPOINTS = 120


def smooth_model(design, freqs, amps):
    return 2.0 + amps * np.sin(design @ freqs) + 0.2 * (design**2) @ freqs


def main(outdir="synthetic_data", seed=1, npoints: int = NPOINTS):
    out = Path(outdir)
    out.mkdir(exist_ok=True)
    rng = np.random.default_rng(seed)
    write_parameter_file(out / "model_params.txt", NDIM)

    design = rng.uniform(0, 1, size=(npoints, NDIM))
    truth = rng.uniform(0.35, 0.65, size=NDIM)
    np.savetxt(out / "truth_parameters.txt", truth)

    exp_blocks = []
    for group, nobs in GROUPS.items():
        freqs = rng.uniform(0.5, 2.0, size=(NDIM, nobs))
        amps = rng.uniform(0.5, 1.5)
        base = smooth_model(design, freqs, amps)
        err = 0.02 * np.abs(base) * rng.uniform(0.5, 1.0, size=base.shape)
        noisy = base + err * rng.normal(size=base.shape)
        write_training_pickle(out / f"training_data_{group}.pkl", design, noisy, err)
        exp_blocks.append(smooth_model(truth[None], freqs, amps)[0])

    exp_mean = np.concatenate(exp_blocks)
    write_exp_pickle(out / "exp_data.pkl", exp_mean, 0.03 * np.abs(exp_mean))
    print(f"synthetic dataset written to {out}/ "
          f"({len(GROUPS)} groups, truth at {np.round(truth, 3)})")


if __name__ == "__main__":
    main()
