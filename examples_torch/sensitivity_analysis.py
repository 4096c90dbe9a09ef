"""Sensitivity analysis: the normalized response matrix d lnY / d ln theta.

Forward-mode autodiff through the emulator's plain predict on ``device``
(default CUDA), beside the central-difference estimate.  Run
``make_synthetic_dataset.py`` and ``emulator_training.py`` first.

    python sensitivity_analysis.py [device]
"""

import sys
from pathlib import Path

import numpy as np

from gpbayestools_hic_tpu_torch.models import Emulator
from gpbayestools_hic_tpu_torch.utils import sensitivity_matrix, sensitivity_matrix_fd

DATA = Path("synthetic_data")


def main(group: str = "dNdy", device=None):
    emu = Emulator.load(DATA / f"emulator_sklearn_{group}.sav", device=device)
    theta = np.full(len(emu.pardict), 0.5)
    s_ad = sensitivity_matrix(emu, theta)
    s_fd = sensitivity_matrix_fd(emu, theta)
    print("autodiff response matrix (nobs x ndim):\n", np.round(s_ad, 3))
    print("max |AD - FD(h=0.1)| =", np.abs(s_ad - s_fd).max().round(4))
    return s_ad, s_fd


if __name__ == "__main__":
    main(device=sys.argv[1] if len(sys.argv) > 1 else None)
