"""Calibration: the Chain posterior, the ensemble sampler and HMC."""

from .chain import Chain  # noqa: F401
from .ensemble import EnsembleResult, run_ensemble  # noqa: F401
from .hmc import HMCResult, run_hmc  # noqa: F401
