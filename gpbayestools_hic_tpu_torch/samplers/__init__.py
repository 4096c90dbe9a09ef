"""Calibration: the Chain posterior and the HMC sampler."""

from .chain import Chain  # noqa: F401
from .hmc import HMCResult, run_hmc  # noqa: F401
