"""Emulators: batched GP and the PCA-projected Emulator."""

from .emulator import Emulator  # noqa: F401
from .gp import GPConfig, GPState, gp_fit, gp_predict  # noqa: F401
