"""Emulators: batched GP, the PCA-projected Emulator, joint training and
parameter-space PCA."""

from .emulator import Emulator  # noqa: F401
from .gp import GPConfig, GPState, gp_fit, gp_nll, gp_predict  # noqa: F401
from .joint import train_emulators_jointly  # noqa: F401
