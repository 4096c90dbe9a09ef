"""Emulators: batched GP, the PCA-projected Emulator, the BAND heads
(PCGP / PCSK / PCGPwImpute / PCGPwM), joint training, parameter-space PCA,
the validation harness and the import of reference emulators."""

from .emulator import Emulator  # noqa: F401
from .emulator_band import EmulatorBAND  # noqa: F401
from .gp import GPConfig, GPState, gp_fit, gp_nll, gp_predict  # noqa: F401
from .joint import train_emulators_jointly  # noqa: F401
from .migrate import from_reference  # noqa: F401
