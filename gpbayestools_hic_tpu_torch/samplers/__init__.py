"""Calibration: the Chain posterior and its samplers.

- :mod:`.chain` -- :class:`Chain`, the calibration posterior and the
  sampler front ends;
- :mod:`.ensemble` -- the affine-invariant ensemble sampler;
- :mod:`.hmc` -- preconditioned Hamiltonian MC;
- :mod:`.ptlmc` -- parallel-tempered Langevin MC;
- :mod:`.smc` -- flow-preconditioned sequential Monte Carlo, with
  :mod:`.flows`, its normalizing flows.
"""

from .chain import Chain  # noqa: F401
from .ensemble import EnsembleResult, run_ensemble  # noqa: F401
from .hmc import HMCResult, run_hmc  # noqa: F401
