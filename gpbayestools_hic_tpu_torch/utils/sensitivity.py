"""Sensitivity of emulated observables to the model parameters (PyTorch
port of the JAX package's ``utils/sensitivity.py``).

The normalized response matrix ``S[j, d] = d ln Y_j / d ln theta_d``:

- :func:`sensitivity_matrix` -- exact, forward-mode autodiff
  (``torch.func.jacfwd``) through the emulator's plain GP predict and its
  PC-to-observable mean map on its device.  The plain predict, not the
  fused one: the fused predict is an ``autograd.Function`` with a
  reverse-mode rule only;
- :func:`sensitivity_matrix_fd` -- central differences with ``h =
  rel_step * theta``, for cross-checking.
"""

from __future__ import annotations

import numpy as np
import torch


def sensitivity_matrix(emulator, theta: np.ndarray) -> np.ndarray:
    """Exact normalized sensitivities at the single point ``theta``
    (ndim,); returns (nobs, ndim) float64 numpy."""
    theta_t = torch.as_tensor(np.asarray(theta, dtype=np.float64),
                              dtype=emulator._dtype, device=emulator.device)

    def mean_fn(t):
        gp_mean, _ = emulator.predict_pc_raw(t[None, :])
        return emulator.pc_to_obs_mean(gp_mean)[0]

    jac = torch.func.jacfwd(mean_fn)(theta_t)          # (nobs, ndim)
    if getattr(emulator, "logTrafo_", False):
        # the emulator predicts ln Y already: d lnY / d ln theta is the
        # Jacobian times theta (dividing by the log-space mean would give
        # d ln(lnY), which blows up near Y = 1)
        out = jac * theta_t[None, :]
    else:
        with torch.no_grad():
            mean = mean_fn(theta_t)
        out = jac * theta_t[None, :] / mean[:, None]
    return out.detach().cpu().numpy().astype(np.float64)


def sensitivity_matrix_fd(emulator, theta: np.ndarray, rel_step: float = 0.1) -> np.ndarray:
    """Central differences with h = rel_step * |theta_d| (an absolute floor
    gives a zero parameter a step).  Returns (nobs, ndim).

    The estimator ``(Y1 - Y2) / (2h) * theta_d / mean(Y1, Y2)``; for a
    ``logTrafo`` emulator ``predict`` returns ln Y, so the difference
    quotient times theta is already ``d lnY / d ln theta``."""
    theta = np.asarray(theta, dtype=float)
    ndim = theta.shape[0]
    log_trafo = bool(getattr(emulator, "logTrafo_", False)) and not bool(
        getattr(emulator, "exp_and_cov_diagonal_", False)
    )
    base = emulator.predict(theta[None, :], return_cov=False)[0]
    out = np.empty((base.shape[0], ndim))
    for d in range(ndim):
        h = rel_step * max(abs(theta[d]), 1e-8)
        up = theta.copy()
        dn = theta.copy()
        up[d] += h
        dn[d] -= h
        y_up = emulator.predict(up[None, :], return_cov=False)[0]
        y_dn = emulator.predict(dn[None, :], return_cov=False)[0]
        slope = (y_up - y_dn) / (2.0 * h)
        if log_trafo:
            out[:, d] = slope * theta[d]
        else:
            out[:, d] = slope * theta[d] / (0.5 * (y_up + y_dn))
    return out
