"""Integrated autocorrelation time, for ``hmc_ess_per_s``.

A copy of the port's ``utils/metrics.py::integrated_autocorr_time`` (the
emcee estimator: FFT autocorrelation averaged over walkers, Sokal's
adaptive window with c = 5, fully stuck walkers left out), kept here so
that a change to the program cannot move the yardstick.
"""

from __future__ import annotations

import numpy as np


def integrated_autocorr_time(chain_1d_batch: np.ndarray) -> float:
    """tau >= 1 of one parameter's (nwalkers, nsteps) chain; inf when every
    walker is stuck."""
    x = np.asarray(chain_1d_batch, dtype=np.float64)
    x = x - x.mean(axis=1, keepdims=True)
    alive = x.var(axis=1) > 0
    if not alive.any():
        return float("inf")
    x = x[alive]
    n = x.shape[1]
    nfft = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(x, n=nfft, axis=1)
    acf = np.fft.irfft(f * np.conj(f), n=nfft, axis=1)[:, :n].real
    acf /= np.maximum(acf[:, :1], 1e-30)
    rho = acf.mean(axis=0)
    taus = 2.0 * np.cumsum(rho) - 1.0
    window = np.arange(len(taus)) < 5.0 * taus
    idx = np.argmin(window) if not window.all() else len(taus) - 1
    return float(max(taus[min(idx, len(taus) - 1)], 1.0))


def max_tau(chain: np.ndarray) -> float:
    """The largest tau over the parameters of a (nwalkers, nsteps, ndim)
    chain."""
    return max(integrated_autocorr_time(chain[:, :, j]) for j in range(chain.shape[2]))
