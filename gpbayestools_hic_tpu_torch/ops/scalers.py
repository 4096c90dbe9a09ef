"""Standardization and PCA: host numpy fits, dtype-generic transforms.

The port's own copy of the JAX package's ``ops/scalers.py``.  Fitting is
one-time training prep and runs on the host in float64 LAPACK; the
transforms use only operators that numpy arrays and torch tensors share,
so the same functions serve training prep (numpy) and the predict path
(tensors on the device).

Conventions match sklearn numerically:

- ``StandardScaler``: mean over axis 0, biased std (ddof=0); zero-variance
  columns get scale 1.
- ``PCA``: center, full SVD, ``components_ = Vt``, ``explained_variance_ =
  S^2/(n-1)``; whitened scores are ``X_c @ Vt.T / sqrt(explained_variance)``.
  The largest-|coefficient| entry of each component is made positive.

The state classes keep the JAX package's names and field order: JAX save
files pickle them by class, and :func:`..utils.io.load_pytree` maps those
pickles onto these classes.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np


def _result_dtype(x) -> np.dtype:
    dt = np.dtype(getattr(x, "dtype", np.float64))
    if dt.kind != "f":
        # integer/bool inputs upcast (sklearn semantics)
        return np.dtype(np.float64)
    return dt


class StandardScalerState(NamedTuple):
    mean: Any   # (nfeatures,)
    scale: Any  # (nfeatures,) biased std, zeros mapped to 1
    var: Any    # (nfeatures,) biased variance (sklearn's .var_)


def fit_standard_scaler(x) -> StandardScalerState:
    """Fit mean/std over axis 0 of ``x`` (nsamples, nfeatures); host-side."""
    dt = _result_dtype(x)
    xn = np.asarray(x, dtype=np.float64)
    mean = xn.mean(axis=0)
    var = xn.var(axis=0)
    scale = np.sqrt(var)
    scale = np.where(scale == 0.0, 1.0, scale)
    return StandardScalerState(
        mean=mean.astype(dt), scale=scale.astype(dt), var=var.astype(dt)
    )


def scaler_transform(state: StandardScalerState, x):
    return (x - state.mean) / state.scale


def scaler_inverse_transform(state: StandardScalerState, z):
    return z * state.scale + state.mean


class PCAState(NamedTuple):
    mean: Any                      # (nfeatures,)
    components: Any                # (ncomponents, nfeatures) = rows of Vt
    explained_variance: Any        # (ncomponents,) = S^2/(n-1)
    explained_variance_ratio: Any  # (ncomponents,)
    whiten: bool


def fit_pca(x, whiten: bool = True) -> PCAState:
    """Full-SVD PCA of ``x`` (nsamples, nfeatures); keeps all components."""
    dt = _result_dtype(x)
    xn = np.asarray(x, dtype=np.float64)
    mean = xn.mean(axis=0)
    xc = xn - mean
    n = xn.shape[0]
    _, s, vt = np.linalg.svd(xc, full_matrices=False)
    max_idx = np.argmax(np.abs(vt), axis=1)
    signs = np.sign(vt[np.arange(vt.shape[0]), max_idx])
    signs = np.where(signs == 0.0, 1.0, signs)
    vt = vt * signs[:, None]
    explained_variance = (s**2) / (n - 1)
    ratio = explained_variance / explained_variance.sum()
    return PCAState(
        mean=mean.astype(dt),
        components=vt.astype(dt),
        explained_variance=explained_variance.astype(dt),
        explained_variance_ratio=ratio.astype(dt),
        whiten=whiten,
    )


def pca_transform(state: PCAState, x, npc: int | None = None):
    """Project ``x`` onto the first ``npc`` components (all if None)."""
    comps = state.components if npc is None else state.components[:npc]
    z = (x - state.mean) @ comps.T
    if state.whiten:
        ev = state.explained_variance if npc is None else state.explained_variance[:npc]
        z = z / ev**0.5
    return z


def pca_inverse_transform(state: PCAState, z):
    """Map scores back to feature space (uses first z.shape[-1] components)."""
    npc = z.shape[-1]
    comps = state.components[:npc]
    if state.whiten:
        z = z * state.explained_variance[:npc] ** 0.5
    return z @ comps + state.mean


def n_components_for_variance(state: PCAState, target: float) -> int:
    """Smallest k with cumulative explained-variance ratio > target."""
    csum = np.cumsum(np.asarray(state.explained_variance_ratio))
    k = int(np.searchsorted(csum, target, side="right")) + 1
    return min(k, int(state.components.shape[0]))
