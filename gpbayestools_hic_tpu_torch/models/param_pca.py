"""Viscosity-curve parametrizations and parameter-space PCA ("parameterTrafoPCA").

Port of the JAX package's ``models/param_pca.py``.  Subsets of the physics
parameters are replaced by the principal components of the *function
curves* they induce on fixed grids.  The fit runs once on the host in
numpy (float64); the transform (curve evaluation -> standardize -> project
-> splice) runs on tensors wherever the query points live, so the same
functions serve training prep and every predict entry.

Reference quirks kept (they change curve values on the grids):

- eta/s(mu_B): the ``0 < mu_B`` strict inequality sends the mu_B = 0 grid
  point to the ``eta_4`` branch.
- y_loss(y_init): y_init = 0 falls through to the third branch, giving
  ``yloss_4 - 2 (yloss_6 - yloss_4)``.
- zeta/s(T): the branch condition is ``T < T_zeta0`` (the mu_B = 0 peak), not
  the shifted peak.

Each group deletes its column indices from the *current* design matrix and
appends its PCs at the end, which is index-consistent only when groups are
processed in descending index order; :func:`fit_param_pca` checks that.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..ops.scalers import (
    fit_pca,
    fit_standard_scaler,
    n_components_for_variance,
    pca_transform,
    scaler_transform,
)

logger = logging.getLogger(__name__)


def zeta_over_s_vs_T(params: torch.Tensor, T: torch.Tensor, mu_B: float = 0.0) -> torch.Tensor:
    """Asymmetric-Gaussian bulk viscosity zeta/s(T).

    ``params`` (..., 4) = (zeta_max, T_zeta0, sigma_plus, sigma_minus);
    broadcasts against grid ``T`` (g,).
    """
    zeta_max = params[..., 0:1]
    T_zeta0 = params[..., 1:2]
    sigma_plus = params[..., 2:3]
    sigma_minus = params[..., 3:4]
    T_peak = T_zeta0 - 0.15 * mu_B**2
    d2 = (T - T_peak) ** 2
    left = torch.exp(-d2 / (2.0 * sigma_minus**2))
    right = torch.exp(-d2 / (2.0 * sigma_plus**2))
    return zeta_max * torch.where(T < T_zeta0, left, right)


def eta_over_s_vs_mu_B(params: torch.Tensor, mu_B: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear shear viscosity eta/s(mu_B).

    ``params`` (..., 3) = (eta_0, eta_2, eta_4).  Strict ``0 < mu_B``
    bound kept: mu_B = 0 -> eta_4.
    """
    eta_0 = params[..., 0:1]
    eta_2 = params[..., 1:2]
    eta_4 = params[..., 2:3]
    seg1 = eta_0 + (eta_2 - eta_0) * (mu_B / 0.2)
    seg2 = eta_2 + (eta_4 - eta_2) * ((mu_B - 0.2) / 0.2)
    return torch.where(
        (0.0 < mu_B) & (mu_B <= 0.2),
        seg1,
        torch.where((0.2 < mu_B) & (mu_B < 0.4), seg2, eta_4),
    )


def y_loss_vs_y_init(params: torch.Tensor, y_init: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear rapidity loss <y_loss>(y_init).

    ``params`` (..., 3) = (yloss_2, yloss_4, yloss_6).  Strict bounds kept:
    y_init = 0 falls through to the third branch.
    """
    y2 = params[..., 0:1]
    y4 = params[..., 1:2]
    y6 = params[..., 2:3]
    seg1 = y2 * (y_init / 2.0)
    seg2 = y2 + (y4 - y2) * ((y_init - 2.0) / 2.0)
    seg3 = y4 + (y6 - y4) * ((y_init - 4.0) / 2.0)
    return torch.where(
        (0.0 < y_init) & (y_init <= 2.0),
        seg1,
        torch.where((2.0 < y_init) & (y_init < 4.0), seg2, seg3),
    )


_CURVES: dict[str, Callable] = {
    "zeta": zeta_over_s_vs_T,
    "eta": eta_over_s_vs_mu_B,
    "yloss": y_loss_vs_y_init,
}


class ParamPCAGroup(NamedTuple):
    """Declarative config for one parameter-PCA group."""

    name: str
    indices: tuple          # ORIGINAL design-column indices to replace
    grid: tuple             # curve evaluation grid
    curve: str              # key into _CURVES


def default_groups() -> list[ParamPCAGroup]:
    """The reference's flagship 20-parameter configuration."""
    return [
        ParamPCAGroup(
            name="bulk",
            indices=(15, 16, 17, 18),
            grid=tuple(np.linspace(0.0, 0.5, 100)),
            curve="zeta",
        ),
        ParamPCAGroup(
            name="shear",
            indices=(12, 13, 14),
            grid=tuple(np.linspace(0.0, 0.6, 100)),
            curve="eta",
        ),
        ParamPCAGroup(
            name="yloss",
            indices=(2, 3, 4),
            grid=tuple(np.linspace(0.0, 6.2, 100)),
            curve="yloss",
        ),
    ]


class ParamPCAState(NamedTuple):
    """Fitted parameter-PCA transform (host numpy arrays).

    Field names and order are the JAX package's: its save files pickle the
    class, and :func:`..utils.io.load_pytree` maps it onto this one.
    """

    scalers: tuple          # one StandardScalerState per group
    pcas: tuple             # one PCAState per group
    npcs: tuple             # ints: PCs kept per group (target variance)


def _eval_group_curves(group: ParamPCAGroup, x: torch.Tensor) -> torch.Tensor:
    grid = torch.as_tensor(np.asarray(group.grid, dtype=np.float64), dtype=x.dtype,
                           device=x.device)
    params = x[:, list(group.indices)]
    return _CURVES[group.curve](params, grid)


def _validate_group_order(groups: Sequence[ParamPCAGroup]) -> None:
    seen_min = np.inf
    for g in groups:
        if max(g.indices) >= seen_min:
            raise ValueError(
                "parameter-PCA groups must be ordered by descending column "
                f"index (group '{g.name}' indices {g.indices} overlap or sit "
                "above an earlier group's); the sequential delete-and-append "
                "splice is only index-consistent in that order"
            )
        seen_min = min(g.indices)


def _splice(current, group: ParamPCAGroup, z):
    kept = np.delete(np.arange(current.shape[1]), list(group.indices))
    return torch.cat([current[:, kept], z], dim=1)


def fit_param_pca(
    design_points: np.ndarray,
    design_min: np.ndarray,
    design_max: np.ndarray,
    groups: Sequence[ParamPCAGroup] | None = None,
    *,
    target_variance: float = 0.99,
):
    """Fit the sequential group PCAs on the training design, on the host.

    Returns ``(state, new_design, new_min, new_max)`` where ``new_design``
    has each group's columns replaced by its principal components (appended
    at the end) and min/max updated to the PC ranges.
    """
    if groups is None:
        groups = default_groups()
    _validate_group_order(groups)
    x = torch.as_tensor(np.asarray(design_points, dtype=np.float64))
    scalers, pcas, npcs = [], [], []
    current = x
    new_min = np.asarray(design_min, dtype=float)
    new_max = np.asarray(design_max, dtype=float)
    for group in groups:
        curves = _eval_group_curves(group, x).numpy()
        scaler = fit_standard_scaler(curves)
        scaled = scaler_transform(scaler, curves)
        pca = fit_pca(scaled, whiten=False)
        npc = n_components_for_variance(pca, target_variance)
        logger.info(
            "%s parameter PCA uses %d PCs to explain %.0f%% of the variance",
            group.name, npc, target_variance * 100,
        )
        z = pca_transform(pca, scaled, npc=npc)
        current = _splice(current, group, torch.as_tensor(z))
        new_min = np.concatenate([np.delete(new_min, list(group.indices)), z.min(axis=0)])
        new_max = np.concatenate([np.delete(new_max, list(group.indices)), z.max(axis=0)])
        scalers.append(scaler)
        pcas.append(pca)
        npcs.append(npc)
    state = ParamPCAState(scalers=tuple(scalers), pcas=tuple(pcas), npcs=tuple(npcs))
    return state, current.numpy(), new_min, new_max


def pack_param_pca(state: ParamPCAState, *, dtype=torch.float64, device=None) -> tuple:
    """The fitted transform as tensors on ``device``: one dict per group.

    PC counts are baked in by pre-slicing the component matrices.  Param
    PCA is fit with ``whiten=False``, so the projection is just ``(scaled -
    pca_mean) @ comps^T``.
    """
    def t(a: Any) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return tuple(
        {"sc_mean": t(scaler.mean), "sc_scale": t(scaler.scale),
         "pca_mean": t(pca.mean), "comps": t(np.asarray(pca.components)[:npc])}
        for scaler, pca, npc in zip(state.scalers, state.pcas, state.npcs)
    )


def apply_param_pca_packed(packed: tuple, groups: Sequence[ParamPCAGroup],
                           x: torch.Tensor) -> torch.Tensor:
    """Apply the packed transform to query parameters ``x`` (m, ndim_org);
    differentiable in ``x``."""
    current = x
    for group, g in zip(groups, packed):
        curves = _eval_group_curves(group, x)
        scaled = (curves - g["sc_mean"]) / g["sc_scale"]
        z = (scaled - g["pca_mean"]) @ g["comps"].T
        current = _splice(current, group, z)
    return current


def apply_param_pca(state: ParamPCAState, groups: Sequence[ParamPCAGroup], x):
    """Apply the fitted transform to ``x`` (m, ndim_org): a tensor keeps its
    device and dtype, a numpy array comes back as a float64 numpy array."""
    as_numpy = not isinstance(x, torch.Tensor)
    xt = torch.as_tensor(np.asarray(x, dtype=np.float64)) if as_numpy else x
    if xt.dim() != 2:
        raise ValueError("apply_param_pca requires 2-D input (m, ndim)")
    out = apply_param_pca_packed(
        pack_param_pca(state, dtype=xt.dtype, device=xt.device), groups, xt)
    return out.numpy() if as_numpy else out
