"""GP covariance kernels over a log-space hyperparameter dict.

Port of the JAX package's ``ops/kernels.py`` for the two families the
sklearn head uses: ``1.0 * RBF(ls) + WhiteKernel`` and ``1.0 * Matern(nu=1.5)
+ WhiteKernel``.  Hyperparameters are ``{"log_amp", "log_ls", "log_noise"}``.

- RBF:        k = amp * exp(-0.5 * sum((x-y)^2 / l^2))
- Matern 1.5: k = amp * (1 + sqrt(3) d) exp(-sqrt(3) d),  d = sqrt(sum((x-y)^2/l^2))
- white noise adds to the *self* Gram diagonal only.

Squared distances come from direct differences, one input dimension at a
time (O(n m) working memory), not from ``|u|^2 + |v|^2 - 2 u.v``: the
expanded form cancels catastrophically in float32 wherever the distance is
small against the norms.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class KernelConfig(NamedTuple):
    """Static kernel configuration."""

    kind: str = "RBF"  # "RBF" | "Matern" (nu = 1.5)


def scaled_sqdist(xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distance of pre-scaled inputs, (..., n, d) x (..., m, d)."""
    d2 = None
    for j in range(xs.shape[-1]):
        diff = xs[..., :, j, None] - ys[..., None, :, j]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    return d2


def kernel_fn(
    params: dict,
    x: torch.Tensor,
    y: torch.Tensor | None = None,
    *,
    config: KernelConfig = KernelConfig(),
    include_noise: bool = True,
) -> torch.Tensor:
    """Gram matrix k(x, y) with hyperparameters ``params`` of ONE GP.

    ``x`` (n, d), ``y`` (m, d) or None for the symmetric self-Gram.  White
    noise is added only on the self-Gram diagonal and only when
    ``include_noise`` is True.
    """
    amp = torch.exp(params["log_amp"])
    ls = torch.exp(params["log_ls"])
    xs = x / ls
    symmetric = y is None
    ys = xs if symmetric else y / ls
    d2 = scaled_sqdist(xs, ys)
    if config.kind == "RBF":
        k = amp * torch.exp(-0.5 * d2)
    elif config.kind == "Matern":
        d = torch.sqrt(d2 + 1e-32)
        sq3d = math.sqrt(3.0) * d
        k = amp * (1.0 + sq3d) * torch.exp(-sq3d)
    else:
        raise ValueError(f"Unknown kernel kind: {config.kind}")
    if symmetric and include_noise:
        noise = torch.exp(params["log_noise"])
        k = k + noise * torch.eye(x.shape[0], dtype=k.dtype, device=k.device)
    return k


def kernel_diag(
    params: dict,
    x: torch.Tensor,
    *,
    config: KernelConfig = KernelConfig(),
    include_noise: bool = True,
) -> torch.Tensor:
    """Diagonal of the self-Gram k(x, x) without forming the matrix."""
    amp = torch.exp(params["log_amp"])
    diag = amp.expand(x.shape[0]).clone()
    if include_noise:
        diag = diag + torch.exp(params["log_noise"])
    return diag


def init_kernel_params(
    ptp,
    *,
    amp: float = 1.0,
    noise: float = 0.05,
    dtype=torch.float64,
    device=None,
) -> dict:
    """Reference-default initialization: length scales = parameter ranges,
    amplitude 1, white-noise level 0.05."""
    ptp = torch.as_tensor(np.asarray(ptp), dtype=dtype, device=device)
    return {
        "log_amp": torch.log(torch.tensor(amp, dtype=dtype, device=device)),
        "log_ls": torch.log(ptp),
        "log_noise": torch.log(torch.tensor(noise, dtype=dtype, device=device)),
    }


def default_bounds(ptp, *, kind: str = "RBF", dtype=torch.float64, device=None):
    """Log-space hyperparameter bounds matching the reference kernels:
    length scales ``ptp * (1e-1, 1e2)`` (RBF) or ``ptp * (1e-3, 1e5)``
    (Matern), amplitude (1e-5, 1e5), white noise (1e-2, 1e2)."""
    ptp = torch.as_tensor(np.asarray(ptp), dtype=dtype, device=device)
    ls_lo, ls_hi = (1e-1, 1e2) if kind == "RBF" else (1e-3, 1e5)

    def t(v):
        return torch.tensor(math.log(v), dtype=dtype, device=device)

    lower = {"log_amp": t(1e-5), "log_ls": torch.log(ptp * ls_lo),
             "log_noise": t(1e-2)}
    upper = {"log_amp": t(1e5), "log_ls": torch.log(ptp * ls_hi),
             "log_noise": t(1e2)}
    return lower, upper
