"""Batched exact Gaussian-process regression (PyTorch port of ``models/gp.py``).

Numerics match sklearn GPR with ``kernel = C * (RBF|Matern1.5) + White``,
``alpha = 0.1``:

- log marginal likelihood ``-1/2 y^T K^-1 y - sum log L_ii - n/2 log 2pi``
  with ``K = kernel(X) + alpha I``;
- predictive mean ``k_*^T K^-1 y``; predictive variance ``k(x, x) - |G
  k_*|^2`` with ``G = L^-1`` -- includes the white-noise level but not
  alpha (sklearn convention), clipped at zero.

Hyperparameter optimization (batched, bounded L-BFGS-B) is not ported yet:
:func:`gp_fit` accepts ``maxiter=0`` only, which returns the reference
initialization exactly as the JAX optimizer does with a zero iteration
budget.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.kernels import (
    KernelConfig, default_bounds, init_kernel_params, kernel_diag, kernel_fn,
)
from ..ops.linalg import cholesky_jittered, solve_lower_triangular


class GPConfig(NamedTuple):
    """Static GP configuration.

    ``grad_precision`` chooses the backward kernel of the fused predict
    (:mod:`..ops.fused_predict`): ``"default"`` the fast backward, whose
    cotangent products may drop below FP32, ``"high"`` / ``"highest"`` the
    backward that keeps them FP32-class (3xTF32 with FP32 promotion on the
    card).  It never touches posterior
    values, only the gradient that shapes HMC proposals.  The plain
    (non-fused) paths are full precision whatever it says.  The JAX
    package's ``var_precision`` chooses between bf16 pass counts on the
    TPU; the port computes value products in full float32 or float64 and
    has no such knob.
    """

    kernel: KernelConfig = KernelConfig("RBF")
    alpha: float = 0.1
    grad_precision: str = "default"


class GPState(NamedTuple):
    """Trained state for a batch of GPs sharing the same inputs.

    Leading axis of every field but ``x`` is the GP/batch axis.  ``linv``
    is the explicit inverse Cholesky factor G = L^-1 (K^-1 = G^T G).
    """

    params: dict          # {"log_amp": (b,), "log_ls": (b, d), "log_noise": (b,)}
    x: torch.Tensor       # (n, d) shared training inputs
    y: torch.Tensor       # (b, n) training targets
    chol: torch.Tensor    # (b, n, n) Cholesky of K
    alpha_vec: torch.Tensor  # (b, n) K^-1 y
    linv: torch.Tensor    # (b, n, n) explicit L^-1
    lml: torch.Tensor     # (b,) log marginal likelihood


def _param_slice(params: dict, k: int) -> dict:
    return {name: v[k] for name, v in params.items()}


def _build_k(params, x, config: GPConfig, noise_diag=None):
    k = kernel_fn(params, x, config=config.kernel, include_noise=True)
    k = k + config.alpha * torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
    if noise_diag is not None:
        k = k + torch.diag(noise_diag)
    return k


def gp_fit(
    x: torch.Tensor,
    y_batch: torch.Tensor,
    ptp,
    *,
    config: GPConfig = GPConfig(),
    nrestarts: int = 0,
    maxiter: int = 200,
    noise_diag: torch.Tensor | None = None,
) -> GPState:
    """Fit ``npc`` GPs on shared inputs ``x`` (n, d), targets (npc, n).

    Only ``maxiter=0`` without restarts is supported so far: the state is
    built at the reference initialization (amp 1, length scales = ``ptp``,
    noise 0.05), clipped into the default bounds as the JAX optimizer
    clips its start point.
    """
    if maxiter != 0 or nrestarts != 0:
        raise NotImplementedError(
            "gp_fit with maxiter > 0 or restarts needs the batched L-BFGS-B "
            "optimizer, which is not ported yet (ROADMAP.md, item 6 "
            "'Training'); use gp_maxiter=0 or load a JAX-trained save file"
        )
    dtype, device = x.dtype, x.device
    npc = y_batch.shape[0]
    init = init_kernel_params(ptp, dtype=dtype, device=device)
    lower, upper = default_bounds(ptp, kind=config.kernel.kind, dtype=dtype,
                                  device=device)
    params = {
        name: torch.clamp(init[name], lower[name], upper[name])
        .expand(npc, *init[name].shape).clone()
        for name in ("log_amp", "log_ls", "log_noise")
    }
    return finalize_gp_state(params, x, y_batch, config, noise_diag)


def finalize_gp_state(
    params: dict,
    x: torch.Tensor,
    y_batch: torch.Tensor,
    config: GPConfig,
    noise_diag: torch.Tensor | None = None,
) -> GPState:
    """Cholesky (with jitter rescue), K^-1 y, explicit L^-1 and LML for a
    batch of GPs with known hyperparameters."""
    b, n = y_batch.shape
    ks = torch.stack([
        _build_k(_param_slice(params, k), x, config,
                 None if noise_diag is None else noise_diag[k])
        for k in range(b)
    ])
    chols = cholesky_jittered(ks)
    whitened = solve_lower_triangular(chols, y_batch)          # (b, n)
    alpha_vecs = torch.linalg.solve_triangular(
        chols.transpose(-2, -1), whitened.unsqueeze(-1), upper=True
    ).squeeze(-1)
    eye = torch.eye(n, dtype=x.dtype, device=x.device).expand(b, n, n)
    linvs = torch.linalg.solve_triangular(chols, eye, upper=False)
    lml = (
        -0.5 * (whitened * whitened).sum(1)
        - torch.log(torch.diagonal(chols, dim1=-2, dim2=-1)).sum(1)
        - 0.5 * n * math.log(2.0 * math.pi)
    )
    return GPState(params=params, x=x, y=y_batch, chol=chols,
                   alpha_vec=alpha_vecs, linv=linvs, lml=lml)


class _NormMeanVar(torch.autograd.Function):
    """(kstar^T alpha, |linv kstar|^2 per column) with a hand-written VJP.

    The backward reuses the forward's ``v = G k*``: ct_k* = alpha ct_mean +
    2 G^T (v ct_q), one extra product instead of plain autograd's two.
    """

    @staticmethod
    def forward(ctx, kstar, linv, alpha_vec):
        v = linv @ kstar
        ctx.save_for_backward(v, alpha_vec, linv, kstar)
        return kstar.transpose(-2, -1) @ alpha_vec, (v * v).sum(0)

    @staticmethod
    def backward(ctx, ct_mean, ct_q):
        v, alpha_vec, linv, kstar = ctx.saved_tensors
        if ct_mean is None:
            ct_mean = torch.zeros(kstar.shape[1], dtype=v.dtype, device=v.device)
        if ct_q is None:
            ct_q = torch.zeros_like(ct_mean)
        vq = v * ct_q[None, :]
        ct_kstar = alpha_vec[:, None] * ct_mean[None, :] + 2.0 * (linv.transpose(0, 1) @ vq)
        ct_linv = 2.0 * (vq @ kstar.transpose(0, 1)) if ctx.needs_input_grad[1] else None
        ct_alpha = kstar @ ct_mean if ctx.needs_input_grad[2] else None
        return ct_kstar, ct_linv, ct_alpha


def gp_predict(
    state: GPState,
    xq: torch.Tensor,
    *,
    config: GPConfig = GPConfig(),
    full_cov: bool = False,
    fast_grad: bool = False,
):
    """Posterior mean and (co)variance of each GP in the batch at ``xq``.

    Returns ``(mean (b, m), var (b, m))`` or ``(mean, cov (b, m, m))`` with
    ``full_cov``.  ``fast_grad`` (diag path only) routes the mean and the
    quadratic form through :class:`_NormMeanVar` (same values, cheaper
    reverse gradient; not forward-differentiable).
    """
    means, out2 = [], []
    for k in range(state.alpha_vec.shape[0]):
        params = _param_slice(state.params, k)
        linv, alpha_vec = state.linv[k], state.alpha_vec[k]
        kstar = kernel_fn(params, state.x, xq, config=config.kernel,
                          include_noise=False)                     # (n, m)
        if fast_grad and not full_cov:
            mean, q = _NormMeanVar.apply(kstar, linv, alpha_vec)
            kdiag = kernel_diag(params, xq, config=config.kernel)
            means.append(mean)
            out2.append(torch.clamp(kdiag - q, min=0.0))
            continue
        mean = kstar.transpose(0, 1) @ alpha_vec
        v = linv @ kstar
        if full_cov:
            kqq = kernel_fn(params, xq, config=config.kernel, include_noise=True)
            means.append(mean)
            out2.append(kqq - v.transpose(0, 1) @ v)
            continue
        kdiag = kernel_diag(params, xq, config=config.kernel)
        means.append(mean)
        out2.append(torch.clamp(kdiag - (v * v).sum(0), min=0.0))
    return torch.stack(means), torch.stack(out2)
