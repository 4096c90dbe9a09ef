"""Batched exact Gaussian-process regression (PyTorch port of ``models/gp.py``).

Numerics match sklearn GPR with ``kernel = C * (RBF|Matern1.5) + White``,
``alpha = 0.1``:

- log marginal likelihood ``-1/2 y^T K^-1 y - sum log L_ii - n/2 log 2pi``
  with ``K = kernel(X) + alpha I``;
- hyperparameters optimized in log space under box bounds
  (:mod:`..ops.lbfgsb`), restarts drawn uniformly in the log-space box
  (sklearn's restart rule); every GP and every restart is one lane of one
  batched optimizer run;
- predictive mean ``k_*^T K^-1 y``; predictive variance ``k(x, x) - |G
  k_*|^2`` with ``G = L^-1`` -- includes the white-noise level but not
  alpha (sklearn convention), clipped at zero.

The restart points come from a ``torch.Generator`` seeded with ``seed``,
where the JAX package draws them with ``jax.random.uniform``: the streams
differ, so fits with restarts are not bit-equal across packages (the
optimizer from the same start points is; see :func:`_fit_from_starts`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import new_generator
from ..ops.kernels import (
    KernelConfig, default_bounds, init_kernel_params, kernel_diag, kernel_fn,
)
from ..ops.lbfgsb import lbfgsb_minimize
from ..ops.linalg import cholesky_jittered, solve_lower_triangular
from ..utils.profiling import span


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
    #: > 0 switches hyperparameter fitting from MLE to MAP: an isotropic
    #: Gaussian penalty of this precision in log-hyperparameter space,
    #: centred on the reference initialization (length scales = ptp, amp 1,
    #: noise 0.05)
    map_prior_strength: float = 0.0


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
    """K = kernel(x) + alpha I (+ diag(noise_diag)): (n, n) for one GP's
    params, (b, n, n) for a batch."""
    k = kernel_fn(params, x, config=config.kernel, include_noise=True)
    k = k + config.alpha * torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
    if noise_diag is not None:
        # heteroskedastic known simulation noise (stochastic kriging)
        k = k + torch.diag_embed(noise_diag)
    return k


def gp_nll(params: dict, x: torch.Tensor, y: torch.Tensor, config: GPConfig,
           noise_diag=None) -> torch.Tensor:
    """Negative log marginal likelihood, differentiable: () for one GP
    (``y`` (n,)), (b,) for a batch (``y`` (b, n)).

    A matrix that is not positive definite gives 1e30 (the JAX package's
    guard), so an L-BFGS trial there is a rejected step.  The plain
    ``cholesky_ex`` never raises, and its failed factors are set to NaN as
    ``jnp.linalg.cholesky`` leaves them, so such a lane's gradient is NaN
    as in the JAX package and never reaches another lane.
    """
    n = x.shape[0]
    k = _build_k(params, x, config, noise_diag)
    chol, info = torch.linalg.cholesky_ex(k)
    nan = torch.full((), float("nan"), dtype=k.dtype, device=k.device)
    chol = chol + torch.where(info != 0, nan, 0.0)[..., None, None]
    alpha_vec = solve_lower_triangular(chol, y)
    quad = (alpha_vec * alpha_vec).sum(-1)
    logdet_half = torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    nll = 0.5 * quad + logdet_half + 0.5 * n * math.log(2.0 * math.pi)
    return torch.where(torch.isfinite(nll), nll, torch.full_like(nll, 1e30))


def _pack(params: dict) -> torch.Tensor:
    """(..., 1 + d + 1) vector [log_amp, log_ls, log_noise]."""
    return torch.cat([params["log_amp"][..., None], params["log_ls"],
                      params["log_noise"][..., None]], dim=-1)


def _unpack(vec: torch.Tensor, d: int) -> dict:
    return {"log_amp": vec[..., 0], "log_ls": vec[..., 1:1 + d],
            "log_noise": vec[..., 1 + d]}


def _start_and_bounds(ptp, config: GPConfig, dtype, device):
    init = init_kernel_params(ptp, dtype=dtype, device=device)
    lower, upper = default_bounds(ptp, kind=config.kernel.kind, dtype=dtype,
                                  device=device)
    return _pack(init), _pack(lower), _pack(upper)


def _check_no_tf32(device: torch.device) -> None:
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "GP training needs full float32 products; "
            "torch.backends.cuda.matmul.allow_tf32 is True (the package "
            "switches it off on import: see config.disable_tf32)"
        )


def gp_fit(
    x: torch.Tensor,
    y_batch: torch.Tensor,
    ptp,
    *,
    config: GPConfig = GPConfig(),
    nrestarts: int = 0,
    seed: int = 0,
    generator: torch.Generator | None = None,
    maxiter: int = 200,
    noise_diag: torch.Tensor | None = None,
    ls_growth: float = 2.0,
    stats: dict | None = None,
) -> GPState:
    """Fit ``npc`` independent GPs on shared inputs in one batched run.

    ``x`` (n, d), ``y_batch`` (npc, n).  ``ptp`` (d,) sets the reference
    initialization (length scales = parameter ranges) and the bounds.
    With ``nrestarts > 0`` each GP also starts from ``nrestarts`` points
    drawn uniformly in the log-bound box (from ``generator``, else a
    generator seeded with ``seed`` on ``x``'s device) and its best optimum
    wins (sklearn ``n_restarts_optimizer`` semantics).  ``noise_diag``
    (npc, n) adds known per-point noise variances to each GP's Gram
    diagonal.  ``ls_growth`` is the line search's warm-start growth (see
    :func:`..ops.lbfgsb.lbfgsb_minimize`); every trial is a batched O(n^3)
    Cholesky, so the trial count is the fit's time.  ``stats``, when given,
    receives the optimizer's counts (:func:`lbfgsb_minimize`).
    """
    theta0, lower, upper = _start_and_bounds(ptp, config, x.dtype, x.device)
    if nrestarts > 0:
        if generator is None:
            generator = new_generator(x.device, seed)
        u = torch.rand((nrestarts, theta0.shape[0]), generator=generator,
                       dtype=x.dtype, device=x.device)
        starts = torch.cat([theta0[None], lower + u * (upper - lower)], dim=0)
    else:
        starts = theta0[None]
    return _fit_from_starts(x, y_batch, ptp, starts, config=config, maxiter=maxiter,
                            noise_diag=noise_diag, ls_growth=ls_growth, stats=stats)


def _fit_from_starts(
    x: torch.Tensor,
    y_batch: torch.Tensor,
    ptp,
    starts: torch.Tensor,
    *,
    config: GPConfig,
    maxiter: int,
    noise_diag: torch.Tensor | None = None,
    ls_growth: float = 2.0,
    stats: dict | None = None,
) -> GPState:
    """:func:`gp_fit` from given start points ``starts`` (nstarts, 2 + d),
    the first being the reference initialization: every (GP, start) pair is
    one lane of one optimizer run, and each GP keeps its best lane."""
    _check_no_tf32(x.device)
    d = x.shape[1]
    npc = y_batch.shape[0]
    nstarts = starts.shape[0]
    theta0, lower, upper = _start_and_bounds(ptp, config, x.dtype, x.device)
    # lane = gp * nstarts + start
    y_lanes = y_batch.repeat_interleave(nstarts, dim=0)
    nd_lanes = None if noise_diag is None else noise_diag.repeat_interleave(nstarts, dim=0)
    x0 = starts.to(dtype=x.dtype, device=x.device).repeat(npc, 1)

    def objective(theta):
        nll = gp_nll(_unpack(theta, d), x, y_lanes, config, nd_lanes)
        if config.map_prior_strength > 0.0:
            # MAP objective (see GPConfig.map_prior_strength)
            nll = nll + 0.5 * config.map_prior_strength * ((theta - theta0) ** 2).sum(-1)
        return nll

    res = lbfgsb_minimize(objective, x0, lower, upper, maxiter=maxiter,
                          ls_growth=ls_growth, stats=stats)
    thetas = res.x.reshape(npc, nstarts, -1)
    best = torch.argmin(res.fun.reshape(npc, nstarts), dim=1)
    theta_best = thetas[torch.arange(npc, device=x.device), best]
    return finalize_gp_state(_unpack(theta_best, d), x, y_batch, config, noise_diag)


def finalize_gp_state(
    params: dict,
    x: torch.Tensor,
    y_batch: torch.Tensor,
    config: GPConfig,
    noise_diag: torch.Tensor | None = None,
) -> GPState:
    """Cholesky (with jitter rescue), K^-1 y, explicit L^-1 and LML for a
    batch of GPs with known hyperparameters (one batched Gram build)."""
    b, n = y_batch.shape
    params = {name: v.detach() for name, v in params.items()}
    ks = _build_k(params, x, config, noise_diag)
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
        with span("hic.predict_bwd"):
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


def gp_sample(
    state: GPState,
    xq: torch.Tensor,
    n_samples: int,
    *,
    config: GPConfig = GPConfig(),
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Joint posterior draws at ``xq`` for each GP independently: (b, m,
    n_samples) (sklearn ``sample_y``); normals from ``generator``."""
    mean, cov = gp_predict(state, xq, config=config, full_cov=True)
    chol = cholesky_jittered(cov)
    z = torch.randn((*mean.shape, n_samples), generator=generator,
                    dtype=mean.dtype, device=mean.device)
    return mean[..., None] + chol @ z
