"""Dense linear algebra for GP emulation and the calibration likelihood.

Port of the JAX package's ``ops/linalg.py``: the jitter-rescued Cholesky of
GP training, the triangular solves, the small-SPD quadratic form +
log-determinant of the Woodbury capacitance, and the dense and
diagonal-covariance MVN log-likelihoods.

``jnp.linalg.cholesky`` returns NaN for a matrix that is not positive
definite; ``torch.linalg.cholesky`` raises.  Everything here factors with
``torch.linalg.cholesky_ex`` (no error check) and masks on its per-matrix
``info``, so one bad matrix of a batch never touches the others and never
raises: it yields NaN from :func:`cholesky_jittered` and ``-inf`` from the
log-likelihoods (the sampler's rejection).
"""

from __future__ import annotations

import torch

from ..config import chol_jitter


def solve_lower_triangular(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L x = b with L lower triangular. b: (..., n) or (..., n, k)."""
    vec = b.dim() == chol.dim() - 1
    b2 = b.unsqueeze(-1) if vec else b
    x = torch.linalg.solve_triangular(chol, b2, upper=False)
    return x.squeeze(-1) if vec else x


def solve_cholesky(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given A = L L^T. b: (..., n) or (..., n, k)."""
    vec = b.dim() == chol.dim() - 1
    b2 = b.unsqueeze(-1) if vec else b
    z = torch.linalg.solve_triangular(chol, b2, upper=False)
    x = torch.linalg.solve_triangular(chol.transpose(-2, -1), z, upper=True)
    return x.squeeze(-1) if vec else x


def _eye_like(a: torch.Tensor) -> torch.Tensor:
    return torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)


def cholesky_jittered(a: torch.Tensor, jitter_scale: float | None = None) -> torch.Tensor:
    """Cholesky with a one-shot diagonal jitter rescue, per matrix.

    Factor ``a``; where a matrix is not positive definite, refactor ``a +
    jitter * mean(diag(a)) * I`` instead.  A matrix that stays non-PD after
    the bump yields NaN, which callers treat as a -inf likelihood.  Batched
    inputs (..., n, n) are handled per matrix: one non-PD element never
    perturbs its healthy neighbours.

    The probe factorizations run on detached copies and only decide which
    branch is selected; every differentiated factorization runs on an
    input that is positive definite (double-where pattern), so the
    unselected branch cannot put NaN into a gradient.
    """
    if jitter_scale is None:
        jitter_scale = chol_jitter(a.dtype)
    probe, info = torch.linalg.cholesky_ex(a.detach())
    bad = info != 0
    if not bool(bad.any()):
        return torch.linalg.cholesky_ex(a)[0] if a.requires_grad else probe
    eye = _eye_like(a)
    badb = bad[..., None, None]
    mean_diag = torch.diagonal(a, dim1=-2, dim2=-1).mean(-1)
    bumped = a + jitter_scale * mean_diag[..., None, None] * eye
    _, info_r = torch.linalg.cholesky_ex(bumped.detach())
    lost = (bad & (info_r != 0))[..., None, None]
    chol_plain, _ = torch.linalg.cholesky_ex(torch.where(badb, eye, a))
    chol_rescued, _ = torch.linalg.cholesky_ex(torch.where(badb & ~lost, bumped, eye))
    chol_rescued = torch.where(lost, torch.full_like(chol_rescued, float("nan")),
                               chol_rescued)
    return torch.where(badb, chol_rescued, chol_plain)


def spd_qform_logdet(s: torch.Tensor, z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(z^T S^-1 z, log det S)`` for batched small SPD matrices.

    ``s`` (..., k, k), ``z`` (..., k); returns two (...,) tensors.  One
    batched library factorization and one triangular solve (the quadratic
    form is ``|L^-1 z|^2``).  A matrix that is not positive definite gives
    NaN in both (never an exception), so callers' isfinite -> -inf guards
    keep working.  Differentiable through plain autograd.

    The JAX package unrolls the Cholesky-Crout recurrence per entry for
    the TPU.  On the GPU that makes O(k^2) small launches forward and
    backward: on an H100 the flagship's posterior gradient (4 x 4 blocks)
    took 2.7 times as long unrolled (profiled with ``torch.profiler``).
    """
    chol, info = torch.linalg.cholesky_ex(s)
    w = torch.linalg.solve_triangular(chol, z.unsqueeze(-1), upper=False)
    quad = (w.squeeze(-1) ** 2).sum(-1)
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    ok = info == 0
    nan = torch.full_like(quad, float("nan"))
    return torch.where(ok, quad, nan), torch.where(ok, logdet, nan)


def mvn_loglike_diagcov_batch(y: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """Diagonal-covariance MVN log-likelihood: y (b, n), var (b, n) -> (b,)."""
    quad = (y * y / var).sum(-1)
    logdet_half = 0.5 * torch.log(var).sum(-1)
    lp = -0.5 * quad - logdet_half
    return torch.where(torch.isfinite(lp), lp, torch.full_like(lp, -torch.inf))


def _mvn_from_chol(chol: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    alpha = solve_lower_triangular(chol, y)
    quad = (alpha * alpha).sum(-1)
    logdet_half = torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    return -0.5 * quad - logdet_half


def _finite_or_neg_inf(lp: torch.Tensor, ok: torch.Tensor | None = None) -> torch.Tensor:
    keep = torch.isfinite(lp) if ok is None else ok & torch.isfinite(lp)
    return torch.where(keep, lp, torch.full_like(lp, -torch.inf))


def mvn_loglike(y: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
    """Unnormalized MVN log-likelihood of difference vector ``y`` under ``cov``.

        log p = -1/2 y^T C^-1 y - sum(log diag(L)),   C = L L^T

    without the -n/2 log(2 pi) constant; one Cholesky with the jitter
    rescue of :func:`cholesky_jittered`.  -inf where even the rescued
    factorization failed.  ``y`` (..., n), ``cov`` (..., n, n).
    """
    return _finite_or_neg_inf(_mvn_from_chol(cholesky_jittered(cov), y))


def mvn_loglike_fast(y: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
    """Like :func:`mvn_loglike` without the jitter rescue: a covariance that
    is not positive definite gives -inf directly (the sampler's rejection).
    For covariances that carry an explicit diagonal (experimental variances,
    alpha), where the rescue would only double the Cholesky cost.

    A non-PD matrix contributes a zero gradient, never NaN: when a gradient
    is recorded, the differentiated factorization runs on the identity in
    its place and the -inf is selected afterwards.
    """
    chol, info = torch.linalg.cholesky_ex(cov.detach())
    ok = info == 0
    if torch.is_grad_enabled() and (cov.requires_grad or y.requires_grad):
        safe = torch.where(ok[..., None, None], cov, _eye_like(cov))
        chol, _ = torch.linalg.cholesky_ex(safe)
    else:
        chol = torch.where(ok[..., None, None], chol, _eye_like(cov))
    return _finite_or_neg_inf(_mvn_from_chol(chol, y), ok)


def mvn_loglike_batch(y: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
    """Batched MVN log-likelihood: y (b, n), cov (b, n, n) -> (b,).

    One batched Cholesky + one batched triangular solve + reductions, on
    the no-rescue path (non-PD -> -inf).  The library-call form of the
    fused elimination kernel (:mod:`.fused_mvn`), and what the likelihood
    uses wherever that kernel does not apply (CPU, float64)."""
    return mvn_loglike_fast(y, cov)
