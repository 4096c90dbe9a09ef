"""Dense linear algebra for GP emulation and the calibration likelihood.

Port of the pieces of the JAX package's ``ops/linalg.py`` that the main
path runs: the jitter-rescued Cholesky of GP training, the triangular
solve, the unrolled small-SPD quadratic form + log-determinant of the
Woodbury capacitance, and the diagonal-covariance MVN log-likelihood.
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


def cholesky_jittered(a: torch.Tensor, jitter_scale: float | None = None) -> torch.Tensor:
    """Cholesky with a one-shot diagonal jitter rescue, per matrix.

    Factor ``a``; where a matrix's factor is not finite (not positive
    definite), refactor ``a + jitter * mean(diag(a)) * I`` instead.  A
    matrix that stays non-PD after the bump yields NaN, which callers treat
    as a -inf likelihood.  Batched inputs (..., n, n) are handled per
    matrix: one non-PD element never perturbs its healthy neighbours.
    """
    if jitter_scale is None:
        jitter_scale = chol_jitter(a.dtype)
    chol, info = torch.linalg.cholesky_ex(a)
    bad = info != 0
    if not bool(bad.any()):
        return chol
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    mean_diag = torch.diagonal(a, dim1=-2, dim2=-1).mean(-1)
    bumped = a + jitter_scale * mean_diag[..., None, None] * eye
    chol_r, info_r = torch.linalg.cholesky_ex(bumped)
    chol_r = torch.where(
        (info_r != 0)[..., None, None], torch.full_like(chol_r, float("nan")),
        chol_r,
    )
    return torch.where(bad[..., None, None], chol_r, chol)


def spd_qform_logdet(
    s: torch.Tensor, z: torch.Tensor, *, max_unroll: int = 32
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(z^T S^-1 z, log det S)`` for batched SMALL SPD matrices, unrolled.

    ``s`` (..., k, k), ``z`` (..., k) with k known on the host; returns two
    (...,) tensors.  The Cholesky-Crout recurrence is written out per
    entry, so only forward substitution is needed (the quadratic form is
    ``|L^-1 z|^2``) and no factor is materialized.  A non-PD input hits the
    square root of a negative pivot and gives NaN (never an exception), so
    callers' isfinite -> -inf guards keep working.  Differentiable through
    plain autograd.  Matrices larger than ``max_unroll`` use the batched
    library factorization.
    """
    k = s.shape[-1]
    if k > max_unroll:
        chol, _ = torch.linalg.cholesky_ex(s)
        w = torch.linalg.solve_triangular(chol, z.unsqueeze(-1), upper=False)
        logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
        return (w.squeeze(-1) ** 2).sum(-1), logdet
    lo = [[None] * k for _ in range(k)]
    w: list = [None] * k
    logdet_half = None
    for j in range(k):
        d = s[..., j, j]
        for p in range(j):
            d = d - lo[j][p] * lo[j][p]
        dj = torch.sqrt(d)
        wj = z[..., j]
        for p in range(j):
            wj = wj - lo[j][p] * w[p]
        w[j] = wj / dj
        lg = torch.log(dj)
        logdet_half = lg if logdet_half is None else logdet_half + lg
        for i in range(j + 1, k):
            off = s[..., i, j]
            for p in range(j):
                off = off - lo[i][p] * lo[j][p]
            lo[i][j] = off / dj
    q = w[0] * w[0]
    for j in range(1, k):
        q = q + w[j] * w[j]
    return q, 2.0 * logdet_half


def mvn_loglike_diagcov_batch(y: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """Diagonal-covariance MVN log-likelihood: y (b, n), var (b, n) -> (b,)."""
    quad = (y * y / var).sum(-1)
    logdet_half = 0.5 * torch.log(var).sum(-1)
    lp = -0.5 * quad - logdet_half
    return torch.where(torch.isfinite(lp), lp, torch.full_like(lp, -torch.inf))
