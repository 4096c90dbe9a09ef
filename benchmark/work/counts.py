"""Operations and bytes the algorithm needs, and the least time they take.

Copied from ``chip_smoke.py::fwd_work``, ``bwd_work`` and ``mvn_work`` and
changed to count the algorithm rather than one implementation: every pass
multiplier is one (a product counts its multiply-adds once, whatever number
of TF32 passes a kernel spends on it), each input is read once and each
output written once per call (float32).  The shares built on these counts
stay under 100% for any implementation that the port's precision rules
admit:

- the predict products (``[G; alpha] k*`` in the forward, ``G^T v`` in the
  backward) are valued at the dense 16-bit tensor-core peak, since the
  variance-only and gradient products may take 16-bit operands;
- every other operation at the dense TF32 tensor-core peak;
- bytes at the HBM rate.

Peaks: NVIDIA H100 SXM data sheet, dense, at its 700 W limit.
"""

from __future__ import annotations

from typing import NamedTuple

PEAK_16BIT_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
F32 = 4


class Work(NamedTuple):
    """Operations split by the peak they are valued at, and bytes."""

    flops_16: float = 0.0    # products that may run on 16-bit operands
    flops_tf32: float = 0.0  # every other operation
    nbytes: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(*(a + b for a, b in zip(self, other)))

    def scaled(self, k: float) -> "Work":
        return Work(*(a * k for a in self))

    @property
    def flops(self) -> float:
        return self.flops_16 + self.flops_tf32


def least_seconds(work: Work) -> float:
    """The least time the card could take: the operations at their peaks or
    the bytes at the memory rate, whichever is longer."""
    t_ops = work.flops_16 / PEAK_16BIT_FLOPS + work.flops_tf32 / PEAK_TF32_FLOPS
    return max(t_ops, work.nbytes / PEAK_BYTES)


def fwd_work(b: int, n: int, m: int, d: int) -> Work:
    """The GP predict forward on b GPs of n training points at m queries:
    [G; alpha] (lower triangle and the alpha row) against k*, the
    quadratic form and the k* build (direct differences, the exp and its
    scaling).  Bytes: G, alpha, the scaled training inputs and the queries
    read, mean and quadratic form written; v = G k*, which a backward
    reads, is an intermediate of one implementation and is not counted."""
    products = b * m * (n * (n + 1) + 2 * n)
    other = b * (2 * n * m + n * m * (3 * d + 2))
    nbytes = F32 * (b * n * n + b * n * d + m * d + b * d + b * n + b + 2 * b * m)
    return Work(products, other, nbytes)


def bwd_work(b: int, n: int, m: int, d: int) -> Work:
    """The predict backward: G^T against v (lower triangle); ct_v's
    scalings and the alpha term, the k* recompute and its cotangent, the
    query cotangent.  Bytes as in :func:`fwd_work`, with the two incoming
    cotangents read and the (b, m, d) query cotangent written."""
    products = b * n * (n + 1) * m
    other = b * (2 * n * m + n * m * (3 * d + 4) + 3 * n * m * d)
    nbytes = F32 * (b * n * n + b * n * d + m * d + b * d + b * n + b
                    + 2 * b * m + b * m * d)
    return Work(products, other, nbytes)


def mvn_work(b: int, n: int) -> Work:
    """The MVN log-likelihood of b matrices of order n: per pivot k one
    multiply-add for each entry of the trailing lower triangle with the
    residual row, the scaling of column k and a log (about n^3 / 3 flops
    per matrix); the lower triangle and the residual read once, lp written
    once."""
    per = sum((n - k) * (n - k + 1) + (n - k) + 2 for k in range(n))
    return Work(0.0, b * per, F32 * (b * (n * (n + 1) // 2 + n) + b))


def woodbury_work(m: int, npc: int) -> Work:
    """The PC-space Woodbury epilogue of one emulator at m walkers: the
    residual, B = M^-1 + diag(v), its Cholesky, the solve, the quadratic
    form and the log-determinant (value only; the gradient about doubles
    it, which is left uncounted)."""
    k = npc
    flops = m * (k + k * k + k ** 3 / 3 + k * k + 2 * k + k)
    return Work(0.0, flops, F32 * (2 * m * k + m))


def assembly_work(m: int, npc: int, nobs: int, write_cov: bool = True) -> Work:
    """One emulator's dense predictive covariance at m walkers: the mean
    (gp_mean @ A), cov = var @ (a_k a_k^T) over the npc PCs plus the
    truncation covariance and the experimental variances; the fixed parts
    read once, the mean written, and with ``write_cov`` the (m, nobs, nobs)
    covariance written once (a stitched likelihood writes its one large
    matrix instead: :func:`stitched_fill_work`)."""
    flops = m * (2 * npc * nobs + 2 * npc * nobs * nobs + 2 * nobs * nobs)
    nbytes = F32 * (m * nobs + (npc + 1) * nobs * nobs
                    + (m * nobs * nobs if write_cov else 0))
    return Work(0.0, flops, nbytes)


def stitched_fill_work(m: int, nobs: int) -> Work:
    """The one (m, nobs, nobs) block-diagonal covariance of a stitched
    likelihood, written once."""
    return Work(0.0, 0.0, F32 * m * nobs * nobs)


def posterior_work(cfg: dict, mode: str, m: int, grad: bool) -> dict[str, Work]:
    """One posterior call at m walkers under configuration ``cfg`` and
    likelihood ``mode``, by layer: ``predict`` (the GP predict, forward and,
    with ``grad``, backward), ``mvn`` (the dense MVN log-likelihoods) and
    ``other`` (the Woodbury epilogue or the covariance assembly)."""
    n, d, npc = cfg["n_design"], cfg["ndim"], cfg["npc"]
    blocks = cfg["blocks"]
    predict, mvn, other = Work(), Work(), Work()
    for nobs in blocks:
        predict = predict + fwd_work(npc, n, m, d)
        if grad:
            predict = predict + bwd_work(npc, n, m, d)
        if mode == "auto":
            other = other + woodbury_work(m, npc)
        elif mode == "generic":
            other = other + assembly_work(m, npc, nobs)
            mvn = mvn + mvn_work(m, nobs)
        elif mode == "stitched":
            other = other + assembly_work(m, npc, nobs, write_cov=False)
        else:
            raise ValueError(f"unknown likelihood mode {mode!r}")
    if mode == "stitched":
        other = other + stitched_fill_work(m, sum(blocks))
        mvn = mvn_work(m, sum(blocks))
    return {"predict": predict, "mvn": mvn, "other": other}
