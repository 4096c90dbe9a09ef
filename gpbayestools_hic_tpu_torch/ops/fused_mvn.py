"""Fused batched MVN log-likelihood: hand-written CUDA kernel + plain version.

The reference-shaped calibration path evaluates, per walker and per
likelihood block (or once per walker on the stitched matrix)::

    lp = -1/2 y^T C^-1 y - sum(log diag L),   C = L L^T

Kernel (``csrc/fused_mvn.cu``, built by :mod:`._build`): replaces
``gpbayestools_hic_tpu/ops/pallas_mvn.py:_mvn_kernel``.  It eliminates the
augmented matrix ``[[C, y], [y^T, 0]]`` symmetrically, lower triangle
only: the pivots give the log-determinant and the last entry ends as
``-y^T C^-1 y``, so there is no separate solve.  A pivot that is not
positive and finite, or a non-finite result, gives ``-inf``.  One thread
block owns one matrix.  Both routes run the reference's blocked
right-looking order (factor a panel of columns, then apply its trailing
update as one product), FP32 FMA throughout, and are chosen from ``n``
alone:

- ``fused_mvn_loglike`` (n <= 318): the lower triangle packed in the
  block's shared memory beside a copy of the current 16-column panel; the
  panel's diagonal block factored by one warp, its rows below by a thread
  each, the trailing update in 4 x 4 register tiles.  cov's lower triangle
  and y are read once; three blocks share an SM at n = 170.  Bound by FP32
  operations at n = 170 (by bytes at the small flagship blocks).
- ``fused_mvn_loglike_panel`` (larger n, the stitched 544 x 544 matrix):
  32-column panels factored in shared memory, the trailing update applied
  in register tiles to a scratch copy in device memory that the wrapper
  allocates.  Bound by FP32 operations.

None of the TPU layout is kept (lane padding to 128, identity block,
``(b, 128)`` output, VMEM-sized batch chunks).

Dispatch: a CUDA tensor launches the kernel (or raises); a CPU tensor
takes the plain version.  There is no fallback to ``torch.linalg``.  The
gradient is not a kernel in the JAX package either: it is the closed form
``-C^-1 y``, ``1/2 (alpha alpha^T - C^-1)`` in plain torch, zero for a
matrix that is not positive definite and for a non-finite cotangent.
"""

from __future__ import annotations

import ctypes

import torch

from .linalg import mvn_loglike_batch, solve_cholesky
from .registry import count_launch, raise_on, register

_SOURCE = "gpbayestools_hic_tpu_torch/csrc/fused_mvn.cu"
_REPLACES = "gpbayestools_hic_tpu/ops/pallas_mvn.py:61"  # _mvn_kernel
register("fused_mvn_loglike", _SOURCE, _REPLACES)
register("fused_mvn_loglike_panel", _SOURCE, _REPLACES)


# ------------------------------------------------------------- plain version


def fused_mvn_loglike_plain(y: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
    """The kernel's elimination as a column loop of batched torch ops.

    y (b, n), cov (b, n, n), any floating dtype -> (b,).  Used by the CPU
    path, the tests and the on-card comparison with the kernel; it carries
    the trailing matrix whole (both triangles), which the kernel does not.
    """
    b, n = y.shape
    t = torch.zeros((b, n + 1, n + 1), dtype=cov.dtype, device=cov.device)
    t[:, :n, :n] = cov
    t[:, n, :n] = y
    t[:, :n, n] = y
    logdet_half = torch.zeros((b,), dtype=cov.dtype, device=cov.device)
    for _ in range(n):
        p = t[:, 0, 0]
        u = t[:, 1:, 0]
        logdet_half = logdet_half + 0.5 * torch.log(p)
        t = t[:, 1:, 1:] - u[:, :, None] * (u[:, None, :] / p[:, None, None])
    lp = 0.5 * t[:, 0, 0] - logdet_half
    return torch.where(torch.isfinite(lp), lp, torch.full_like(lp, -torch.inf))


# -------------------------------------------------------------- CUDA wrapper

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    from ._build import load

    lib = load("fused_mvn")
    if not getattr(lib, "_gpbt_typed", False):
        for name in ("fused_mvn_smem_max_n", "fused_mvn_panel_max_n", "fused_mvn_smem_panel"):
            getattr(lib, name).restype = _I
            getattr(lib, name).argtypes = []
        lib.fused_mvn_smem_blocks_per_sm.restype = _I
        lib.fused_mvn_smem_blocks_per_sm.argtypes = [_I]
        lib.fused_mvn_loglike_smem.restype = _I
        lib.fused_mvn_loglike_smem.argtypes = [_P] * 3 + [_I] * 2 + [_P]
        lib.fused_mvn_loglike_panel.restype = _I
        lib.fused_mvn_loglike_panel.argtypes = [_P] * 4 + [_I] * 2 + [_P]
        lib._gpbt_typed = True
    return lib


def _mvn_cuda(y: torch.Tensor, cov: torch.Tensor, route: str | None = None) -> torch.Tensor:
    """Launch the elimination kernel.  ``route`` (``"smem"`` / ``"panel"``)
    overrides the choice by size, for holding the panel route against the
    plain version at a small n."""
    for t in (y, cov):
        if t.device != y.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                "the fused MVN kernel takes contiguous float32 tensors on one "
                f"CUDA device; got {t.dtype} on {t.device} "
                f"(contiguous={t.is_contiguous()})"
            )
    if y.dim() != 2 or cov.shape != (*y.shape, y.shape[1]) or y.shape[1] < 1 or y.shape[0] < 1:
        raise ValueError(
            f"shape mismatch: y {tuple(y.shape)} needs cov (b, n, n), got {tuple(cov.shape)}"
        )
    b, n = y.shape
    lib = _lib()
    if route is None:
        route = "smem" if n <= lib.fused_mvn_smem_max_n() else "panel"
    limit = lib.fused_mvn_smem_max_n() if route == "smem" else lib.fused_mvn_panel_max_n()
    if route not in ("smem", "panel") or n > limit:
        raise ValueError(f"fused MVN route {route!r} takes n <= {limit}, got n = {n}")
    out = torch.empty((b,), dtype=torch.float32, device=y.device)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    with torch.cuda.device(y.device):
        if route == "smem":
            name = "fused_mvn_loglike"
            err = lib.fused_mvn_loglike_smem(y.data_ptr(), cov.data_ptr(), out.data_ptr(),
                                             b, n, stream)
        else:
            name = "fused_mvn_loglike_panel"
            # the matrix is eliminated in place in this copy; the kernel's
            # first panel fills it from cov and y
            scratch = torch.empty((b, n + 1, n + 1), dtype=torch.float32, device=y.device)
            err = lib.fused_mvn_loglike_panel(y.data_ptr(), cov.data_ptr(),
                                              scratch.data_ptr(), out.data_ptr(),
                                              b, n, stream)
    raise_on(err, f"{name} launch")
    count_launch(name)
    return out


def smem_blocks_per_sm(n: int) -> int:
    """Thread blocks of the shared-memory route one SM holds at this ``n``
    (needs the built library, so a CUDA machine)."""
    return _lib().fused_mvn_smem_blocks_per_sm(int(n))


def smem_panel() -> int:
    """Panel width of the shared-memory route (needs the built library)."""
    return _lib().fused_mvn_smem_panel()


def smem_max_n() -> int:
    """Largest n the shared-memory route takes (needs the built library)."""
    return _lib().fused_mvn_smem_max_n()


def fused_mvn_loglike(y: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
    """Forward only: kernel on a CUDA tensor, plain version on a CPU tensor."""
    if y.is_cuda:
        return _mvn_cuda(y, cov)
    return fused_mvn_loglike_plain(y, cov)


class _MVNLogLike(torch.autograd.Function):
    """Forward = the elimination kernel; backward = the closed form in
    plain torch (as in the JAX package, where it is left to XLA)."""

    @staticmethod
    def forward(ctx, y, cov):
        ctx.save_for_backward(y, cov)
        return fused_mvn_loglike(y, cov)

    @staticmethod
    def backward(ctx, g):
        y, cov = ctx.saved_tensors
        # d lp / dy = -C^-1 y;  d lp / dC = 1/2 (alpha alpha^T - C^-1)
        chol, info = torch.linalg.cholesky_ex(cov)
        good = info == 0
        eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
        # a non-PD element was -inf in the forward (a rejection): its
        # gradient is zero, not whatever its unfinished factor would give
        chol = torch.where(good[:, None, None], chol, eye)
        alpha = solve_cholesky(chol, y)
        cinv_half = torch.linalg.solve_triangular(chol, eye.expand_as(chol), upper=False)
        cinv = cinv_half.transpose(1, 2) @ cinv_half
        dcov = 0.5 * (alpha[:, :, None] * alpha[:, None, :] - cinv)
        # a -inf forward also makes the incoming cotangent ill-defined
        g = torch.where(torch.isfinite(g) & good, g, torch.zeros_like(g))
        return -g[:, None] * alpha, g[:, None, None] * dcov


def mvn_loglike_fused(y: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
    """Batched MVN log-likelihood through the fused kernel, differentiable:
    y (b, n), cov (b, n, n) -> (b,).  Same semantics as
    :func:`..ops.linalg.mvn_loglike_batch`."""
    return _MVNLogLike.apply(y.contiguous(), cov.contiguous())


def mvn_loglike_best(y: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
    """The fused kernel for float32 on CUDA, the batched library
    factorization elsewhere (CPU, float64)."""
    if cov.is_cuda and cov.dtype == torch.float32:
        return mvn_loglike_fused(y, cov)
    return mvn_loglike_batch(y, cov)
