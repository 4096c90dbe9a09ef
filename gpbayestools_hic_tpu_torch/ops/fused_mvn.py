"""Fused batched MVN log-likelihood: hand-written CUDA kernel + plain version.

The reference-shaped calibration path evaluates, per walker and per
likelihood block (or once per walker on the stitched matrix)::

    lp = -1/2 y^T C^-1 y - sum(log diag L),   C = L L^T

Kernel (``csrc/fused_mvn.cu``, built by :mod:`._build`): replaces
``gpbayestools_hic_tpu/ops/pallas_mvn.py:_mvn_kernel``.  It eliminates the
augmented matrix ``[[C, y], [y^T, 0]]`` symmetrically, lower triangle
only: the pivots give the log-determinant and the last entry ends as
``-y^T C^-1 y``, so there is no separate solve.  A pivot that is not
positive and finite, or a non-finite result, gives ``-inf``.  One warp,
one thread block or one cluster owns one matrix.  All routes run the
reference's blocked right-looking order (factor a panel of columns, then
apply its trailing update as one product; the warp kernel's one panel is
the whole matrix), FP32-class arithmetic throughout, and are chosen from
``n`` alone:

- ``fused_mvn_loglike`` (n <= 319, the shared-memory route), two kernels
  by n.  Up to n = 32 (six of the flagship's nine blocks) one warp per
  matrix, its rows read straight into registers, no block barrier and no
  shared memory.  Past it, the lower triangle packed in the
  block's shared memory (copied in by ``cp.async``) beside a copy of the
  current 16-column panel; each panel's diagonal block factored by one
  warp, which factors the next panel's block while the other warps apply
  the rest of the trailing update (look-ahead; panel 0's straight from
  device memory while the triangle lands), its rows below by a thread
  each, the trailing update in 4 x 4 register tiles; two block barriers
  per panel.
  cov's lower triangle and y are read once; three blocks share an SM at
  n = 170.  Bound by FP32 operations at n = 170 (by bytes at the small
  flagship blocks).
- ``fused_mvn_loglike_panel`` (the wide route, every n past the
  shared-memory route's largest: 320 and up, the stitched 544 x 544
  matrix among them): the trailing matrix in a scratch copy in device
  memory that the wrapper allocates, one thread-block cluster of
  C = 1 .. 8 CTAs per matrix (more at small b, to fill the card),
  64-column panels: every CTA factors the panel's 64 x 64 diagonal block
  in 16-column steps, the rows below stream through shared memory in
  chunks dealt out over the cluster, then one trailing update per panel
  in 64 x 64 tiles over the cluster, the product in 3xTF32 on the tensor
  cores (FP32 promotion per 8-wide step).  Its shared memory does not
  grow with n.  :func:`wide_layout` mirrors the kernel's layout.  At
  n = 544 it holds 264 matrices at once (one CTA each, two per SM);
  a matrix held whole in the shared memory of a 4-CTA cluster was slower
  there at every b >= 512 (PERF.md).

As in the JAX ``mvn_loglike_best``, which sends every float32 call on the
TPU to its kernel, :func:`mvn_loglike_best` sends every float32 CUDA batch
to the kernel: a kernel that fails to build or launch raises.

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
import functools
from typing import NamedTuple

import torch

from .linalg import mvn_loglike_batch, solve_cholesky
from ..utils.profiling import span
from .registry import count_launch, raise_on, register

_SOURCE = "gpbayestools_hic_tpu_torch/csrc/fused_mvn.cu"
_REPLACES = "gpbayestools_hic_tpu/ops/pallas_mvn.py:61"  # _mvn_kernel
register("fused_mvn_loglike", _SOURCE, _REPLACES)
register("fused_mvn_loglike_panel", _SOURCE, _REPLACES)


# ---------------------------------------------- routes and the wide layout
# Mirrors of the host functions of csrc/fused_mvn.cu (the CPU tests check
# them; the on-card tests hold them against the built library, whose
# numbers the wrapper dispatches by).

SMEM_LIMIT = 232448  # bytes of shared memory one block may use (H100)
SMEM_PANEL = 16      # panel width of the shared-memory route
WARP_MAX_N = 32      # largest n of the shared-memory route's warp kernel
WIDE_PANEL = 64      # panel width of the wide route ("panel")
WIDE_STEP = 16       # factoring step = row-block height of the wide route
WIDE_TILE = 64       # trailing-update tile of the wide route
WIDE_CHUNK = 256     # rows below the panel per chunk in shared memory
WIDE_MAX_CLUSTER = 8  # largest cluster the wide route uses
WIDE_THREADS = 256
WIDE_STAGES = 2      # depth of the wide route's trailing-update ring
SM_SMEM = 233472     # bytes of shared memory per SM (H100), 1 KB per CTA reserved


def _tri(i: int) -> int:
    return i * (i + 1) // 2


def _align4(x: int) -> int:
    return (x + 3) & ~3


def smem_bytes(n: int) -> int:
    """Shared memory of the shared-memory route at n (``smem_bytes``)."""
    p, ld = SMEM_PANEL, SMEM_PANEL + 4
    return 4 * (_align4(_tri(n + 1)) + (n + 1 + p) * ld + p + 1)


def wide_rows(n: int, c: int, c0: int = 0, p: int = WIDE_PANEL) -> list[list[int]]:
    """Rows below the wide route's panel starting at column c0 (rows
    c1 .. n, c1 = min(c0 + p, n)) each rank of a c-CTA cluster takes through
    shared memory: chunk k of WIDE_CHUNK rows belongs to rank k mod c.  The
    panel's top rows c0 .. c1 - 1 are in every rank."""
    c1 = min(c0 + p, n)
    return [[i for i in range(c1, n + 1) if ((i - c1) // WIDE_CHUNK) % c == r]
            for r in range(c)]


def wide_bytes(p: int = WIDE_PANEL) -> int:
    """Dynamic shared memory per CTA of the wide route (``wide_bytes``), the
    same at every n: every step's factored 16 x 16 block and its
    1 / sqrt(p), the flag, then the panel's top rows and a chunk of the rows
    below (stride p + 4), or the trailing update's ring stages (two 64-row
    L tiles and a 64 x 68 scratch tile each), whichever is larger: they
    share memory."""
    s, t, ld = WIDE_STEP, WIDE_TILE, p + 4
    fixed = (p // s) * (s * (s + 4) + s) + 4
    stage = 2 * t * ld + t * (t + 4)
    return 4 * (fixed + max((p + WIDE_CHUNK) * ld, WIDE_STAGES * stage))


class WideLayout(NamedTuple):
    c: int            # CTAs per cluster
    ctas_per_sm: int  # CTAs per SM the kernel is built for
    p: int            # panel width
    bytes: int        # dynamic shared memory per CTA
    scratch: int      # floats of one matrix's scratch: n + 1 rows of whole float4s


def wide_layout(b: int, n: int, sms: int) -> WideLayout:
    """The wide route's layout at (b, n) on a card of ``sms`` SMs: the
    smallest cluster (1 .. 8 CTAs) that makes b C cover the SMs, and the
    kernel built for two CTAs per SM where b C exceeds the SMs and two
    CTAs' shared memory fit one, else for one.  Every n >= 1."""
    if b < 1 or n < 1 or sms < 1:
        raise ValueError(f"the wide route needs b, n and sms >= 1, got {b}, {n}, {sms}")
    c = max(1, min(-(-sms // b), WIDE_MAX_CLUSTER))
    nbytes = wide_bytes()
    k = 2 if b * c > sms and 2 * (nbytes + 1024) <= SM_SMEM else 1
    return WideLayout(c, k, WIDE_PANEL, nbytes, (n + 1) * _align4(n + 1))


def route_limits() -> dict[str, tuple[int, int | None]]:
    """The n range of each route, as the wrapper picks them: smallest and
    largest n (``fused_mvn_smem_max_n``; None: the wide route takes every
    n past the shared-memory route)."""
    smem = 1
    while smem_bytes(smem + 1) <= SMEM_LIMIT:
        smem += 1
    return {"smem": (1, smem), "panel": (smem + 1, None)}


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
        for name in ("fused_mvn_smem_max_n", "fused_mvn_smem_panel",
                     "fused_mvn_panel_width", "fused_mvn_panel_sms", "fused_mvn_panel_bytes"):
            getattr(lib, name).restype = _I
            getattr(lib, name).argtypes = []
        for name in ("fused_mvn_smem_matrices_per_sm", "fused_mvn_panel_cluster",
                     "fused_mvn_panel_ctas_per_sm", "fused_mvn_panel_active"):
            getattr(lib, name).restype = _I
            getattr(lib, name).argtypes = [_I]
        lib.fused_mvn_panel_scratch.restype = ctypes.c_longlong
        lib.fused_mvn_panel_scratch.argtypes = [_I]
        lib.fused_mvn_loglike_smem.restype = _I
        lib.fused_mvn_loglike_smem.argtypes = [_P] * 3 + [_I] * 2 + [_P]
        lib.fused_mvn_loglike_panel.restype = _I
        lib.fused_mvn_loglike_panel.argtypes = [_P] * 4 + [_I] * 2 + [_P]
        lib._gpbt_typed = True
    return lib


#: route -> (kernel name in the registry, its C entry, the C entry of its
#: largest n, None where the route takes every n)
_ROUTES = {
    "smem": ("fused_mvn_loglike", "fused_mvn_loglike_smem", "fused_mvn_smem_max_n"),
    "panel": ("fused_mvn_loglike_panel", "fused_mvn_loglike_panel", None),
}


def _mvn_cuda(y: torch.Tensor, cov: torch.Tensor, route: str | None = None) -> torch.Tensor:
    """Launch the elimination kernel.  The route follows n (smem up to its
    largest n, then the wide route ``"panel"``); ``route`` (``"smem"`` /
    ``"panel"``) forces one, for holding each
    against the plain version at any n it takes (the wide route: every
    n).  A failed launch, or n past the route's largest, raises: no other
    route is tried."""
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
        route = "smem" if n <= route_max_n("smem") else "panel"
    if route not in _ROUTES:
        raise ValueError(f"unknown fused MVN route {route!r}")
    name, entry, _ = _ROUTES[route]
    limit = route_max_n(route)
    if limit is not None and n > limit:
        raise ValueError(f"fused MVN route {route!r} takes n <= {limit}, got n = {n}")
    out = torch.empty((b,), dtype=torch.float32, device=y.device)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    ptrs = [y.data_ptr(), cov.data_ptr()]
    if route == "panel":
        # the matrix is eliminated in place in this copy; the kernel's first
        # panel fills it from cov and y
        scratch = torch.empty((b, lib.fused_mvn_panel_scratch(n)), dtype=torch.float32,
                              device=y.device)
        ptrs.append(scratch.data_ptr())
    with torch.cuda.device(y.device):
        err = getattr(lib, entry)(*ptrs, out.data_ptr(), b, n, stream)
    raise_on(err, f"{name} launch")
    count_launch(name, y.device)
    return out


def wide_info(b: int, n: int) -> dict[str, int]:
    """The built wide route at (b, n) on the current device: its SM count,
    CTAs per cluster, the CTAs per SM the launched kernel is built for,
    panel width, shared memory per CTA, floats of one matrix's scratch, and
    the clusters the card holds at once (``cudaOccupancyMaxActiveClusters``);
    needs a CUDA machine."""
    lib = _lib()
    b, n = int(b), int(n)
    return {"sms": lib.fused_mvn_panel_sms(), "c": lib.fused_mvn_panel_cluster(b),
            "ctas_per_sm": lib.fused_mvn_panel_ctas_per_sm(b), "p": lib.fused_mvn_panel_width(),
            "bytes": lib.fused_mvn_panel_bytes(), "scratch": lib.fused_mvn_panel_scratch(n),
            "active_clusters": lib.fused_mvn_panel_active(b)}


@functools.cache
def route_max_n(route: str) -> int | None:
    """Largest n the built route takes, None for the wide route, which
    takes every n (needs the built library; asked once per process: the
    dispatch reads it on every call)."""
    entry = _ROUTES[route][2]
    return None if entry is None else getattr(_lib(), entry)()


def smem_matrices_per_sm(n: int) -> int:
    """Matrices of the shared-memory route one SM holds at once at this
    ``n``: warps of its warp kernel (n <= WARP_MAX_N), blocks of its block
    kernel (needs the built library, so a CUDA machine)."""
    return _lib().fused_mvn_smem_matrices_per_sm(int(n))


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
    """The fused kernel for float32 on CUDA, at every n (as the JAX
    ``mvn_loglike_best`` sends every float32 call on the TPU to its
    kernel); the batched library factorization elsewhere (CPU, float64).
    The choice is by dtype and device only: a kernel that fails to build or
    launch raises."""
    with span("hic.mvn"):
        if cov.is_cuda and cov.dtype == torch.float32:
            return mvn_loglike_fused(y, cov)
        return mvn_loglike_batch(y, cov)
