"""Fused Woodbury epilogue: hand-written CUDA kernels + plain version.

The ``"auto"`` posterior's PC-space likelihood (``samplers/chain.py``,
:func:`..samplers.chain.make_lowrank_block`) evaluates, per PCA emulator
block b with k PCs and per walker::

    v  = max(kdiag - qf, 0)   (the fused predict's variance), or v given
    d  = gp_mean - p0
    B  = M^-1 + diag(v)                       (k x k, SPD)
    lp = -1/2 (d^T B^-1 d + const2) - 1/2 (logdet_c0_m + log det B)

with ``-inf`` where B is not positive definite or lp is not finite.  Its
gradient has a closed form: with alpha = B^-1 d and g the cotangent of lp,
``d lp / d gp_mean = -g alpha`` and ``d lp / d v_i = g/2 (alpha_i^2 -
(B^-1)_ii)``; zero, never NaN, where lp was ``-inf``.

Kernels (``csrc/fused_woodbury.cu``, built by :mod:`._build`): they replace
no Pallas kernel; the JAX package unrolls the factor in jnp
(``gpbayestools_hic_tpu/ops/linalg.py:spd_qform_logdet``).  One launch of
``woodbury_fwd_kernel`` covers every block of a posterior call (a thread
per matrix to k = 8, a warp to k = 32, a CTA to k = 128) and saves alpha
and diag(B^-1) when a gradient follows; one launch of the elementwise
``woodbury_bwd_kernel`` is the backward.  The kernels read each block's
``gp_mean`` and ``qf`` (or ``v``) where the predict left them, through a
table of pointers and strides passed by value.

Dispatch (:func:`takes_kernel`): a float32 CUDA call whose every k is at
most :data:`MAX_K` launches the kernels, or raises; there is no fallback.
Every other call (CPU, float64, k past :data:`MAX_K`) is the caller's
library form (``samplers/chain.py``).  :func:`woodbury_plain` and
:func:`woodbury_grad_plain` write the closed form out in plain torch: the
tests' oracle and ``chip_smoke.py``'s comparison.

``bs`` below is a block's state as ``make_lowrank_block`` builds it:
``p0`` (k,), ``m_inv`` (k, k), ``const2`` and ``logdet_c0_m`` (scalars).
"""

from __future__ import annotations

import ctypes

import torch

from .registry import count_launch, raise_on, register

_SOURCE = "gpbayestools_hic_tpu_torch/csrc/fused_woodbury.cu"
# replaces no Pallas kernel: the JAX package's unrolled jnp factor
_REPLACES = "none (gpbayestools_hic_tpu/ops/linalg.py:145 spd_qform_logdet, jnp)"
register("fused_woodbury_fwd", _SOURCE, _REPLACES)
register("fused_woodbury_bwd", _SOURCE, _REPLACES)

# Mirrors of csrc/fused_woodbury.cu's limits, by which the wrapper routes and
# chunks a call (the card tests hold them against the built library).
MAX_K = 128          # largest k the kernels take
MAX_BLOCKS = 32      # blocks one launch takes; more go in chunks


def takes_kernel(device: torch.device, dtype: torch.dtype, ks) -> bool:
    """Whether a call over blocks of ``ks`` PCs, with its tensors of
    ``dtype`` on ``device``, runs the kernels."""
    return device.type == "cuda" and dtype == torch.float32 and max(ks) <= MAX_K


# ------------------------------------------------------------- plain version


def woodbury_plain(bs: dict, mean: torch.Tensor, var: torch.Tensor,
                   kdiag: torch.Tensor | None = None):
    """One block's ``(lp (m,), alpha (m, k), diag(B^-1) (m, k))``, the
    kernel's closed form in batched torch ops, any dtype.  ``var`` is v, or
    qf where ``kdiag`` is given.  alpha and the diagonal are 0 where B is
    not positive definite."""
    v = var if kdiag is None else torch.clamp(kdiag[None, :] - var, min=0.0)
    b = bs["m_inv"] + torch.diag_embed(v)
    chol, info = torch.linalg.cholesky_ex(b)
    ok = info == 0
    eye = torch.eye(b.shape[-1], dtype=b.dtype, device=b.device)
    chol = torch.where(ok[:, None, None], chol, eye)
    d = mean - bs["p0"]
    z = torch.linalg.solve_triangular(chol, d.unsqueeze(-1), upper=False)
    linv = torch.linalg.solve_triangular(chol, eye.expand_as(chol), upper=False)
    alpha = (linv.transpose(1, 2) @ z).squeeze(-1)
    dinv = (linv * linv).sum(1)
    quad = (z.squeeze(-1) ** 2).sum(-1)
    logdet_b = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    lp = -0.5 * (quad + bs["const2"]) - 0.5 * (bs["logdet_c0_m"] + logdet_b)
    lp = torch.where(ok & torch.isfinite(lp), lp, torch.full_like(lp, -torch.inf))
    zero = torch.zeros_like(alpha)
    return lp, torch.where(ok[:, None], alpha, zero), torch.where(ok[:, None], dinv, zero)


def woodbury_grad_plain(g: torch.Tensor, lp: torch.Tensor, alpha: torch.Tensor,
                        dinv: torch.Tensor, var: torch.Tensor,
                        kdiag: torch.Tensor | None = None):
    """One block's backward, the closed form: the cotangent ``g`` (m,) of
    its lp -> ``(d/d gp_mean, d/d var)``, each (m, k); zero where lp or g
    is not finite."""
    ok = (torch.isfinite(lp) & torch.isfinite(g))[:, None]
    zero = torch.zeros_like(alpha)
    gm = torch.where(ok, -g[:, None] * alpha, zero)
    gv = torch.where(ok, 0.5 * g[:, None] * (alpha * alpha - dinv), zero)
    if kdiag is not None:
        gv = torch.where(kdiag[None, :] - var >= 0, -gv, zero)
    return gm, gv


# -------------------------------------------------------------- CUDA wrapper

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


class BlockArg(ctypes.Structure):
    """One block of the kernels' table (``BlockArg`` in the source)."""
    _fields_ = [("mean", _P), ("var", _P), ("kdiag", _P), ("p0", _P), ("minv", _P),
                ("const2", _P), ("logdet", _P), ("mean_sw", _LL), ("mean_sk", _LL),
                ("var_sw", _LL), ("var_sk", _LL), ("k", _I), ("unused", _I)]


def _lib():
    from ._build import load

    lib = load("fused_woodbury")
    if not getattr(lib, "_gpbt_typed", False):
        for name in ("fused_woodbury_max_k", "fused_woodbury_max_blocks",
                     "fused_woodbury_arg_bytes"):
            getattr(lib, name).restype = _I
            getattr(lib, name).argtypes = []
        table = ctypes.POINTER(BlockArg)
        lib.fused_woodbury_fwd.restype = _I
        lib.fused_woodbury_fwd.argtypes = [table] + [_I] * 5 + [_P] * 4
        lib.fused_woodbury_bwd.restype = _I
        lib.fused_woodbury_bwd.argtypes = ([table] + [_I] * 5 + [_P] * 2 + [_LL] * 2
                                           + [_P] * 5)
        lib._gpbt_typed = True
    return lib


def built_limits() -> dict[str, int]:
    """The built library's limits and the size of its table entry (needs a
    CUDA machine)."""
    lib = _lib()
    return {"max_k": lib.fused_woodbury_max_k(), "max_blocks": lib.fused_woodbury_max_blocks(),
            "arg_bytes": lib.fused_woodbury_arg_bytes()}


def _table(states, means, vars_, kdiags) -> tuple[list[BlockArg], int]:
    """The kernels' table of blocks, every tensor checked; and m."""
    dev, m = means[0].device, means[0].shape[0]
    args = []
    for bs, mean, var, kd in zip(states, means, vars_, kdiags):
        k = mean.shape[-1]
        checks = [("gp_mean", mean, (m, k)), ("var", var, (m, k)), ("p0", bs["p0"], (k,)),
                  ("m_inv", bs["m_inv"], (k, k)), ("const2", bs["const2"], ()),
                  ("logdet_c0_m", bs["logdet_c0_m"], ())]
        if kd is not None:
            checks.append(("kdiag", kd, (k,)))
        for name, t, shape in checks:
            if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape:
                raise ValueError(
                    f"the fused Woodbury kernels take float32 tensors on one CUDA device: "
                    f"{name} {tuple(t.shape)} {t.dtype} on {t.device}, expected {shape}")
            if name not in ("gp_mean", "var") and not t.is_contiguous():
                raise ValueError(f"the fused Woodbury kernels take a contiguous {name}")
        if not 1 <= k <= MAX_K:
            raise ValueError(f"the fused Woodbury kernels take 1 <= k <= {MAX_K}, got {k}")
        args.append(BlockArg(
            mean.data_ptr(), var.data_ptr(), kd.data_ptr() if kd is not None else None,
            bs["p0"].data_ptr(), bs["m_inv"].data_ptr(), bs["const2"].data_ptr(),
            bs["logdet_c0_m"].data_ptr(), *mean.stride(), *var.stride(), k, 0))
    return args, m


def _chunks(args):
    """(first block, row offset, the chunk's table) per launch."""
    off = 0
    for c0 in range(0, len(args), MAX_BLOCKS):
        chunk = args[c0:c0 + MAX_BLOCKS]
        yield c0, off, (BlockArg * len(chunk))(*chunk)
        off += sum(a.k for a in chunk)


def _fwd_cuda(states, kdiags, means, vars_, grad: bool):
    """lp (m, nb), and with ``grad`` the saved (2, sum k, m): alpha, diag(B^-1)."""
    args, m = _table(states, means, vars_, kdiags)
    nb, dev = len(args), means[0].device
    opts = dict(dtype=torch.float32, device=dev)
    lp = torch.empty((m, nb), **opts)
    saved = torch.empty((2, sum(a.k for a in args), m), **opts) if grad else None
    ptrs = (saved[0].data_ptr(), saved[1].data_ptr()) if grad else (None, None)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        for c0, off, table in _chunks(args):
            err = lib.fused_woodbury_fwd(table, len(table), c0, nb, off, m, lp.data_ptr(),
                                         *ptrs, stream)
            raise_on(err, "fused_woodbury_fwd launch")
            count_launch("fused_woodbury_fwd", dev)
    return lp, saved


def _bwd_cuda(states, kdiags, vars_, lp, g, saved):
    """Per block ``(d/d gp_mean, d/d var)`` views (m, k) of one (2, sum k, m)
    buffer, so each block's cotangent lies as its predict's outputs do."""
    args, m = _table(states, vars_, vars_, kdiags)  # the backward reads no gp_mean
    nb, dev = len(args), lp.device
    if g.dtype != torch.float32 or g.device != dev or tuple(g.shape) != (m, nb):
        raise ValueError(f"fused Woodbury backward: cotangent {tuple(g.shape)} {g.dtype}")
    out = torch.empty_like(saved)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        for c0, off, table in _chunks(args):
            err = lib.fused_woodbury_bwd(
                table, len(table), c0, nb, off, m, lp.data_ptr(), g.data_ptr(), *g.stride(),
                saved[0].data_ptr(), saved[1].data_ptr(), out[0].data_ptr(),
                out[1].data_ptr(), stream)
            raise_on(err, "fused_woodbury_bwd launch")
            count_launch("fused_woodbury_bwd", dev)
    gmean, gvar, r0 = [], [], 0
    for a in args:
        gmean.append(out[0, r0:r0 + a.k].t())
        gvar.append(out[1, r0:r0 + a.k].t())
        r0 += a.k
    return gmean, gvar


class _Woodbury(torch.autograd.Function):
    """Forward = ``woodbury_fwd_kernel`` over every block, saving alpha and
    diag(B^-1) when a gradient is recorded; backward = ``woodbury_bwd_kernel``.
    Only ``gp_mean`` and ``var`` get gradients (the state is constant)."""

    @staticmethod
    def forward(ctx, states, kdiags, *tensors):
        nb = len(states)
        means, vars_ = tensors[:nb], tensors[nb:]
        grad = any(ctx.needs_input_grad[2:])
        lp, saved = _fwd_cuda(states, kdiags, means, vars_, grad)
        if grad:
            ctx.states, ctx.kdiags = states, kdiags
            ctx.save_for_backward(lp, saved, *vars_)
        return lp

    @staticmethod
    def backward(ctx, g):
        lp, saved, *vars_ = ctx.saved_tensors
        gmean, gvar = _bwd_cuda(ctx.states, ctx.kdiags, vars_, lp, g, saved)
        return (None, None, *gmean, *gvar)


def fused_woodbury(states, means, vars_, kdiags) -> torch.Tensor:
    """Every block's lp, (m, nb), through the kernels; differentiable in
    ``means`` and ``vars_``.  ``states`` are the blocks' ``bs``, ``vars_``
    each block's v, or its qf where its entry of ``kdiags`` is the prior
    variance (else None)."""
    means, vars_ = tuple(means), tuple(vars_)
    if not takes_kernel(means[0].device, means[0].dtype, [t.shape[-1] for t in means]):
        raise ValueError("the fused Woodbury kernels take float32 CUDA tensors with k <= "
                         f"{MAX_K}; got {means[0].dtype} on {means[0].device}")
    return _Woodbury.apply(tuple(states), tuple(kdiags), *means, *vars_)
