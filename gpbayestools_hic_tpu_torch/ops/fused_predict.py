"""Fused GP PC-predict: hand-written CUDA kernels + their plain PyTorch versions.

The sampling hot path (every posterior value and every HMC gradient)
evaluates, per GP k of an emulator's batch and per walker batch::

    kstar = amp * exp(-0.5 * |(x_train - q) / ls|^2)   # (n, m)
    mean  = kstar^T alpha                              # (m,)
    qform = |G kstar|^2,  G = L^-1                     # (m,)  -> var = kdiag - qform

Kernels (``csrc/fused_predict.cu``, built by :mod:`._build`):

- ``fused_predict_fwd`` replaces ``gpbayestools_hic_tpu/ops/pallas_predict.py:
  _fwd_kernel``: k* from direct FP32 differences, v = G k* and the mean in
  one contraction (alpha as row n), the masked quadratic form, and v saved
  for the backward when a gradient is needed.
- ``fused_predict_bwd`` replaces ``pallas_predict.py:_bwd_kernel_fast``:
  ct_k* = G^T (2 v ct_qf) + alpha ct_mean, ct_z = k* ct_k* where z < 0, and
  the query cotangent per GP, all in FP32.

What bounds them on the H100: both are length-n contractions over the
(n, n) factor -- 2 n^2 m flops per GP against 4 n^2 bytes of G -- so at the
flagship shape (n = 1000, m = 1024) they are bound by FP32 operations
(~500 flop/byte, far above the card's ~20 flop/byte FP32 ridge).  The
design keeps k* out of device memory (each block recomputes its k* chunk
from xs and the query tile), skips the zero upper triangle of G (about half
the product), and accumulates 4x4 outputs per thread in registers from
shared-memory tiles.  Tensor cores (3xTF32 / wgmma) are later work.

The port keeps none of the TPU layout (no bf16 hi/lo splits, no feature
padding to 128, no 1e30 padding rows): the fused state is plain
``xs = x / ls`` (b, n, d), ``G`` (b, n, n), ``alpha`` (b, n), ``amp`` (b,),
``inv_ls`` (b, d) and ``kdiag`` (b,), all float32.

Dispatch: a CUDA tensor launches the kernel (or raises); a CPU tensor
takes the plain version.  There is no fallback from one to the other.
Each kernel wrapper counts its launches in :data:`LAUNCH_COUNTS`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .kernels import scaled_sqdist

#: launches per kernel wrapper (incremented where the kernel is launched)
LAUNCH_COUNTS = {"fused_predict_fwd": 0, "fused_predict_bwd": 0}

#: kernel -> (kernel source, file:line of the TPU kernel it replaces:
#: _fwd_kernel and _bwd_kernel_fast)
KERNELS = {
    "fused_predict_fwd": (
        "gpbayestools_hic_tpu_torch/csrc/fused_predict.cu",
        "gpbayestools_hic_tpu/ops/pallas_predict.py:255",
    ),
    "fused_predict_bwd": (
        "gpbayestools_hic_tpu_torch/csrc/fused_predict.cu",
        "gpbayestools_hic_tpu/ops/pallas_predict.py:307",
    ),
}


def reset_launch_counts() -> None:
    for k in LAUNCH_COUNTS:
        LAUNCH_COUNTS[k] = 0


class FusedState(NamedTuple):
    xs: torch.Tensor      # (b, n, d) training inputs scaled by 1/ls
    G: torch.Tensor       # (b, n, n) lower-triangular L^-1
    alpha: torch.Tensor   # (b, n) K^-1 y
    amp: torch.Tensor     # (b,)
    inv_ls: torch.Tensor  # (b, d)
    kdiag: torch.Tensor   # (b,) predictive prior variance amp + noise


def fused_eligible(kind: str, dtype: torch.dtype) -> bool:
    """The kernels compute the RBF family in float32."""
    return kind == "RBF" and dtype == torch.float32


def build_fused_state(params: dict, x: torch.Tensor, linv: torch.Tensor,
                      alpha_vec: torch.Tensor) -> FusedState:
    """Kernel-ready float32 state from a trained GP batch (one-time prep)."""
    f32 = dict(dtype=torch.float32, device=x.device)
    ls = torch.exp(params["log_ls"].to(torch.float64))
    amp = torch.exp(params["log_amp"].to(torch.float64))
    noise = torch.exp(params["log_noise"].to(torch.float64))
    xs = x.to(torch.float64)[None, :, :] / ls[:, None, :]
    return FusedState(
        xs=xs.to(**f32).contiguous(),
        # the kernels skip the upper triangle; make that exact
        G=torch.tril(linv).to(**f32).contiguous(),
        alpha=alpha_vec.to(**f32).contiguous(),
        amp=amp.to(**f32).contiguous(),
        inv_ls=(1.0 / ls).to(**f32).contiguous(),
        kdiag=(amp + noise).to(**f32).contiguous(),
    )


# ------------------------------------------------------------ plain versions


def _kstar_plain(fs: FusedState, xq: torch.Tensor):
    qs = xq[None, :, :] * fs.inv_ls[:, None, :]          # (b, m, d)
    z = -0.5 * scaled_sqdist(fs.xs, qs)                   # (b, n, m)
    kstar = fs.amp[:, None, None] * torch.exp(torch.clamp(z, max=0.0))
    return qs, z, kstar


def fused_fwd_plain(fs: FusedState, xq: torch.Tensor, save_v: bool = False):
    """Plain PyTorch forward: (mean (b, m), qf (b, m), v (b, n, m) or None)."""
    _, _, kstar = _kstar_plain(fs, xq)
    v = torch.bmm(fs.G, kstar)
    mean = torch.einsum("bn,bnm->bm", fs.alpha, kstar)
    qf = (v * v).sum(1)
    return mean, qf, (v if save_v else None)


def fused_bwd_plain(fs: FusedState, xq: torch.Tensor, v: torch.Tensor,
                    ct_mean: torch.Tensor, ct_qf: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch backward: query cotangent per GP, (b, m, d)."""
    qs, z, kstar = _kstar_plain(fs, xq)
    ct_v = 2.0 * v * ct_qf[:, None, :]
    ct_k = torch.bmm(fs.G.transpose(1, 2), ct_v) + fs.alpha[:, :, None] * ct_mean[:, None, :]
    ct_z = torch.where(z < 0, kstar * ct_k, torch.zeros_like(kstar))
    ct_qs = torch.stack(
        [(ct_z * (fs.xs[:, :, j, None] - qs[:, None, :, j])).sum(1)
         for j in range(qs.shape[-1])],
        dim=-1,
    )
    return ct_qs * fs.inv_ls[:, None, :]


# ------------------------------------------------------------ CUDA wrappers

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    from ._build import load

    lib = load("fused_predict")
    if not getattr(lib, "_gpbt_typed", False):
        lib.fused_predict_row_block.restype = _I
        lib.fused_predict_row_block.argtypes = []
        lib.fused_predict_max_dim.restype = _I
        lib.fused_predict_max_dim.argtypes = []
        lib.fused_predict_fwd.restype = _I
        lib.fused_predict_fwd.argtypes = [_P] * 10 + [_I] * 4 + [_P]
        lib.fused_predict_bwd.restype = _I
        lib.fused_predict_bwd.argtypes = [_P] * 11 + [_I] * 4 + [_P]
        lib._gpbt_typed = True
    return lib


def _check_cuda(fs: FusedState, xq: torch.Tensor, *extra: torch.Tensor):
    dev = xq.device
    for t in (xq, *fs, *extra):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                "fused predict kernels take contiguous float32 tensors on one "
                f"CUDA device; got {t.dtype} on {t.device} "
                f"(contiguous={t.is_contiguous()})"
            )
    b, n, d = fs.xs.shape
    m = xq.shape[0]
    if xq.shape != (m, d) or fs.G.shape != (b, n, n) or fs.alpha.shape != (b, n):
        raise ValueError(
            f"shape mismatch: xq {tuple(xq.shape)}, xs {tuple(fs.xs.shape)}, "
            f"G {tuple(fs.G.shape)}, alpha {tuple(fs.alpha.shape)}"
        )
    return b, n, m, d


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def _fwd_cuda(fs: FusedState, xq: torch.Tensor, save_v: bool):
    b, n, m, d = _check_cuda(fs, xq)
    lib = _lib()
    if d > lib.fused_predict_max_dim():
        raise ValueError(f"fused predict supports d <= {lib.fused_predict_max_dim()}, got {d}")
    bi = lib.fused_predict_row_block()
    nrb = (n + 1 + bi - 1) // bi
    opts = dict(dtype=torch.float32, device=xq.device)
    mean = torch.empty((b, m), **opts)
    qf = torch.empty((b, m), **opts)
    qf_part = torch.empty((b, nrb, m), **opts)
    v = torch.empty((b, n, m), **opts) if save_v else None
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    with torch.cuda.device(xq.device):
        err = lib.fused_predict_fwd(
            fs.xs.data_ptr(), xq.data_ptr(), fs.inv_ls.data_ptr(),
            fs.G.data_ptr(), fs.alpha.data_ptr(), fs.amp.data_ptr(),
            mean.data_ptr(), qf_part.data_ptr(), qf.data_ptr(),
            v.data_ptr() if save_v else None, b, n, m, d, stream,
        )
    _raise_on(err, "fused_predict_fwd launch")
    LAUNCH_COUNTS["fused_predict_fwd"] += 1
    return mean, qf, v


def _bwd_cuda(fs: FusedState, xq: torch.Tensor, v: torch.Tensor,
              ct_mean: torch.Tensor, ct_qf: torch.Tensor) -> torch.Tensor:
    b, n, m, d = _check_cuda(fs, xq, v, ct_mean, ct_qf)
    if v.shape != (b, n, m) or ct_mean.shape != (b, m) or ct_qf.shape != (b, m):
        raise ValueError("fused_predict_bwd: v / cotangent shape mismatch")
    lib = _lib()
    bi = lib.fused_predict_row_block()
    nlb = (n + bi - 1) // bi
    opts = dict(dtype=torch.float32, device=xq.device)
    ct_part = torch.empty((b, nlb, m, d), **opts)
    ct_q = torch.empty((b, m, d), **opts)
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    with torch.cuda.device(xq.device):
        err = lib.fused_predict_bwd(
            fs.xs.data_ptr(), xq.data_ptr(), fs.inv_ls.data_ptr(),
            fs.G.data_ptr(), fs.alpha.data_ptr(), fs.amp.data_ptr(),
            v.data_ptr(), ct_mean.data_ptr(), ct_qf.data_ptr(),
            ct_part.data_ptr(), ct_q.data_ptr(), b, n, m, d, stream,
        )
    _raise_on(err, "fused_predict_bwd launch")
    LAUNCH_COUNTS["fused_predict_bwd"] += 1
    return ct_q


def fused_fwd(fs: FusedState, xq: torch.Tensor, save_v: bool = False):
    """Forward: kernel on a CUDA tensor, plain version on a CPU tensor."""
    if xq.is_cuda:
        return _fwd_cuda(fs, xq, save_v)
    return fused_fwd_plain(fs, xq, save_v)


def fused_bwd(fs: FusedState, xq: torch.Tensor, v: torch.Tensor,
              ct_mean: torch.Tensor, ct_qf: torch.Tensor) -> torch.Tensor:
    """Backward (per-GP query cotangent, (b, m, d)): kernel on CUDA, plain on CPU."""
    if xq.is_cuda:
        return _bwd_cuda(fs, xq, v, ct_mean, ct_qf)
    return fused_bwd_plain(fs, xq, v, ct_mean, ct_qf)


class _FusedPCPredict(torch.autograd.Function):
    """Forward = kernel 1 with v saved when a gradient is needed; backward =
    kernel 2.  Only the queries get a gradient: the GP state gets None, as
    the JAX op gives it zero cotangents.  Reverse mode only."""

    @staticmethod
    def forward(ctx, xq, xs, G, alpha, amp, inv_ls, kdiag):
        fs = FusedState(xs, G, alpha, amp, inv_ls, kdiag)
        need_grad = ctx.needs_input_grad[0]
        mean, qf, v = fused_fwd(fs, xq, save_v=need_grad)
        if need_grad:
            ctx.save_for_backward(xq, xs, G, alpha, amp, inv_ls, kdiag, v)
        return mean.t(), qf.t()

    @staticmethod
    def backward(ctx, ct_mean, ct_qf):
        xq, xs, G, alpha, amp, inv_ls, kdiag, v = ctx.saved_tensors
        fs = FusedState(xs, G, alpha, amp, inv_ls, kdiag)
        if ct_mean is None:
            ct_mean = torch.zeros((xq.shape[0], xs.shape[0]), dtype=xq.dtype, device=xq.device)
        if ct_qf is None:
            ct_qf = torch.zeros_like(ct_mean)
        ct_q = fused_bwd(fs, xq, v, ct_mean.t().contiguous(), ct_qf.t().contiguous())
        return (ct_q.sum(0),) + (None,) * 6


def fused_pc_predict(fs: FusedState, xq: torch.Tensor):
    """Fused GP-batch predict: (m, d) queries -> (mean (m, b), qform (m, b)).

    ``var = max(kdiag - qform, 0)`` is left to the caller.  Reverse-mode
    differentiable w.r.t. ``xq`` only.
    """
    return _FusedPCPredict.apply(xq.contiguous(), *fs)
