"""Fused GP PC-predict: hand-written CUDA kernels + their plain PyTorch versions.

The sampling hot path (every posterior value and every HMC gradient)
evaluates, per GP k of an emulator's batch and per walker batch::

    r2    = |(x_train - q) / ls|^2                     # (n, m)
    kstar = amp * exp(-0.5 * r2)                       # RBF
          = amp * (1 + s) * exp(-s), s = sqrt(3 r2)    # Matern-1.5
    mean  = kstar^T alpha                              # (m,)
    qform = |G kstar|^2,  G = L^-1                     # (m,)  -> var = kdiag - qform

The two families (``FusedState.kind``) differ in the k* pre-pass alone
(``kstar_kernel<0>`` / ``kstar_kernel<1>`` in the device trace) and in the
weight w of the query derivative dk*/dqs = w (xs - qs): w = k* for RBF,
w = 3 amp e^-s for Matern, which the Matern pre-pass writes beside k* when a
backward follows; the product kernels and both backwards are shared.

Kernels (``csrc/fused_predict.cu``, built by :mod:`._build`), each with its
precision contract and its bound on the H100 at the flagship shape
(b = 4, n = 1000, d = 17, m = 1024):

- ``fused_predict_fwd`` replaces ``gpbayestools_hic_tpu/ops/pallas_predict.py:
  _fwd_kernel``.  Value path, FP32-class accuracy for good (var = kdiag -
  qform cancels, so one TF32 or bf16 pass is not allowed): k* from direct
  FP32 differences, built once per call by a pre-pass that writes k*^T
  (split into its TF32 halves in shared memory as the product reads it);
  v = [G; alpha] k* on the tensor cores in 3xTF32 (hi*hi + hi*lo + lo*hi,
  each ring stage's products promoted to the FP32 sum), the mean from the
  alpha row, the masked quadratic form over the G rows, and v (with k*)
  saved for the backward when a gradient is needed.  Bound ~0.028 ms (the
  3xTF32 product at 495 TFLOP/s plus the k* build at 67 TFLOP/s FP32).
- ``fused_predict_bwd`` replaces ``pallas_predict.py:_bwd_kernel_fast``:
  ct_k* = 2 ct_qf G^T v + alpha ct_mean, ct_z = k* ct_k* where z < 0, and
  the query cotangent per GP.  ``grad_precision="default"`` selects it; its
  G^T v product runs in ONE TF32 pass on the tensor cores (both operands
  rounded to nearest; the TPU ran it in one bf16 pass), everything else in
  FP32, with the forward's k* instead of a recompute of z.  Bound ~0.015 ms.
- ``fused_predict_bwd_high`` replaces ``pallas_predict.py:_bwd_kernel``: the
  same cotangent at FP32-class accuracy, for good; ``grad_precision="high"``
  / ``"highest"`` select it.  G^T v in 3xTF32 (v^T split into TF32 halves
  in shared memory, G^T's halves from the kernel factor) with each ring
  stage's products promoted to the FP32 sum (the TPU kernel ran 3-pass
  bf16), the rest FP32 as in the fast backward, with the forward's k*.
  Bound ~0.031 ms.

All three are Hopper kernels: walkers on the M side of ``wgmma.mma_async``
TF32 products whose operands both come K-major from shared memory, a ring
of stages filled by TMA and tracked by mbarriers (one producer warpgroup,
one or two consumer warpgroups), and the light and heavy row tiles of the
triangular factor paired so that every block does the same work.  The
source's header says more.

Layouts.  The plain state is ``xs = x / ls`` (b, n, d), ``G`` (b, n, n),
``alpha`` (b, n), ``amp`` (b,), ``inv_ls`` (b, d) and ``kdiag`` (b,), all
float32, as the plain versions read them.  ``build_fused_state`` adds the
kernels' copy of the factor, ``kf`` (b, 4, n + 1, ld) (:func:`kernel_factor`):
[G; alpha] and G^T, each in TF32 halves, rows padded to
``ld = factor_ld(n)`` floats, the 16-byte stride TMA needs; its tensor-map
descriptor is encoded once and cached.  The forward kernel saves v as v^T
in plane 0 of a (1 + KST_PLANES, b, m, ld) buffer whose other planes hold
the call's k*^T (and, for Matern, w^T after them), and hands it out as the
(b, n, m) view ``buf[0, :, :, :n].mT``, which the plain backward reads as
it is and the kernels by its storage: both backwards take k* (Matern: w)
from there (:func:`kernel_layout_v` makes that layout from a plain v).

Dispatch: a CUDA tensor launches the kernel (or raises); a CPU tensor
takes the plain version.  There is no fallback from one to the other.
Each kernel wrapper counts its launches in :data:`.registry.LAUNCH_COUNTS`,
per family (the Matern entries' names end in ``_matern``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .kernels import scaled_sqdist
from ..utils.profiling import span
from .registry import count_launch, raise_on, register

_SOURCE = "gpbayestools_hic_tpu_torch/csrc/fused_predict.cu"
# the TPU kernels replaced: _fwd_kernel, _bwd_kernel_fast, _bwd_kernel
register("fused_predict_fwd", _SOURCE, "gpbayestools_hic_tpu/ops/pallas_predict.py:255")
register("fused_predict_bwd", _SOURCE, "gpbayestools_hic_tpu/ops/pallas_predict.py:307")
register("fused_predict_bwd_high", _SOURCE, "gpbayestools_hic_tpu/ops/pallas_predict.py:281")
# the same kernels with the Matern-1.5 k* pre-pass (the TPU kernels computed RBF only)
register("fused_predict_fwd_matern", _SOURCE, "gpbayestools_hic_tpu/ops/pallas_predict.py:255")
register("fused_predict_bwd_matern", _SOURCE, "gpbayestools_hic_tpu/ops/pallas_predict.py:307")
register("fused_predict_bwd_high_matern", _SOURCE,
         "gpbayestools_hic_tpu/ops/pallas_predict.py:281")

#: kernel families the kernels compute (``FusedState.kind``)
FUSED_KINDS = ("RBF", "Matern")

#: ``GPConfig.grad_precision`` -> backward kernel
BACKWARD_KERNELS = {
    "default": "fused_predict_bwd",
    "high": "fused_predict_bwd_high",
    "highest": "fused_predict_bwd_high",
}


def backward_kernel(grad_precision: str) -> str:
    """Name of the backward kernel that ``grad_precision`` selects."""
    try:
        return BACKWARD_KERNELS[grad_precision]
    except KeyError:
        raise ValueError(
            f"unknown grad_precision {grad_precision!r}: use 'default' (the "
            "fast backward) or 'high' / 'highest' (the FP32-class backward)"
        ) from None


def launch_name(entry: str, kind: str) -> str:
    """The name a kernel entry's launches are counted under for family
    ``kind``: the entry's own for RBF, with ``_matern`` for Matern."""
    return entry if kind == "RBF" else f"{entry}_matern"


class FusedState(NamedTuple):
    xs: torch.Tensor      # (b, n, d) training inputs scaled by 1/ls
    G: torch.Tensor       # (b, n, n) lower-triangular L^-1
    alpha: torch.Tensor   # (b, n) K^-1 y
    amp: torch.Tensor     # (b,)
    inv_ls: torch.Tensor  # (b, d)
    kdiag: torch.Tensor   # (b,) predictive prior variance amp + noise
    kf: torch.Tensor | None = None  # (b, 4, n + 1, ld) the kernels' factor (kernel_factor)
    kind: str = "RBF"     # kernel family, one of FUSED_KINDS


#: the tensor fields of a FusedState
TENSOR_FIELDS = FusedState._fields[:-1]


def state_as(fs: FusedState, dtype: torch.dtype) -> FusedState:
    """``fs`` with its tensors in ``dtype`` (a float64 copy for a
    reference), the family kept."""
    return fs._replace(**{f: getattr(fs, f).to(dtype) for f in TENSOR_FIELDS
                          if getattr(fs, f) is not None})


#: largest input dimension the kernels take (``DMAX`` of csrc/fused_predict.cu)
FUSED_MAX_DIM = 32
#: rows of a Hopper kernel's tile (``TN``)
TILE_ROWS = 128
#: planes of the kernel factor per GP (``FACTOR_PLANES``)
FACTOR_PLANES = 4
#: planes of the forward's k*^T buffer (``KST_PLANES``: k* split in shared memory)
KST_PLANES = 1


def factor_ld(n: int) -> int:
    """Row stride (floats) of the kernel factor and of the saved v^T: n
    rounded up to 4, the 16-byte stride TMA needs (``factor_ld``)."""
    return (n + 3) // 4 * 4


def tile_pairs(rows: int) -> int:
    """Blocks along the rows of a triangular product: row tiles of
    TILE_ROWS, paired light with heavy (``fwd_pairs`` for n + 1 rows,
    ``bwd_pairs`` for n)."""
    return (-(-rows // TILE_ROWS) + 1) // 2


def scratch_floats(entry: int, b: int, n: int, m: int, d: int) -> int:
    """Floats of scratch an entry takes, as ``fused_predict_scratch``
    counts them: the forward (0) the qf partial sums of its row-tile pairs,
    the backwards (1, 2) the query cotangent's partial sums."""
    if entry == 0:
        return b * tile_pairs(n + 1) * m
    return b * tile_pairs(n) * m * d


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 explicit mantissa bits), ties
    away from zero: the kernels' ``tf32_rna`` (what ``cvt.rna.tf32.f32``
    gives)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def kernel_factor(G: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """The kernels' copy of a float32 factor, (b, 4, n + 1, ld), zeros in
    the padding: plane 0 [G; alpha] rounded to TF32 (hi), plane 1 the rest
    rounded to TF32 (lo), the forward's 3xTF32 operand; plane 2 G^T rounded
    to TF32 (row n zero), the fast backward's operand and the hi half of
    the three-pass backward's, plane 3 its lo half.  Each plane is 4 (n +
    1) ld bytes per GP (4 MB at n = 1000)."""
    b, n = alpha.shape
    ga = torch.cat([G, alpha[:, None, :]], 1)
    hi = round_tf32(ga)
    gt = G.transpose(1, 2)
    gt_hi = round_tf32(gt)
    kf = torch.zeros((b, FACTOR_PLANES, n + 1, factor_ld(n)), dtype=torch.float32,
                     device=G.device)
    kf[:, 0, :, :n] = hi
    kf[:, 1, :, :n] = round_tf32(ga - hi)
    kf[:, 2, :n, :n] = gt_hi
    kf[:, 3, :n, :n] = round_tf32(gt - gt_hi)
    return kf


def saved_planes(kind: str) -> int:
    """Planes of the buffer the forward saves v in: v^T, the k*^T planes
    and, for Matern, the w^T planes."""
    return 1 + KST_PLANES * (2 if kind == "Matern" else 1)


def weight_plane(kind: str) -> int:
    """The plane of the saved buffer the backwards read ct_z's weight from:
    k*^T's for RBF, w^T's for Matern."""
    return 1 if kind == "RBF" else 1 + KST_PLANES


def saved_v_buffer(b: int, n: int, m: int, kind: str = "RBF", **opts) -> torch.Tensor:
    """The buffer the forward kernel saves v in: (saved_planes(kind), b, m,
    ld), v^T in plane 0 (zeros past n), the call's k*^T in the next
    KST_PLANES, for Matern its w^T in the last KST_PLANES."""
    return torch.empty((saved_planes(kind), b, m, factor_ld(n)), **opts)


def kernel_layout_v(fs: FusedState, xq: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A (b, n, m) v of queries xq in the layout the forward kernel saves
    it: the view ``buf[0, :, :, :n].mT`` of a :func:`saved_v_buffer` with
    zeros in the padding and k*^T of xq (plain) beside it (and w^T, for
    Matern)."""
    b, n, m = v.shape
    buf = saved_v_buffer(b, n, m, fs.kind, dtype=v.dtype, device=v.device).zero_()
    buf[0, :, :, :n] = v.transpose(1, 2)
    _, z, kstar = _kstar_plain(fs, xq)
    buf[1, :, :, :n] = kstar.transpose(1, 2)
    if fs.kind == "Matern":
        buf[weight_plane(fs.kind), :, :, :n] = _weight_plain(fs, z, kstar).transpose(1, 2)
    return buf[0, :, :, :n].transpose(1, 2)


def fused_eligible(kind: str, d: int, dtype: torch.dtype) -> bool:
    """The kernels compute the RBF and the Matern-1.5 families
    (:data:`FUSED_KINDS`) in float32 for d <= FUSED_MAX_DIM; a wider GP, and
    surmise's product-Matern ("MaternProd"), take the plain ``gp_predict``
    (as the JAX package's ``fused_eligible(kind, d, dtype)`` sends a GP
    off its kernel, which computed RBF alone)."""
    return kind in FUSED_KINDS and d <= FUSED_MAX_DIM and dtype == torch.float32


def build_fused_state(params: dict, x: torch.Tensor, linv: torch.Tensor,
                      alpha_vec: torch.Tensor, kind: str = "RBF") -> FusedState:
    """Kernel-ready float32 state from a trained GP batch (one-time prep) of
    family ``kind``.  A known per-design noise (a PCSK head's) is already in
    ``linv`` and ``alpha_vec``; ``kdiag`` is amp + the white level in
    either family."""
    if kind not in FUSED_KINDS:
        raise ValueError(f"the fused predict computes {FUSED_KINDS}, not {kind!r}")
    f32 = dict(dtype=torch.float32, device=x.device)
    ls = torch.exp(params["log_ls"].to(torch.float64))
    amp = torch.exp(params["log_amp"].to(torch.float64))
    noise = torch.exp(params["log_noise"].to(torch.float64))
    xs = x.to(torch.float64)[None, :, :] / ls[:, None, :]
    # the kernels skip the upper triangle; make that exact
    G = torch.tril(linv).to(**f32).contiguous()
    alpha = alpha_vec.to(**f32).contiguous()
    return FusedState(
        xs=xs.to(**f32).contiguous(),
        G=G,
        alpha=alpha,
        amp=amp.to(**f32).contiguous(),
        inv_ls=(1.0 / ls).to(**f32).contiguous(),
        kdiag=(amp + noise).to(**f32).contiguous(),
        kf=kernel_factor(G, alpha),
        kind=kind,
    )


# ------------------------------------------------------------ plain versions


def _kstar_plain(fs: FusedState, xq: torch.Tensor):
    """(qs (b, m, d), z = -r2 / 2 (b, n, m), k* (b, n, m)) in ``fs.kind``."""
    qs = xq[None, :, :] * fs.inv_ls[:, None, :]          # (b, m, d)
    z = -0.5 * scaled_sqdist(fs.xs, qs)                   # (b, n, m)
    if fs.kind == "Matern":
        s = torch.sqrt(-6.0 * z)                          # sqrt(3 r2)
        kstar = fs.amp[:, None, None] * (1.0 + s) * torch.exp(-s)
    else:
        kstar = fs.amp[:, None, None] * torch.exp(torch.clamp(z, max=0.0))
    return qs, z, kstar


def _weight_plain(fs: FusedState, z: torch.Tensor, kstar: torch.Tensor) -> torch.Tensor:
    """The weight w of dk*/dqs = w (xs - qs): k* where z < 0 for RBF, 3 amp
    e^-s for Matern (finite at r = 0)."""
    if fs.kind == "Matern":
        return 3.0 * fs.amp[:, None, None] * torch.exp(-torch.sqrt(-6.0 * z))
    return torch.where(z < 0, kstar, torch.zeros_like(kstar))


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
    if fs.kind == "Matern":
        ct_z = _weight_plain(fs, z, kstar) * ct_k
    else:
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
        lib.fused_predict_scratch.restype = ctypes.c_longlong
        lib.fused_predict_scratch.argtypes = [_I] * 5
        lib.fused_predict_max_dim.restype = _I
        lib.fused_predict_max_dim.argtypes = []
        lib.fused_predict_ld.restype = _I
        lib.fused_predict_ld.argtypes = [_I]
        lib.fused_predict_encode_factor.restype = _I
        lib.fused_predict_encode_factor.argtypes = [_P, _I, _I, _P]
        lib.fused_predict_kst_planes.restype = _I
        lib.fused_predict_kst_planes.argtypes = []
        lib.fused_predict_factor_planes.restype = _I
        lib.fused_predict_factor_planes.argtypes = []
        lib.fused_predict_fwd.restype = _I
        lib.fused_predict_fwd.argtypes = [_P] * 10 + [_I] * 4 + [_P]
        lib.fused_predict_fwd_matern.restype = _I
        lib.fused_predict_fwd_matern.argtypes = [_P] * 11 + [_I] * 4 + [_P]
        lib.fused_predict_bwd.restype = _I
        lib.fused_predict_bwd.argtypes = [_P] * 11 + [_I] * 4 + [_P]
        lib.fused_predict_bwd_high.restype = _I
        lib.fused_predict_bwd_high.argtypes = [_P] * 11 + [_I] * 4 + [_P]
        lib._gpbt_typed = True
    return lib


#: (device, kernel-factor address, b, n) -> its 128-byte tensor-map descriptor
_FACTOR_DESC: dict[tuple, ctypes.Array] = {}


def _factor_desc(lib, fs: FusedState):
    """The kernel factor's TMA descriptor, encoded at its first use and kept
    (a descriptor only holds the address, the shape and the tile box, so an
    address reused by an equal-shaped factor maps to an equal descriptor)."""
    b, n = fs.alpha.shape
    key = (fs.kf.device, fs.kf.data_ptr(), b, n)
    desc = _FACTOR_DESC.get(key)
    if desc is None:
        if len(_FACTOR_DESC) >= 4096:
            _FACTOR_DESC.clear()
        desc = ctypes.create_string_buffer(128)
        with torch.cuda.device(fs.kf.device):
            raise_on(lib.fused_predict_encode_factor(fs.kf.data_ptr(), b, n, desc),
                     "fused predict factor descriptor")
        _FACTOR_DESC[key] = desc
    return desc


def _check_cuda(fs: FusedState, xq: torch.Tensor, *extra: torch.Tensor):
    dev = xq.device
    if fs.kf is None:
        raise ValueError("fused predict kernels need the kernel factor: build the state "
                         "with build_fused_state")
    for t in (xq, *(getattr(fs, f) for f in TENSOR_FIELDS), *extra):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                "fused predict kernels take contiguous float32 tensors on one "
                f"CUDA device; got {t.dtype} on {t.device} "
                f"(contiguous={t.is_contiguous()})"
            )
    b, n, d = fs.xs.shape
    m = xq.shape[0]
    if (xq.shape != (m, d) or fs.G.shape != (b, n, n) or fs.alpha.shape != (b, n)
            or fs.kf.shape != (b, FACTOR_PLANES, n + 1, factor_ld(n))):
        raise ValueError(
            f"shape mismatch: xq {tuple(xq.shape)}, xs {tuple(fs.xs.shape)}, "
            f"G {tuple(fs.G.shape)}, alpha {tuple(fs.alpha.shape)}, kf {tuple(fs.kf.shape)}"
        )
    return b, n, m, d


def _fwd_cuda(fs: FusedState, xq: torch.Tensor, save_v: bool):
    b, n, m, d = _check_cuda(fs, xq)
    lib = _lib()
    if d > lib.fused_predict_max_dim():
        raise ValueError(f"fused predict supports d <= {lib.fused_predict_max_dim()}, got {d}")
    opts = dict(dtype=torch.float32, device=xq.device)
    mean = torch.empty((b, m), **opts)
    qf = torch.empty((b, m), **opts)
    # the per-block partial sums of qf
    scratch = torch.empty(lib.fused_predict_scratch(0, b, n, m, d), **opts)
    # v^T and k*^T (and Matern's w^T) side by side when a backward follows,
    # else k*^T alone
    matern = fs.kind == "Matern"
    wst = None
    if save_v:
        buf = saved_v_buffer(b, n, m, fs.kind, **opts)
        vt, kst = buf[0], buf[1:1 + KST_PLANES]
        if matern:
            wst = buf[weight_plane(fs.kind):]
    else:
        vt, kst = None, torch.empty((KST_PLANES, b, m, factor_ld(n)), **opts)
    desc = _factor_desc(lib, fs)
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    head = (fs.xs.data_ptr(), xq.data_ptr(), fs.inv_ls.data_ptr(), desc, fs.amp.data_ptr(),
            mean.data_ptr(), qf.data_ptr(), vt.data_ptr() if save_v else None, kst.data_ptr())
    tail = (scratch.data_ptr(), b, n, m, d, stream)
    with torch.cuda.device(xq.device):
        if matern:
            err = lib.fused_predict_fwd_matern(
                *head, wst.data_ptr() if wst is not None else None, *tail)
        else:
            err = lib.fused_predict_fwd(*head, *tail)
    name = launch_name("fused_predict_fwd", fs.kind)
    raise_on(err, f"{name} launch")
    count_launch(name, xq.device)
    return mean, qf, (vt[:, :, :n].transpose(1, 2) if save_v else None)


def _check_v(v: torch.Tensor, b: int, n: int, m: int, kernel: str, kind: str = "RBF"):
    """v must be a forward kernel's saved v (see saved_v_buffer)."""
    ld = factor_ld(n)
    planes = saved_planes(kind)
    if (v.shape != (b, n, m) or v.stride() != (m * ld, 1, ld) or v.storage_offset() != 0
            or v.data_ptr() % 16
            or v.untyped_storage().nbytes() < planes * b * m * ld * 4):
        raise ValueError(
            f"{kernel}: v must be the forward kernel's saved v, the (b, n, m) view of plane 0 "
            f"of a ({planes}, b, m, {ld}) buffer (kernel_layout_v makes one); got "
            f"shape {tuple(v.shape)}, strides {v.stride()}"
        )


def _bwd_cuda(fs: FusedState, xq: torch.Tensor, v: torch.Tensor,
              ct_mean: torch.Tensor, ct_qf: torch.Tensor, kernel: str) -> torch.Tensor:
    b, n, m, d = _check_cuda(fs, xq, ct_mean, ct_qf)
    if v.device != xq.device or v.dtype != torch.float32:
        raise ValueError(f"{kernel}: v must be float32 on {xq.device}")
    _check_v(v, b, n, m, kernel, fs.kind)
    if ct_mean.shape != (b, m) or ct_qf.shape != (b, m):
        raise ValueError(f"{kernel}: cotangent shape mismatch")
    lib = _lib()
    opts = dict(dtype=torch.float32, device=xq.device)
    fast = kernel == "fused_predict_bwd"
    # per-block partial sums of the query cotangent
    ct_part = torch.empty(lib.fused_predict_scratch(1 if fast else 2, b, n, m, d), **opts)
    ct_q = torch.empty((b, m, d), **opts)
    # G^T's halves from the kernel factor, k* (Matern: w) from the saved v's
    # buffer
    operands = (_factor_desc(lib, fs), fs.alpha.data_ptr(), v.data_ptr(),
                v.data_ptr() + 4 * b * m * factor_ld(n) * weight_plane(fs.kind))
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    with torch.cuda.device(xq.device):
        err = getattr(lib, kernel)(
            fs.xs.data_ptr(), xq.data_ptr(), fs.inv_ls.data_ptr(), *operands,
            ct_mean.data_ptr(), ct_qf.data_ptr(), ct_part.data_ptr(), ct_q.data_ptr(),
            b, n, m, d, stream,
        )
    name = launch_name(kernel, fs.kind)
    raise_on(err, f"{name} launch")
    count_launch(name, xq.device)
    return ct_q


def fused_fwd(fs: FusedState, xq: torch.Tensor, save_v: bool = False):
    """Forward: kernel on a CUDA tensor, plain version on a CPU tensor."""
    if xq.is_cuda:
        return _fwd_cuda(fs, xq, save_v)
    return fused_fwd_plain(fs, xq, save_v)


def fused_bwd(fs: FusedState, xq: torch.Tensor, v: torch.Tensor,
              ct_mean: torch.Tensor, ct_qf: torch.Tensor,
              grad_precision: str = "default") -> torch.Tensor:
    """Backward (per-GP query cotangent, (b, m, d)): on CUDA the kernel that
    ``grad_precision`` selects, on CPU the plain version (which is full
    precision whatever the setting)."""
    kernel = backward_kernel(grad_precision)
    if xq.is_cuda:
        return _bwd_cuda(fs, xq, v, ct_mean, ct_qf, kernel)
    return fused_bwd_plain(fs, xq, v, ct_mean, ct_qf)


class _FusedPCPredict(torch.autograd.Function):
    """Forward = the forward kernel with v saved when a gradient is needed;
    backward = the backward kernel that ``grad_precision`` selects.  Only
    the queries get a gradient: the GP state gets None, as the JAX op gives
    it zero cotangents.  Reverse mode only."""

    @staticmethod
    def forward(ctx, xq, grad_precision, xs, G, alpha, amp, inv_ls, kdiag, kf, kind):
        fs = FusedState(xs, G, alpha, amp, inv_ls, kdiag, kf, kind)
        need_grad = ctx.needs_input_grad[0]
        ctx.grad_precision = grad_precision
        ctx.kind = kind
        mean, qf, v = fused_fwd(fs, xq, save_v=need_grad)
        if need_grad:
            ctx.save_for_backward(xq, xs, G, alpha, amp, inv_ls, kdiag, kf, v)
        return mean.t(), qf.t()

    @staticmethod
    def backward(ctx, ct_mean, ct_qf):
        with span("hic.predict_bwd"):
            xq, xs, G, alpha, amp, inv_ls, kdiag, kf, v = ctx.saved_tensors
            fs = FusedState(xs, G, alpha, amp, inv_ls, kdiag, kf, ctx.kind)
            if ct_mean is None:
                ct_mean = torch.zeros((xq.shape[0], xs.shape[0]), dtype=xq.dtype,
                                      device=xq.device)
            if ct_qf is None:
                ct_qf = torch.zeros_like(ct_mean)
            ct_q = fused_bwd(fs, xq, v, ct_mean.t().contiguous(), ct_qf.t().contiguous(),
                             ctx.grad_precision)
            return (ct_q.sum(0),) + (None,) * 9


def fused_pc_predict(fs: FusedState, xq: torch.Tensor, grad_precision: str = "default"):
    """Fused GP-batch predict: (m, d) queries -> (mean (m, b), qform (m, b)).

    ``var = max(kdiag - qform, 0)`` is left to the caller.  Reverse-mode
    differentiable w.r.t. ``xq`` only; ``grad_precision`` picks the
    backward kernel (values are the same either way).
    """
    backward_kernel(grad_precision)  # an unknown value raises here, not in backward
    return _FusedPCPredict.apply(xq.contiguous(), grad_precision, *fs)
