"""Device, dtype and numeric policy of the PyTorch port.

- Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
  with no GPU and no explicit CPU request :func:`resolve_device` raises
  instead of silently computing on the host.
- Working dtype: float32 (the CUDA fast path).  float64 is available on
  request (``dtype=torch.float64``), which the CPU parity tests use.
- TF32 is switched off for both matmuls and cuDNN: the counterpart of the
  JAX package's ``jax_default_matmul_precision=highest``.  GP covariance
  algebra at three decimal digits turns valid likelihoods into -inf.
- Cholesky jitter scales with dtype (same constants as the JAX package).
"""

from __future__ import annotations

import torch

#: Multiplied onto the mean diagonal magnitude when a Cholesky needs rescuing.
CHOL_JITTER_F32 = 1e-6
CHOL_JITTER_F64 = 1e-12


def disable_tf32() -> None:
    """Keep float32 products in full float32 (no TF32 tensor-core path)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA; raise when CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the host"
        )
    return dev


def resolve_dtype(dtype=None) -> torch.dtype:
    """``None`` means float32; only float32 and float64 are supported."""
    dt = torch.float32 if dtype is None else dtype
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be float32 or float64, got {dt}")
    return dt


def chol_jitter(dtype) -> float:
    return CHOL_JITTER_F64 if dtype == torch.float64 else CHOL_JITTER_F32


def new_generator(device: torch.device, seed: int) -> torch.Generator:
    """Explicitly seeded generator on ``device`` (the port uses no global RNG)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen
