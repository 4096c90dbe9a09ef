"""GPBayesTools-HIC, PyTorch/CUDA port.

A second package beside the JAX reference ``gpbayestools_hic_tpu``: the
same emulators, calibration posterior and samplers in PyTorch, with the
JAX package's Pallas TPU kernels rewritten by hand in CUDA C++ for Hopper
(``csrc/``).  It never imports JAX or the JAX package.

Layering (mirrors the JAX package):
  ops/       -- kernels, linalg, scalers/PCA, the fused GP-predict kernels
  models/    -- batched GP, Emulator
  samplers/  -- Chain (calibration posterior), HMC
  utils/     -- IO contracts, convergence metrics, synthetic problems,
                the float64 posterior oracle

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

from .config import disable_tf32

# full float32 products (no TF32): the counterpart of the JAX package's
# jax_default_matmul_precision="highest"
disable_tf32()

from .runtime import cachedir, parse_model_parameter_file, workdir  # noqa: E402,F401

__version__ = "0.1.0"
