"""PyTorch port: the CUDA kernels against their plain PyTorch versions.

These tests need a CUDA device and skip without one (the kernels have no
CPU mode).  The file imports neither JAX nor the JAX package, so it also
runs on a machine that has only PyTorch; there, skip the repository's
JAX-configuring conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerances: float32 on both sides, differing only in summation order over
the length-n contraction: 5e-4 normwise for values, 1e-3 for the
gradient, as chip_smoke.py states.
"""

import numpy as np
import pytest
import torch

from gpbayestools_hic_tpu_torch.models.gp import finalize_gp_state, GPConfig
from gpbayestools_hic_tpu_torch.ops import fused_predict as fp


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _problem(dev, seed=5, b=4, n=300, d=17, m=200):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.uniform(0, 1, size=(n, d)), device=dev)
    params = {
        "log_ls": torch.tensor(np.log(rng.uniform(0.5, 2.0, size=(b, d))), device=dev),
        "log_amp": torch.tensor(np.log(rng.uniform(0.5, 2.0, size=b)), device=dev),
        "log_noise": torch.tensor(np.log(np.full(b, 0.05)), device=dev),
    }
    y = torch.tensor(rng.normal(size=(b, n)), device=dev)
    st = finalize_gp_state(params, x, y, GPConfig())
    fs = fp.build_fused_state(params, x, st.linv, st.alpha_vec)
    f32 = dict(dtype=torch.float32, device=dev)
    xq = torch.tensor(rng.uniform(0, 1, size=(m, d)), **f32)
    ctm = torch.tensor(rng.normal(size=(b, m)), **f32)
    ctq = torch.tensor(rng.normal(size=(b, m)), **f32)
    return fs, xq, ctm, ctq


def _rel(a, b):
    return (a - b).abs().max().item() / b.abs().max().item()


@pytest.mark.parametrize("m", [200, 64, 1])
def test_cuda_kernels_match_plain(cuda_device, m):
    """Kernel 1 (mean, qf, saved v) and kernel 2 (per-GP query cotangent)
    vs the plain version on the same inputs; each call launches once."""
    fs, xq, ctm, ctq = _problem(cuda_device, m=m)
    before = dict(fp.LAUNCH_COUNTS)
    mk, qk, vk = fp.fused_fwd(fs, xq, save_v=True)
    mp, qp, vp = fp.fused_fwd_plain(fs, xq, save_v=True)
    gk = fp.fused_bwd(fs, xq, vk, ctm, ctq)
    gp = fp.fused_bwd_plain(fs, xq, vp, ctm, ctq)
    torch.cuda.synchronize()
    assert fp.LAUNCH_COUNTS["fused_predict_fwd"] == before["fused_predict_fwd"] + 1
    assert fp.LAUNCH_COUNTS["fused_predict_bwd"] == before["fused_predict_bwd"] + 1
    for a, b_, tol in ((mk, mp, 5e-4), (qk, qp, 5e-4), (vk, vp, 5e-4), (gk, gp, 1e-3)):
        assert _rel(a, b_) <= tol


def test_cuda_autograd_function_matches_plain_autograd(cuda_device):
    """fused_pc_predict (kernel forward, kernel backward) vs autograd
    through the plain forward, on the card."""
    fs, xq, ctm, ctq = _problem(cuda_device, seed=6, n=257, m=130)
    xa = xq.clone().requires_grad_(True)
    mean, qf = fp.fused_pc_predict(fs, xa)
    (g,) = torch.autograd.grad((mean * ctm.T).sum() + (qf * ctq.T).sum(), xa)
    xb = xq.clone().requires_grad_(True)
    mp, qp, _ = fp.fused_fwd_plain(fs, xb)
    (gp,) = torch.autograd.grad((mp * ctm).sum() + (qp * ctq).sum(), xb)
    assert _rel(mean.T, mp) <= 5e-4 and _rel(qf.T, qp) <= 5e-4
    assert _rel(g, gp) <= 1e-3


def test_cuda_rejects_wrong_inputs(cuda_device):
    fs, xq, _, _ = _problem(cuda_device, n=40, m=8)
    with pytest.raises(ValueError, match="float32"):
        fp.fused_fwd(fs, xq.double())
    with pytest.raises(ValueError, match="shape"):
        fp.fused_fwd(fs, xq[:, :5].contiguous())
