"""PyTorch port: the CUDA kernels against their plain PyTorch versions.

These tests need a CUDA device and skip without one (the kernels have no
CPU mode).  The file imports neither JAX nor the JAX package, so it also
runs on a machine that has only PyTorch; there, skip the repository's
JAX-configuring conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerances: float32 on both sides, differing only in summation order over
the length-n contraction: 5e-4 normwise for values, 1e-3 for the
gradient, as chip_smoke.py states.  The full-precision backward is held
against the plain backward in float64 at 5e-5 normwise, and the MVN
elimination against its plain version at 2e-4 relative (the tolerance of
the JAX package's own kernel test).
"""

import numpy as np
import pytest
import torch

from gpbayestools_hic_tpu_torch.models.gp import finalize_gp_state, GPConfig
from gpbayestools_hic_tpu_torch.ops import fused_mvn as fm
from gpbayestools_hic_tpu_torch.ops import fused_predict as fp
from gpbayestools_hic_tpu_torch.ops.linalg import mvn_loglike_batch
from gpbayestools_hic_tpu_torch.ops.registry import LAUNCH_COUNTS


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
    before = dict(LAUNCH_COUNTS)
    mk, qk, vk = fp.fused_fwd(fs, xq, save_v=True)
    mp, qp, vp = fp.fused_fwd_plain(fs, xq, save_v=True)
    gk = fp.fused_bwd(fs, xq, vk, ctm, ctq)
    gp = fp.fused_bwd_plain(fs, xq, vp, ctm, ctq)
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS["fused_predict_fwd"] == before["fused_predict_fwd"] + 1
    assert LAUNCH_COUNTS["fused_predict_bwd"] == before["fused_predict_bwd"] + 1
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


@pytest.mark.parametrize("m", [200, 1])
def test_cuda_high_precision_backward_matches_f64_plain(cuda_device, m):
    """Kernel 3 (grad_precision="high"/"highest": every product FP32 FMA)
    vs the plain backward evaluated in float64 on the same inputs: 5e-5
    normwise, about n * 2^-24 for the n = 300 .. 1000 sums it takes, ten
    times below what a TF32 product would leave (5e-4).  It has its own
    launch counter."""
    fs, xq, ctm, ctq = _problem(cuda_device, m=m)
    _, _, v = fp.fused_fwd(fs, xq, save_v=True)
    before = dict(LAUNCH_COUNTS)
    g_high = fp.fused_bwd(fs, xq, v, ctm, ctq, "high")
    g_highest = fp.fused_bwd(fs, xq, v, ctm, ctq, "highest")
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS["fused_predict_bwd_high"] == before["fused_predict_bwd_high"] + 2
    assert LAUNCH_COUNTS["fused_predict_bwd"] == before["fused_predict_bwd"]
    g64 = fp.fused_bwd_plain(fp.FusedState(*(t.double() for t in fs)), xq.double(),
                             v.double(), ctm.double(), ctq.double())
    assert _rel(g_high.double(), g64) <= 5e-5
    assert torch.equal(g_high, g_highest)
    with pytest.raises(ValueError, match="grad_precision"):
        fp.fused_bwd(fs, xq, v, ctm, ctq, "low")


def _mvn_problem(dev, b, n, seed=0, bad=None):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(b, n, n)).astype(np.float32)
    cov = a @ a.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)
    if bad is not None:
        cov[bad] = -np.eye(n, dtype=np.float32)
    y = rng.normal(size=(b, n)).astype(np.float32)
    return torch.tensor(y, device=dev), torch.tensor(cov, device=dev)


@pytest.mark.parametrize("route,b,n", [
    ("smem", 4, 1), ("smem", 4, 2), ("smem", 4, 7), ("smem", 64, 12), ("smem", 9, 60),
    ("smem", 8, 130), ("smem", 33, 170), ("smem", 3, 240), ("smem", 2, 339),
    ("panel", 4, 1), ("panel", 4, 7), ("panel", 5, 31), ("panel", 5, 32), ("panel", 5, 33),
    ("panel", 8, 130), ("panel", 6, 340), ("panel", 3, 544),
])
def test_cuda_mvn_matches_plain(cuda_device, route, b, n):
    """Kernel 4, both routes, vs the plain elimination and the library
    factorization on the same float32 inputs (rtol 2e-4: summation order);
    a non-PD matrix in the middle of the batch gives -inf there and leaves
    the others alone."""
    bad = b // 2
    y, cov = _mvn_problem(cuda_device, b, n, seed=n, bad=bad)
    name = "fused_mvn_loglike" if route == "smem" else "fused_mvn_loglike_panel"
    before = LAUNCH_COUNTS[name]
    got = fm._mvn_cuda(y, cov, route=route)
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS[name] == before + 1
    want = fm.fused_mvn_loglike_plain(y, cov)
    lib = mvn_loglike_batch(y, cov)
    assert got[bad] == -torch.inf and want[bad] == -torch.inf
    keep = torch.arange(b, device=cuda_device) != bad
    torch.testing.assert_close(got[keep], want[keep], rtol=2e-4, atol=0)
    torch.testing.assert_close(got[keep], lib[keep], rtol=2e-4, atol=0)


def test_cuda_mvn_dispatch_and_gradient(cuda_device):
    """mvn_loglike_best on a float32 CUDA batch launches the kernel (the
    route follows n), float64 takes the library path; the closed-form
    gradient matches autograd through the library path (rtol 1e-3, the JAX
    package's tolerance for its kernel's VJP) and is zero for the non-PD
    element."""
    y, cov = _mvn_problem(cuda_device, 6, 20, seed=3, bad=2)
    before = dict(LAUNCH_COUNTS)
    ya, ca = y.clone().requires_grad_(True), cov.clone().requires_grad_(True)
    lp = fm.mvn_loglike_best(ya, ca)
    fm.mvn_loglike_best(y.double(), cov.double())
    y2, cov2 = _mvn_problem(cuda_device, 2, 350, seed=4)
    fm.mvn_loglike_best(y2, cov2)
    assert LAUNCH_COUNTS["fused_mvn_loglike"] == before["fused_mvn_loglike"] + 1
    assert LAUNCH_COUNTS["fused_mvn_loglike_panel"] == before["fused_mvn_loglike_panel"] + 1
    gy, gc = torch.autograd.grad(torch.where(torch.isfinite(lp), lp, 0.0).sum(), (ya, ca))
    yb, cb = y.clone().requires_grad_(True), cov.clone().requires_grad_(True)
    lpb = mvn_loglike_batch(yb, cb)
    gyb, gcb = torch.autograd.grad(torch.where(torch.isfinite(lpb), lpb, 0.0).sum(), (yb, cb))
    torch.testing.assert_close(gy, gyb, rtol=1e-3, atol=1e-5)
    torch.testing.assert_close(gc, gcb, rtol=1e-3, atol=1e-5)
    assert torch.all(gy[2] == 0) and torch.all(gc[2] == 0)


def test_cuda_mvn_rejects_wrong_inputs(cuda_device):
    y, cov = _mvn_problem(cuda_device, 3, 5)
    with pytest.raises(ValueError, match="float32"):
        fm._mvn_cuda(y.double(), cov.double())
    with pytest.raises(ValueError, match="shape"):
        fm._mvn_cuda(y, cov[:, :4, :4].contiguous())
    with pytest.raises(ValueError, match="n <="):
        fm._mvn_cuda(*_mvn_problem(cuda_device, 1, 400), route="smem")
