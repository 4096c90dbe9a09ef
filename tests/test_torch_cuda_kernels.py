"""PyTorch port: the CUDA kernels against their plain PyTorch versions.

These tests need a CUDA device and skip without one (the kernels have no
CPU mode).  The file imports neither JAX nor the JAX package, so it also
runs on a machine that has only PyTorch; there, skip the repository's
JAX-configuring conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerances, normwise, as chip_smoke.py states them:
- the forward (3xTF32 product, FP32 k*) against its float32 plain version
  5e-4 (summation order over the length-n contraction), and against the
  plain forward in float64 1e-4 in mean and qf (FP32-class; one TF32 pass
  would miss it);
- the fast backward (one TF32 pass on G^T v) against the plain backward in
  float64 2e-3, ten times tighter than the JAX package's fast-backward
  contract, and never bit-equal to the full-precision backward;
- the full-precision backward (3xTF32 with FP32 promotion) against the
  plain backward in float64 5e-5;
- the MVN elimination against its plain version 2e-4 relative (the
  tolerance of the JAX package's own kernel test).
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


def _f64(fs, *ts):
    return (fp.state_as(fs, torch.float64),) + tuple(t.double() for t in ts)


@pytest.mark.parametrize("b", [4, 23, 36, 70])
@pytest.mark.parametrize("n", [1, 40, 257, 1000])
@pytest.mark.parametrize("m", [1, 37, 200, 256, 1024])
def test_cuda_kernels_match_plain(cuda_device, b, n, m):
    """Kernel 1 (mean, qf, saved v) against the plain forward in float32
    and in float64, kernel 2 (per-GP query cotangent) against the plain
    backward in float64, at ragged n and m (padded rows, partial tiles,
    odd row-tile pairs, one and two consumer warpgroups), at the
    flagship's 4 GPs per call, at 36 (its GPs in one call), at the BAND
    heads' 11 to 70, and at m = 256 (a quarter of the flagship's walkers);
    each call launches once."""
    fs, xq, ctm, ctq = _problem(cuda_device, b=b, n=n, m=m)
    before = dict(LAUNCH_COUNTS)
    mk, qk, vk = fp.fused_fwd(fs, xq, save_v=True)
    gk = fp.fused_bwd(fs, xq, vk, ctm, ctq)
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS["fused_predict_fwd"] == before["fused_predict_fwd"] + 1
    assert LAUNCH_COUNTS["fused_predict_bwd"] == before["fused_predict_bwd"] + 1
    mp, qp, vp = fp.fused_fwd_plain(fs, xq, save_v=True)
    for a, b_ in ((mk, mp), (qk, qp), (vk, vp)):
        assert _rel(a, b_) <= 5e-4
    fs64, xq64, v64, ctm64, ctq64 = _f64(fs, xq, vk, ctm, ctq)
    m64, q64, _ = fp.fused_fwd_plain(fs64, xq64)
    assert _rel(mk.double(), m64) <= 1e-4 and _rel(qk.double(), q64) <= 1e-4
    g64 = fp.fused_bwd_plain(fs64, xq64, v64, ctm64, ctq64)
    assert _rel(gk.double(), g64) <= 2e-3


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
    fs, xq, ctm, ctq = _problem(cuda_device, n=40, m=8)
    with pytest.raises(ValueError, match="float32"):
        fp.fused_fwd(fs, xq.double())
    with pytest.raises(ValueError, match="shape"):
        fp.fused_fwd(fs, xq[:, :5].contiguous())
    with pytest.raises(ValueError, match="kernel factor"):
        fp.fused_fwd(fs._replace(kf=None), xq)
    # a backward takes v in the forward kernel's layout, never a plain one
    _, _, v = fp.fused_fwd_plain(fs, xq, save_v=True)
    for prec in ("default", "high"):
        with pytest.raises(ValueError, match="saved v"):
            fp.fused_bwd(fs, xq, v, ctm, ctq, prec)
    g = fp.fused_bwd(fs, xq, fp.kernel_layout_v(fs, xq, v), ctm, ctq)
    assert torch.isfinite(g).all()


def test_cuda_layout_helpers_match_the_library(cuda_device):
    """The Python mirrors of the library's sizes (scratch floats, the padded
    row stride, the k* planes) agree with the built library, and the saved
    v is the (b, n, m) view of plane 0 of a (1 + KST_PLANES, b, m, ld)
    buffer with zeros in the padding and the plain k* (to rounding) in the
    next plane."""
    lib = fp._lib()
    assert lib.fused_predict_kst_planes() == fp.KST_PLANES
    assert lib.fused_predict_factor_planes() == fp.FACTOR_PLANES
    for b, n, m, d in ((1, 1, 1, 1), (4, 1000, 1024, 17), (23, 257, 37, 5), (70, 999, 200, 32)):
        assert lib.fused_predict_ld(n) == fp.factor_ld(n)
        for entry in (0, 1, 2):
            assert lib.fused_predict_scratch(entry, b, n, m, d) == fp.scratch_floats(
                entry, b, n, m, d)
    fs, xq, _, _ = _problem(cuda_device, n=257, m=37)
    _, _, v = fp.fused_fwd(fs, xq, save_v=True)
    ld = fp.factor_ld(257)
    assert v.shape == (4, 257, 37) and v.stride() == (37 * ld, 1, ld)
    pad = torch.as_strided(v, (4, 37, ld - 257), (37 * ld, ld, 1), v.storage_offset() + 257)
    assert torch.count_nonzero(pad) == 0
    kst = torch.as_strided(v, (4, 37, 257), (37 * ld, ld, 1), 4 * 37 * ld)
    assert _rel(kst, fp._kstar_plain(fs, xq)[2].mT) <= 1e-6


@pytest.mark.parametrize("n", [257, 1000])
def test_cuda_walkers_do_not_depend_on_the_batch(cuda_device, n):
    """A walker's mean, qf, v and query cotangent (of both backwards) are
    the same bit for bit whether it shares the call with 1023 other walkers
    or with 255 (the two batches take different block shapes: one consumer
    warpgroup per block at 256, two at 1024), as the sharded path j of
    chip_smoke.py requires."""
    fs, xq, ctm, ctq = _problem(cuda_device, n=n, m=1024, seed=11)
    full = fp.fused_fwd(fs, xq, save_v=True)
    g_full = fp.fused_bwd(fs, xq, full[2], ctm, ctq)
    h_full = fp.fused_bwd(fs, xq, full[2], ctm, ctq, "high")
    for lo in (0, 256, 768):
        sl = slice(lo, lo + 256)
        part = fp.fused_fwd(fs, xq[sl].contiguous(), save_v=True)
        assert torch.equal(part[0], full[0][:, sl]) and torch.equal(part[1], full[1][:, sl])
        assert torch.equal(part[2], full[2][:, :, sl])
        cts = (ctm[:, sl].contiguous(), ctq[:, sl].contiguous())
        g = fp.fused_bwd(fs, xq[sl].contiguous(), part[2], *cts)
        assert torch.equal(g, g_full[:, sl])
        h = fp.fused_bwd(fs, xq[sl].contiguous(), part[2], *cts, "high")
        assert torch.equal(h, h_full[:, sl])


@pytest.mark.parametrize("n", [40, 257, 1000])
@pytest.mark.parametrize("m", [1, 37, 200, 256])
def test_cuda_high_precision_backward_matches_f64_plain(cuda_device, n, m):
    """Kernel 3 (grad_precision="high"/"highest": G^T v in 3xTF32 with each
    ring stage's products promoted to FP32, the rest FP32) vs the plain
    backward evaluated in float64 on the same inputs: 5e-5 normwise, about
    n * 2^-24 for the length-n sums it takes, well below what one TF32
    pass leaves (~1e-4 and more), and not bit-equal to the fast backward.
    Ragged n (rows padded to a multiple of 4) and m take the same route.
    It has its own launch counter."""
    fs, xq, ctm, ctq = _problem(cuda_device, n=n, m=m)
    _, _, v = fp.fused_fwd(fs, xq, save_v=True)
    before = dict(LAUNCH_COUNTS)
    g_high = fp.fused_bwd(fs, xq, v, ctm, ctq, "high")
    g_highest = fp.fused_bwd(fs, xq, v, ctm, ctq, "highest")
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS["fused_predict_bwd_high"] == before["fused_predict_bwd_high"] + 2
    assert LAUNCH_COUNTS["fused_predict_bwd"] == before["fused_predict_bwd"]
    g64 = fp.fused_bwd_plain(*_f64(fs, xq, v, ctm, ctq))
    assert _rel(g_high.double(), g64) <= 5e-5
    assert torch.equal(g_high, g_highest)
    assert not torch.equal(g_high, fp.fused_bwd(fs, xq, v, ctm, ctq))
    with pytest.raises(ValueError, match="grad_precision"):
        fp.fused_bwd(fs, xq, v, ctm, ctq, "low")


def test_cuda_fast_backward_is_tf32_not_high(cuda_device):
    """Kernel 2 (one TF32 pass on G^T v) stays within 2e-3 of the float64
    backward but is not bit-equal to kernel 3 (a dead grad_precision knob
    would make them equal), and misses kernel 3's 5e-5: it really is the
    reduced-precision program."""
    fs, xq, ctm, ctq = _problem(cuda_device, n=1000, m=256)
    _, _, v = fp.fused_fwd(fs, xq, save_v=True)
    g_fast = fp.fused_bwd(fs, xq, v, ctm, ctq)
    g_high = fp.fused_bwd(fs, xq, v, ctm, ctq, "high")
    torch.cuda.synchronize()
    g64 = fp.fused_bwd_plain(*_f64(fs, xq, v, ctm, ctq))
    assert not torch.equal(g_fast, g_high)
    assert 5e-5 < _rel(g_fast.double(), g64) <= 2e-3


def _illconditioned_posterior(dev, rng, grad_precision):
    """A GP posterior with Hessian condition ~1e6 (per-observable precisions
    spanning 1e3), driving HMC through the CUDA kernels: values from the
    forward, gradients from the full-precision ("high") or the one-pass
    TF32 ("default") backward.  The port of the JAX package's helper of
    the same name (tests/test_pallas_predict.py)."""
    b, n, d = 4, 48, 4
    x = rng.uniform(0, 1, size=(n, d))
    params = {
        "log_ls": np.log(rng.uniform(0.5, 3.0, size=(b, d))),
        "log_amp": np.log(rng.uniform(0.8, 1.2, size=b)),
        "log_noise": np.log(np.full(b, 0.05)),
    }
    linv = np.tril(rng.normal(size=(b, n, n)) * 0.1) + np.eye(n)[None]
    alpha = rng.normal(size=(b, n))
    t = lambda a: torch.tensor(np.asarray(a), device=dev)  # noqa: E731
    fs = fp.build_fused_state({k: t(v) for k, v in params.items()}, t(x), t(linv), t(alpha))
    target = torch.tensor([0.2, -0.1, 0.3, 0.0], dtype=torch.float32, device=dev)
    inv_sigma = torch.tensor([1e3, 1e2, 1e1, 1e0], dtype=torch.float32, device=dev)

    def log_prob(state, xq):
        mn, _ = fp.fused_pc_predict(state, xq.float(), grad_precision)
        r = (mn - target[None, :]) * inv_sigma[None, :]
        return -0.5 * (r * r).sum(-1).to(xq.dtype)

    return log_prob, fs


def test_cuda_fastbwd_acceptance_safe_on_illconditioned_posterior(cuda_device):
    """The JAX package's safety envelope of grad_precision="default", on the
    port: on a posterior whose curvature spans 1e6, the TF32 backward keeps
    HMC acceptance within 0.20 of the full-precision gradient's and above
    0.4 (the thresholds of tests/test_pallas_predict.py)."""
    from gpbayestools_hic_tpu_torch.samplers.hmc import run_hmc

    accs = {}
    for precision in ("high", "default"):
        log_prob, fs = _illconditioned_posterior(cuda_device, np.random.default_rng(7),
                                                 precision)
        x0 = np.random.default_rng(8).uniform(0.3, 0.7, (32, 4))
        res = run_hmc(log_prob, x0, 96, seed=3, state=fs, lo=np.zeros(4), hi=np.ones(4),
                      n_leapfrog=6, warmup=64, device=cuda_device)
        accs[precision] = float(np.mean(res.acceptance))
        assert np.all(np.isfinite(res.chain)), precision
    assert accs["default"] > accs["high"] - 0.20, accs
    assert accs["default"] > 0.4, accs


def _mvn_problem(dev, b, n, seed=0, bad=None):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(b, n, n)).astype(np.float32)
    cov = a @ a.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)
    if bad is not None:
        cov[bad] = -np.eye(n, dtype=np.float32)
    y = rng.normal(size=(b, n)).astype(np.float32)
    return torch.tensor(y, device=dev), torch.tensor(cov, device=dev)


def _mvn_size(n):
    """A size of the MVN cases: an int, or one named by the shared-memory
    route's panel width P ("P-1", "P", "P+1", "2P+1") or its largest n
    ("max"), by the cluster route's cluster size C and panel width at
    n = 2P ("CP-1", "CP", "CP+1": a rank with one row block, or none) or
    its largest n ("cmax"), or the wide route's ("panel") smallest n
    ("pmin"), its panel width W ("W-1", "W", "W+1", "2W+1"), or where the
    rows below its first panel fill one chunk of WIDE_CHUNK rows exactly
    ("WK") or spill one row into a second ("WK+1"), read from the built
    library."""
    if isinstance(n, int):
        return n
    if n == "max":
        return fm.smem_max_n()
    if n.startswith("W") or n.startswith("2W"):
        w = fm.wide_info(1, 1)["p"]
        k = w + fm.WIDE_CHUNK - 1  # rows w .. k: one chunk
        return {"W-1": w - 1, "W": w, "W+1": w + 1, "2W+1": 2 * w + 1, "WK": k,
                "WK+1": k + 1}[n]
    if n in ("cmax", "pmin"):
        return fm.route_max_n("cluster") + (n == "pmin")
    if n.startswith("CP"):
        info = fm.cluster_info(2 * fm.cluster_info(1)["p"])
        cp = info["c"] * info["p"]
        return {"CP-1": cp - 1, "CP": cp, "CP+1": cp + 1}[n]
    p = fm.smem_panel()
    return {"P-1": p - 1, "P": p, "P+1": p + 1, "2P+1": 2 * p + 1}[n]


@pytest.mark.parametrize("route,b,n", [
    ("smem", 4, 1), ("smem", 4, 2), ("smem", 4, 7), ("smem", 64, 12), ("smem", 9, 60),
    ("smem", 6, "P-1"), ("smem", 6, "P"), ("smem", 6, "P+1"), ("smem", 6, "2P+1"),
    ("smem", 8, 130), ("smem", 33, 170), ("smem", 5, 171), ("smem", 3, 240),
    ("smem", 3, "max"),
    ("panel", 4, 1), ("panel", 4, 7), ("panel", 5, 31), ("panel", 5, 32), ("panel", 5, 33),
    ("panel", 8, 130), ("panel", 6, 340), ("panel", 3, 544), ("panel", 3, "pmin"),
    ("panel", 2, 1000),
    ("panel", 5, 15), ("panel", 5, 16), ("panel", 5, 17), ("panel", 5, "W-1"),
    ("panel", 5, "W"), ("panel", 5, "W+1"), ("panel", 4, "2W+1"), ("panel", 140, 200),
    ("panel", 3, "WK"), ("panel", 3, "WK+1"),
])
def test_cuda_mvn_matches_plain(cuda_device, route, b, n):
    """Kernel 4, both routes, vs the plain elimination and the library
    factorization on the same float32 inputs (rtol 2e-4: summation order);
    a non-PD matrix in the middle of the batch gives -inf there, and so
    does a second one whose bad pivot falls in the middle of a panel of the
    shared-memory route (its earlier pivots are good); the others are left
    alone.  The shared-memory cases straddle its panel boundaries."""
    n = _mvn_size(n)
    bad = b // 2
    y, cov = _mvn_problem(cuda_device, b, n, seed=n, bad=bad)
    bads = [bad]
    if b >= 3:
        panel = fm.smem_panel()
        k = panel + panel // 2 if n > panel + panel // 2 else n // 2
        bads.append((bad + 1) % b)
        cov[bads[1], k, k] = -1.0
    name = "fused_mvn_loglike" if route == "smem" else "fused_mvn_loglike_panel"
    before = LAUNCH_COUNTS[name]
    got = fm._mvn_cuda(y, cov, route=route)
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS[name] == before + 1
    want = fm.fused_mvn_loglike_plain(y, cov)
    lib = mvn_loglike_batch(y, cov)
    for i in bads:
        assert got[i] == -torch.inf and want[i] == -torch.inf
    keep = torch.ones(b, dtype=torch.bool, device=cuda_device)
    keep[bads] = False
    torch.testing.assert_close(got[keep], want[keep], rtol=2e-4, atol=0)
    torch.testing.assert_close(got[keep], lib[keep], rtol=2e-4, atol=0)


@pytest.mark.parametrize("n", [1, 12, 14, 21, 28, 31, 32, 33, 73, 170])
def test_cuda_mvn_smem_bits_do_not_depend_on_the_batch(cuda_device, n):
    """The shared-memory route (its warp kernel to n = 32, its block kernel
    past it): at b = 1, 511, 512, 513 and 1025 (ragged against the warp
    kernel's four matrices per block), from the batch's start and from its
    end, and with the batch permuted, every matrix gives
    the bits it gives in the full batch (path j shards the batch), and the
    full batch matches the plain elimination (rtol 2e-4)."""
    total = 1025
    y, cov = _mvn_problem(cuda_device, total, n, seed=100 + n)
    full = fm._mvn_cuda(y, cov, route="smem")
    for b in (1, 511, 512, 513, total):
        for off in {0, total - b}:
            got = fm._mvn_cuda(y[off:off + b], cov[off:off + b], route="smem")
            assert torch.equal(got, full[off:off + b]), (b, off)
    perm = torch.randperm(total, generator=torch.Generator().manual_seed(n)).to(cuda_device)
    assert torch.equal(fm._mvn_cuda(y[perm].contiguous(), cov[perm].contiguous(), route="smem"),
                       full[perm])
    torch.testing.assert_close(full, fm.fused_mvn_loglike_plain(y, cov), rtol=2e-4, atol=0)


@pytest.mark.parametrize("n", [12, 14, 28, 32])
def test_cuda_mvn_warp_kernel_past_the_resident_warps(cuda_device, n):
    """At b = 16383 and 16384 the warp kernel's blocks (four matrices each)
    are more than the card holds at once.  Each matrix gives the bits it
    gives in a batch of 1024, and the batch matches the plain elimination
    (rtol 2e-4)."""
    y, cov = _mvn_problem(cuda_device, 1024, n, seed=300 + n)
    small = fm._mvn_cuda(y, cov, route="smem")
    for b in (16383, 16384):
        reps = -(-b // 1024)
        yb = y.repeat(reps, 1)[:b].contiguous()
        cb = cov.repeat(reps, 1, 1)[:b].contiguous()
        got = fm._mvn_cuda(yb, cb, route="smem")
        assert torch.equal(got, small.repeat(reps)[:b]), b
    torch.testing.assert_close(small, fm.fused_mvn_loglike_plain(y, cov), rtol=2e-4, atol=0)


@pytest.mark.parametrize("n", [12, 28, 32, 73])
@pytest.mark.parametrize("where", ["first", "mid", "end"])
def test_cuda_mvn_smem_bad_pivots_in_every_slot(cuda_device, n, where):
    """A bad pivot (the first, one mid-matrix or mid-panel, the last or a
    panel's last) planted in each slot of the warp kernel's blocks in turn
    (b = 8: two blocks of four matrices; the block kernel: one matrix per
    block): -inf there, every other matrix bit-equal to the clean batch."""
    b = 8
    p = fm.smem_panel()
    if n > fm.WARP_MAX_N:
        k = {"first": 0, "mid": p + p // 2, "end": 2 * p - 1}[where]
    else:
        k = {"first": 0, "mid": n // 2, "end": n - 1}[where]
    y, cov = _mvn_problem(cuda_device, b, n, seed=200 + n)
    clean = fm._mvn_cuda(y, cov, route="smem")
    assert torch.isfinite(clean).all()
    for slot in range(b):
        c = cov.clone()
        c[slot, k, k] = -1.0
        got = fm._mvn_cuda(y, c, route="smem")
        keep = torch.arange(b, device=cuda_device) != slot
        assert got[slot] == -torch.inf, slot
        assert torch.equal(got[keep], clean[keep]), slot


@pytest.mark.parametrize("b", [1, 3, 130])
@pytest.mark.parametrize("n", [319, "CP-1", "CP", "CP+1", 440, 441, 544, "cmax"])
def test_cuda_mvn_cluster_matches_plain(cuda_device, b, n):
    """The cluster route (forced at n below its range too) against the
    plain elimination and the library factorization, rtol 2e-4: n at the
    edges of the rank blocks and of the cluster sizes, the stitched 544 and
    the route's largest n; b = 130 is more than one round of clusters.
    With three or more matrices, one non-PD matrix and one whose bad pivot
    falls in the middle of the second panel give -inf there."""
    n = _mvn_size(n)
    y, cov = _mvn_problem(cuda_device, b, n, seed=n + b)
    bads = []
    if b >= 3:
        bads = [b // 2, b // 2 + 1]
        cov[bads[0]] = -torch.eye(n, device=cuda_device)
        k = min(n - 1, fm.cluster_info(n)["p"] * 3 // 2)
        cov[bads[1], k, k] = -1.0
    before = LAUNCH_COUNTS["fused_mvn_loglike_cluster"]
    got = fm._mvn_cuda(y, cov, route="cluster")
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS["fused_mvn_loglike_cluster"] == before + 1
    want = fm.fused_mvn_loglike_plain(y, cov)
    lib = mvn_loglike_batch(y, cov)
    for i in bads:
        assert got[i] == -torch.inf and want[i] == -torch.inf
    keep = torch.ones(b, dtype=torch.bool, device=cuda_device)
    keep[bads] = False
    assert torch.isfinite(got[keep]).all()
    torch.testing.assert_close(got[keep], want[keep], rtol=2e-4, atol=0)
    torch.testing.assert_close(got[keep], lib[keep], rtol=2e-4, atol=0)


@pytest.mark.parametrize("n", [441, 544])
def test_cuda_mvn_cluster_bad_pivots_in_every_rank(cuda_device, n):
    """A bad pivot planted in the first panel, in a row block owned by each
    rank of the cluster, and at the last pivot (one matrix each; the
    pivots before it stay good): -inf there, and every other matrix keeps
    exactly the value it has in a batch without bad pivots."""
    info = fm.cluster_info(n)
    c, p = info["c"], info["p"]
    ks = [1] + [r * p + p // 2 for r in range(c)] + [n - 1]
    b = len(ks) + 2
    y, cov = _mvn_problem(cuda_device, b, n, seed=9)
    clean = fm._mvn_cuda(y, cov, route="cluster")
    for m, k in enumerate(ks):
        cov[m, k, k] = -1.0
    got = fm._mvn_cuda(y, cov, route="cluster")
    want = fm.fused_mvn_loglike_plain(y, cov)
    torch.cuda.synchronize()
    for m in range(len(ks)):
        assert got[m] == -torch.inf and want[m] == -torch.inf, ks[m]
    assert torch.equal(got[len(ks):], clean[len(ks):])
    assert torch.isfinite(clean).all()


def test_cuda_mvn_cluster_layout_is_the_libraries(cuda_device):
    """The built library's cluster sizes, panel width and shared memory per
    CTA are cluster_layout's, and its route limits route_limits'; the card
    places at least one cluster at every n the route takes."""
    limits = fm.route_limits()
    for route, (_, hi) in limits.items():
        assert fm.route_max_n(route) == hi, route
    lo, hi = limits["cluster"]
    for n in sorted({1, 31, 32, 33, lo, 400, 439, 440, 441, 522, 523, 544, 600, hi}):
        info, want = fm.cluster_info(n), fm.cluster_layout(n)
        assert (info["c"], info["p"], info["bytes"]) == tuple(want), n
        assert info["active_clusters"] >= 1, n
    assert fm.cluster_info(hi + 1)["c"] == -1


def test_cuda_mvn_cluster_allocates_only_its_output(cuda_device):
    """The cluster route at the stitched half-ensemble (512, 544) allocates
    its output and no scratch (the panel route allocated 608 MB)."""
    y, cov = _mvn_problem(cuda_device, 512, 544, seed=1)
    fm._mvn_cuda(y, cov)  # the library is built and loaded
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = LAUNCH_COUNTS["fused_mvn_loglike_cluster"]
    out = fm._mvn_cuda(y, cov)
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS["fused_mvn_loglike_cluster"] == before + 1
    assert torch.cuda.max_memory_allocated() - base <= 4096, (
        torch.cuda.max_memory_allocated() - base)
    assert out.shape == (512,)


def test_cuda_mvn_dispatch_and_gradient(cuda_device):
    """mvn_loglike_best on a float32 CUDA batch launches the kernel (the
    route follows n: the shared-memory route at 20, the cluster route at
    350, the panel route past the cluster route's largest n), float64
    takes the library path; the closed-form
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
    y3, cov3 = _mvn_problem(cuda_device, 2, _mvn_size("pmin"), seed=5)
    fm.mvn_loglike_best(y3, cov3)
    assert LAUNCH_COUNTS["fused_mvn_loglike"] == before["fused_mvn_loglike"] + 1
    assert LAUNCH_COUNTS["fused_mvn_loglike_cluster"] == before["fused_mvn_loglike_cluster"] + 1
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
        fm._mvn_cuda(*_mvn_problem(cuda_device, 1, fm.smem_max_n() + 1), route="smem")
    with pytest.raises(ValueError, match="n <="):
        fm._mvn_cuda(*_mvn_problem(cuda_device, 1, _mvn_size("pmin")), route="cluster")


def _mvn_problem_dev(dev, b, n, seed=0):
    """A well-conditioned float32 batch built on the card (the host would
    take minutes for b n^3 at n in the thousands): C = A A^T + n I with A
    (n, n) normal, y normal."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn((b, n, n), generator=gen, device=dev, dtype=torch.float32)
    cov = torch.bmm(a, a.transpose(1, 2))
    cov.diagonal(dim1=1, dim2=2).add_(float(n))
    y = torch.randn((b, n), generator=gen, device=dev, dtype=torch.float32)
    del a
    return y, cov


@pytest.mark.parametrize("b", [1, 16, 130])
@pytest.mark.parametrize("n", [767, 1000, 1088, 1759, 1760, 2048])
def test_cuda_mvn_wide_matches_plain_and_library(cuda_device, b, n):
    """The wide route (route "panel") at the n it takes by default, on both
    sides of the old route's cap (1759), against the plain elimination and
    the library factorization, rtol 2e-4; with three or more matrices, one
    non-PD matrix and one whose bad pivot falls inside the second panel
    give -inf there, and every other matrix is finite."""
    y, cov = _mvn_problem_dev(cuda_device, b, n, seed=n + b)
    bads = []
    if b >= 3:
        bads = [b // 2, b // 2 + 1]
        cov[bads[0]] = -torch.eye(n, device=cuda_device)
        k = fm.wide_info(b, n)["p"] + 24
        cov[bads[1], k, k] = -1.0
    before = LAUNCH_COUNTS["fused_mvn_loglike_panel"]
    got = fm.fused_mvn_loglike(y, cov)
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS["fused_mvn_loglike_panel"] == before + 1
    want = fm.fused_mvn_loglike_plain(y, cov)
    lib = mvn_loglike_batch(y, cov)
    for i in bads:
        assert got[i] == -torch.inf and want[i] == -torch.inf
    keep = torch.ones(b, dtype=torch.bool, device=cuda_device)
    keep[bads] = False
    assert torch.isfinite(got[keep]).all()
    torch.testing.assert_close(got[keep], want[keep], rtol=2e-4, atol=0)
    torch.testing.assert_close(got[keep], lib[keep], rtol=2e-4, atol=0)


def test_cuda_mvn_wide_at_4096(cuda_device):
    """n = 4096 (beyond the old cap by a factor 2.3) through the default
    route against the library factorization and the float64 elimination,
    rtol 2e-4."""
    y, cov = _mvn_problem_dev(cuda_device, 2, 4096, seed=4096)
    got = fm.fused_mvn_loglike(y, cov)
    lib = mvn_loglike_batch(y, cov)
    want64 = mvn_loglike_batch(y.double(), cov.double())
    torch.cuda.synchronize()
    torch.testing.assert_close(got, lib, rtol=2e-4, atol=0)
    torch.testing.assert_close(got.double(), want64, rtol=2e-4, atol=0)


@pytest.mark.parametrize("b,n", [(16, 1088), (130, 1088), (512, 1088), (16, 2048)])
def test_cuda_mvn_wide_bad_pivots_in_every_rank(cuda_device, b, n):
    """A bad pivot in a row of each rank's first chunk below the first
    panel (chunk k of WIDE_CHUNK rows belongs to rank k mod C), inside a
    16-column step, at both sides of the first panel boundary and at the
    last pivot (one matrix each; the pivots before it stay good): -inf
    there, and every other matrix keeps exactly the value it has in a batch
    without bad pivots."""
    info = fm.wide_info(b, n)
    c, w = info["c"], info["p"]
    chunks = {w + fm.WIDE_CHUNK * r + 8 for r in range(c)} - {n}
    ks = sorted({k for k in chunks if k < n} | {8, w - 1, w, n - 1})
    assert b >= len(ks) + 2
    y, cov = _mvn_problem_dev(cuda_device, b, n, seed=9)
    clean = fm._mvn_cuda(y, cov, route="panel")
    for i, k in enumerate(ks):
        cov[i, k, k] = -1.0
    got = fm._mvn_cuda(y, cov, route="panel")
    want = fm.fused_mvn_loglike_plain(y[:len(ks)], cov[:len(ks)])
    torch.cuda.synchronize()
    for i, k in enumerate(ks):
        assert got[i] == -torch.inf and want[i] == -torch.inf, k
    assert torch.equal(got[len(ks):], clean[len(ks):])
    assert torch.isfinite(clean).all()


def test_cuda_mvn_wide_layout_is_the_libraries(cuda_device):
    """The built library's wide route on this card: the SM count it reads is
    the card's, and its cluster size, CTAs per SM, panel width, shared memory
    per CTA and scratch size are wide_layout's for that count at every
    (b, n); it has no largest n; the card places at least one cluster
    (placements printed)."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert fm.route_max_n("panel") is None and fm.route_limits()["panel"][1] is None
    for b in (1, 2, 16, 17, 66, 130, 512, 1024):
        for n in (1, 15, 63, 64, 65, 767, 1000, 1088, 1759, 1760, 2048, 4096, 6656, 20000):
            info, want = fm.wide_info(b, n), fm.wide_layout(b, n, sms)
            assert info["sms"] == sms
            assert (info["c"], info["ctas_per_sm"], info["p"], info["bytes"],
                    info["scratch"]) == tuple(want), (b, n)
            assert info["active_clusters"] >= 1, (b, n)
    for b, n in ((16, 767), (512, 1088), (2, 2048), (1, 4096)):
        info = fm.wide_info(b, n)
        print(f"wide route (b={b}, n={n}) on {sms} SMs: C = {info['c']}, "
              f"{info['ctas_per_sm']} CTAs per SM, {info['bytes']} B per CTA, "
              f"{info['active_clusters']} clusters placed at once")


def test_cuda_mvn_wide_allocates_output_and_scratch_only(cuda_device):
    """The wide route allocates its output and its scratch (b matrices of
    n + 1 rows of whole float4s), nothing else (the allocator's rounding
    aside)."""
    b, n = 16, 1088
    y, cov = _mvn_problem_dev(cuda_device, b, n, seed=1)
    fm._mvn_cuda(y, cov)  # the library is built and loaded
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = LAUNCH_COUNTS["fused_mvn_loglike_panel"]
    out = fm._mvn_cuda(y, cov)
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS["fused_mvn_loglike_panel"] == before + 1
    scratch = 4 * b * fm.wide_info(b, n)["scratch"]
    extra = torch.cuda.max_memory_allocated() - base
    assert extra <= scratch + 2 * 1024 * 1024, (extra, scratch)
    assert out.shape == (b,)


def test_cuda_mvn_best_takes_the_wide_route_at_large_n(cuda_device):
    """n = 6656 and 8191 (past 6655, where an earlier wide route's shared
    memory ran out): mvn_loglike_best launches the wide route once, and
    agrees with the library factorization and the float64 elimination,
    rtol 2e-4."""
    for n in (6656, 8191):
        y, cov = _mvn_problem_dev(cuda_device, 1, n, seed=n)
        before = LAUNCH_COUNTS["fused_mvn_loglike_panel"]
        got = fm.mvn_loglike_best(y, cov)
        torch.cuda.synchronize()
        assert LAUNCH_COUNTS["fused_mvn_loglike_panel"] == before + 1
        torch.testing.assert_close(got, mvn_loglike_batch(y, cov), rtol=2e-4, atol=0)
        want64 = mvn_loglike_batch(y.double(), cov.double())
        torch.testing.assert_close(got.double(), want64, rtol=2e-4, atol=0)
        del y, cov


def test_cuda_emulator_past_the_kernels_dim_takes_the_plain_path(cuda_device, tmp_path):
    """A float32 RBF emulator with d = 40 > DMAX gets no fused state; its
    fast-gradient predict and gradient on the card run the plain gp_predict
    and match the float64 plain path (1e-4 relative), with no predict
    kernel launched."""
    from gpbayestools_hic_tpu_torch.models.emulator import Emulator
    from gpbayestools_hic_tpu_torch.utils.synthetic import (
        write_parameter_file, write_training_pickle)

    rng = np.random.default_rng(11)
    d, nev, nobs = 40, 120, 6
    design = rng.uniform(0, 1, size=(nev, d))
    base = 2.0 + np.sin(design @ rng.uniform(0.2, 0.6, size=(d, nobs)))
    pkl = write_training_pickle(str(tmp_path / "train.pkl"), design, base, 0.01 * np.abs(base))
    par = write_parameter_file(str(tmp_path / "pars.txt"), d)
    e32 = Emulator(pkl, par, npc=3, gp_maxiter=0, device=cuda_device, dtype=torch.float32)
    e32.trainEmulator(np.ones(nev, dtype=bool))
    e64 = Emulator(pkl, par, npc=3, gp_maxiter=0, device=cuda_device, dtype=torch.float64)
    e64.trainEmulator(np.ones(nev, dtype=bool))
    assert e32._fused is None and not fp.fused_eligible("RBF", d, torch.float32)
    x = torch.tensor(rng.uniform(0.05, 0.95, size=(9, d)), dtype=torch.float32,
                     device=cuda_device, requires_grad=True)
    before = dict(LAUNCH_COUNTS)
    gm, gv = e32.predict_pc_raw_fastgrad(x)
    (g32,) = torch.autograd.grad((gm.sum() + gv.sum()), x)
    assert dict(LAUNCH_COUNTS) == before
    x64 = x.detach().double().requires_grad_(True)
    gm64, gv64 = e64.predict_pc_raw(x64)
    (g64,) = torch.autograd.grad((gm64.sum() + gv64.sum()), x64)
    assert _rel(gm, gm64) < 1e-4 and _rel(gv, gv64) < 1e-4
    assert _rel(g32, g64) < 1e-3


def test_cuda_gp_fit_matches_the_cpu_fit(cuda_device):
    """The batched GP fit on the card (cuSOLVER Cholesky) in float64 gives
    the CPU's float64 fit (LML to 1e-6, log-hyperparameters to 1e-5:
    optimizer tolerance), and in float32 a fit whose every LML is finite and
    above the initialization's; TF32 left on refuses to train."""
    from gpbayestools_hic_tpu_torch.models import gp

    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, size=(120, 5))
    y = np.stack([np.sin(3 * x[:, 0]) + np.cos(2 * x[:, 1]) + x[:, 2] * x[:, 3],
                  np.cos(4 * x[:, 4]) + x[:, 0] ** 2, np.sin(x @ np.arange(1.0, 6.0))])
    ptp = np.ones(5)
    cpu = gp.gp_fit(torch.tensor(x), torch.tensor(y), ptp, maxiter=30)
    dev = gp.gp_fit(torch.tensor(x, device=cuda_device), torch.tensor(y, device=cuda_device),
                    ptp, maxiter=30)
    np.testing.assert_allclose(dev.lml.cpu().numpy(), cpu.lml.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(dev.params["log_ls"].cpu().numpy(),
                               cpu.params["log_ls"].numpy(), rtol=0, atol=1e-5)
    f32 = dict(dtype=torch.float32, device=cuda_device)
    fit32 = gp.gp_fit(torch.tensor(x, **f32), torch.tensor(y, **f32), ptp, maxiter=30)
    init32 = gp.gp_fit(torch.tensor(x, **f32), torch.tensor(y, **f32), ptp, maxiter=0)
    assert torch.isfinite(fit32.lml).all() and (fit32.lml > init32.lml).all()
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="allow_tf32"):
            gp.gp_fit(torch.tensor(x, **f32), torch.tensor(y, **f32), ptp, maxiter=1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
