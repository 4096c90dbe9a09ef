"""PyTorch port: fused GP PC-predict (kernel module) against the JAX package.

On the CPU the port's wrappers take the plain PyTorch version; the CUDA
kernels are held against that plain version by
tests/test_torch_cuda_kernels.py (skipped without a GPU) and by
``chip_smoke.py`` on the card.  Inputs come from
numpy seeds and go through both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpbayestools_hic_tpu.ops.pallas_predict as pp
from gpbayestools_hic_tpu.models.gp import GPConfig as JGPConfig
from gpbayestools_hic_tpu.models.gp import finalize_gp_state as j_finalize
from gpbayestools_hic_tpu.models.gp import gp_predict as j_gp_predict
from gpbayestools_hic_tpu_torch.ops import _build
from gpbayestools_hic_tpu_torch.ops import fused_predict as fp
from gpbayestools_hic_tpu_torch.ops import registry
from gpbayestools_hic_tpu_torch.models.gp import GPConfig, GPState, gp_predict


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the suite runs in
    parallel worker processes, where multi-threaded torch ops on every
    worker oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gp_problem(seed, b=3, n=50, d=5, m=37):
    """A real GP batch (JAX finalize_gp_state) + queries, all numpy f64."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, size=(n, d))
    params = {
        "log_ls": np.log(rng.uniform(0.5, 2.0, size=(b, d))),
        "log_amp": np.log(rng.uniform(0.5, 2.0, size=b)),
        "log_noise": np.log(np.full(b, 0.05)),
    }
    y = rng.normal(size=(b, n))
    st = j_finalize({k: jnp.asarray(v) for k, v in params.items()},
                    jnp.asarray(x), jnp.asarray(y), JGPConfig())
    xq = rng.uniform(0, 1, size=(m, d))
    w = rng.normal(size=(2, b, m))
    return x, params, st, xq, w


def _port_state_f64(x, params, st):
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)  # noqa: E731
    ls = np.exp(params["log_ls"])
    amp = np.exp(params["log_amp"])
    return fp.FusedState(
        xs=t(x[None] / ls[:, None, :]), G=t(np.tril(np.asarray(st.linv))),
        alpha=t(st.alpha_vec), amp=t(amp), inv_ls=t(1.0 / ls),
        kdiag=t(amp + np.exp(params["log_noise"])),
    )


def test_fused_plain_f64_matches_jax_gp_predict_fast_grad():
    """Port plain path vs JAX gp_predict(fast_grad=True), f64: values to
    rtol 1e-10 and the query gradient to 1e-8 (both are float64 evaluations
    of the same formulas; only the summation order differs)."""
    x, params, st, xq, w = _gp_problem(0)
    fs = _port_state_f64(x, params, st)
    xq_t = torch.tensor(xq, requires_grad=True)
    mean, qf = fp.fused_pc_predict(fs, xq_t)                 # (m, b)
    var = torch.clamp(fs.kdiag[None, :] - qf, min=0.0)
    jmean, jvar = j_gp_predict(st, jnp.asarray(xq), config=JGPConfig(), fast_grad=True)
    np.testing.assert_allclose(mean.detach().numpy().T, np.asarray(jmean), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(var.detach().numpy().T, np.asarray(jvar), rtol=1e-10, atol=1e-12)
    assert (np.asarray(jvar) > 0).all()   # no clamp ties in the gradient

    loss = (mean.T * torch.tensor(w[0])).sum() + (var.T * torch.tensor(w[1])).sum()
    (g,) = torch.autograd.grad(loss, xq_t)

    def jloss(q):
        mn, vr = j_gp_predict(st, q, config=JGPConfig(), fast_grad=True)
        return jnp.sum(mn * w[0]) + jnp.sum(vr * w[1])

    jg = np.asarray(jax.grad(jloss)(jnp.asarray(xq)))
    scale = np.abs(jg).max()
    np.testing.assert_allclose(g.numpy(), jg, rtol=1e-8, atol=1e-8 * scale)


def test_port_gp_predict_fast_grad_matches_jax():
    """models/gp.gp_predict (hand-VJP _NormMeanVar path and plain path) vs
    the JAX gp_predict in f64: values 1e-10, gradients 1e-8 (same
    formulas in float64)."""
    x, params, st, xq, w = _gp_problem(1, b=2, n=40, d=4, m=11)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)  # noqa: E731
    pst = GPState(params={k: t(v) for k, v in params.items()}, x=t(x),
                  y=t(st.y), chol=t(st.chol), alpha_vec=t(st.alpha_vec),
                  linv=t(st.linv), lml=t(st.lml))
    for fast in (False, True):
        xq_t = torch.tensor(xq, requires_grad=True)
        mean, var = gp_predict(pst, xq_t, fast_grad=fast)
        jmean, jvar = j_gp_predict(st, jnp.asarray(xq), config=JGPConfig(), fast_grad=fast)
        np.testing.assert_allclose(mean.detach().numpy(), np.asarray(jmean), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(var.detach().numpy(), np.asarray(jvar), rtol=1e-10, atol=1e-12)
        (g,) = torch.autograd.grad((mean * t(w[0])).sum() + (var * t(w[1])).sum(), xq_t)

        def jloss(q):
            mn, vr = j_gp_predict(st, q, config=JGPConfig(), fast_grad=fast)
            return jnp.sum(mn * w[0]) + jnp.sum(vr * w[1])

        jg = np.asarray(jax.grad(jloss)(jnp.asarray(xq)))
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-8, atol=1e-8 * np.abs(jg).max())


@pytest.fixture
def interpret_force(monkeypatch):
    monkeypatch.setattr(pp, "INTERPRET", True)
    monkeypatch.setattr(pp, "FORCE", True)


@pytest.mark.parametrize("jax_entry", ["fused_pc_predict", "fused_pc_predict_fastbwd"])
def test_fused_plain_f32_matches_jax_pallas(interpret_force, jax_entry):
    """Port float32 plain path vs the JAX Pallas kernels in interpret mode.

    Tolerances: values 2e-4 (the reference runs 3-pass bf16 products, as
    tests/test_pallas_predict.py:69 allows); gradients 3e-2 * scale (the
    fast backward's cotangent products are 1-pass bf16).  The factors are
    those of tests/test_pallas_predict.py's problem (O(1) alpha), for which
    those tolerances were set."""
    x, params, _, xq, w = _gp_problem(2)
    rng = np.random.default_rng(12)
    b, n = params["log_amp"].shape[0], x.shape[0]
    linv = np.tril(rng.normal(size=(b, n, n)) * 0.1) + np.eye(n)[None]
    alpha = rng.normal(size=(b, n))
    jfs = pp.attach_fused_factors(pp.build_fused_state(params, x), linv, alpha)
    t = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    fs = fp.build_fused_state({k: t(v) for k, v in params.items()}, t(x), t(linv), t(alpha))
    assert fs.G.dtype == torch.float32

    xq32 = xq.astype(np.float32)
    xq_t = torch.tensor(xq32, requires_grad=True)
    mean, qf = fp.fused_pc_predict(fs, xq_t)
    jfn = getattr(pp, jax_entry)
    jmean, jqf = jfn(jfs, jnp.asarray(xq32))
    np.testing.assert_allclose(mean.detach().numpy(), np.asarray(jmean), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(qf.detach().numpy(), np.asarray(jqf), rtol=2e-4, atol=2e-4)

    w32 = w.astype(np.float32)
    (g,) = torch.autograd.grad(
        (torch.sin(mean) * t(w32[0]).T).sum() + 1e-2 * (qf * t(w32[1]).T).sum(), xq_t)

    def jloss(q):
        mn, qq = jfn(jfs, q)
        return jnp.sum(jnp.sin(mn) * w32[0].T) + 1e-2 * jnp.sum(qq * w32[1].T)

    jg = np.asarray(jax.grad(jloss)(jnp.asarray(xq32)))
    scale = max(np.abs(jg).max(), 1.0)
    np.testing.assert_allclose(g.numpy(), jg, atol=3e-2 * scale)


def test_f32_mean_accuracy_on_real_factors(interpret_force):
    """On a real GP factor (alpha up to ~15) the port's FP32 forward keeps
    the mean within 5e-5 of a float64 evaluation of the same f32 factors,
    while the JAX Pallas kernel's bf16 3-pass products miss it by more
    than 2e-4 (measured 1.2e-5 vs 7.4e-4): the gap recorded in ROADMAP.md
    item 3, and why the comparison above uses O(1) factors."""
    x, params, st, xq, _ = _gp_problem(2)
    linv, alpha = np.asarray(st.linv), np.asarray(st.alpha_vec)
    t = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    fs = fp.build_fused_state({k: t(v) for k, v in params.items()}, t(x), t(linv), t(alpha))
    xq32 = xq.astype(np.float32)
    mean, _ = fp.fused_pc_predict(fs, torch.tensor(xq32))
    m64, _ = fp.fused_pc_predict(fp.state_as(fs, torch.float64),
                                 torch.tensor(xq32).double())
    jfs = pp.attach_fused_factors(pp.build_fused_state(params, x), linv, alpha)
    jmean, _ = pp.fused_pc_predict(jfs, jnp.asarray(xq32))
    port_err = np.abs(mean.numpy() - m64.numpy()).max()
    jax_err = np.abs(np.asarray(jmean) - m64.numpy()).max()
    assert port_err < 5e-5 and jax_err > 2e-4, (port_err, jax_err)


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 explicit mantissa bits), ties
    away from zero: what ``cvt.rna.tf32.f32`` gives the tensor cores."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_tf32(x):
    hi = _round_tf32(x)
    return hi, _round_tf32(x - hi)


def test_round_tf32_helper():
    """Round to nearest on the low 13 mantissa bits, ties away from zero,
    sign kept; TF32 values are fixed points."""
    u = 2.0 ** -10  # TF32 ulp at 1
    x = torch.tensor([1 + u / 2, 1 + u / 4, -(1 + u / 2), 1 + 3 * u / 4, 3.0, 0.0],
                     dtype=torch.float32)
    want = torch.tensor([1 + u, 1.0, -(1 + u), 1 + u, 3.0, 0.0], dtype=torch.float32)
    assert torch.equal(_round_tf32(x), want)
    y = _round_tf32(torch.randn(1000, generator=torch.Generator().manual_seed(0)))
    assert torch.equal(_round_tf32(y), y)
    assert torch.all(y.view(torch.int32) & 0x1FFF == 0)


def _real_factor_problem():
    """The real GP factor of test_f32_mean_accuracy_on_real_factors (alpha
    up to ~15), as the port's float32 state, its float64 copy, the JAX
    fused state and queries / cotangents."""
    x, params, st, xq, w = _gp_problem(2)
    linv, alpha = np.asarray(st.linv), np.asarray(st.alpha_vec)
    t = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    fs = fp.build_fused_state({k: t(v) for k, v in params.items()}, t(x), t(linv), t(alpha))
    fs64 = fp.state_as(fs, torch.float64)
    jfs = pp.attach_fused_factors(pp.build_fused_state(params, x), linv, alpha)
    return fs, fs64, jfs, xq.astype(np.float32), w.astype(np.float32)


def _normwise(a, ref):
    return float((a.double() - ref).abs().max() / ref.abs().max())


def test_3xtf32_forward_arithmetic_on_real_factors(interpret_force):
    """The forward kernel's arithmetic -- v = [G; alpha] k* as hi*hi + hi*lo
    + lo*hi of TF32 halves with FP32 sums -- on the real GP factor stays
    within 1e-4 normwise of a float64 evaluation in mean and qf (the check
    chip_smoke.py makes on the card), closer than the JAX Pallas kernel's
    bf16 3-pass mean; one TF32 pass on the same product misses 1e-4, so the
    tolerance tells the two apart."""
    fs, fs64, jfs, xq32, _ = _real_factor_problem()
    xq = torch.tensor(xq32)
    m64, q64, _ = fp.fused_fwd_plain(fs64, xq.double())
    _, _, kstar = fp._kstar_plain(fs, xq)
    n = fs.G.shape[1]
    gaug = torch.cat([fs.G, fs.alpha[:, None, :]], 1)
    (gh, gl), (kh, kl) = _split_tf32(gaug), _split_tf32(kstar)
    passes = {
        "3xtf32": torch.bmm(gl, kh) + torch.bmm(gh, kl) + torch.bmm(gh, kh),
        "1xtf32": torch.bmm(gh, kh),
    }
    err = {name: (_normwise(v[:, n], m64), _normwise((v[:, :n] ** 2).sum(1), q64))
           for name, v in passes.items()}
    jmean, _ = pp.fused_pc_predict(jfs, jnp.asarray(xq32))
    jax_err = _normwise(torch.tensor(np.asarray(jmean)).T, m64)
    assert max(err["3xtf32"]) <= 1e-4, err
    assert err["3xtf32"][0] < jax_err, (err, jax_err)
    assert max(err["1xtf32"]) > 1e-4, err


def test_tf32_backward_arithmetic_beats_jax_bf16(interpret_force):
    """The fast backward kernel's arithmetic -- one TF32 pass on G^T v, the
    2 ct_qf scaling, the alpha ct_mean term, ct_z and the query contraction
    in FP32 -- on the real GP factor is closer to the float64 gradient than
    the JAX fast backward's one bf16 pass (Pallas interpret mode), and well
    inside chip_smoke.py's 2e-3 normwise tolerance for the kernel."""
    fs, fs64, jfs, xq32, w32 = _real_factor_problem()
    xq = torch.tensor(xq32)
    ctm, ctq = torch.tensor(w32[0]), torch.tensor(w32[1])
    _, _, v64 = fp.fused_fwd_plain(fs64, xq.double(), save_v=True)
    g64 = fp.fused_bwd_plain(fs64, xq.double(), v64, ctm.double(), ctq.double()).sum(0)
    _, _, v = fp.fused_fwd_plain(fs, xq, save_v=True)
    qs, z, kstar = fp._kstar_plain(fs, xq)
    ct_k = (2.0 * ctq[:, None, :] * torch.bmm(_round_tf32(fs.G).transpose(1, 2), _round_tf32(v))
            + fs.alpha[:, :, None] * ctm[:, None, :])
    ct_z = torch.where(z < 0, kstar * ct_k, torch.zeros_like(kstar))
    ct_qs = torch.stack([(ct_z * (fs.xs[:, :, j, None] - qs[:, None, :, j])).sum(1)
                         for j in range(qs.shape[-1])], dim=-1)
    g_tf32 = (ct_qs * fs.inv_ls[:, None, :]).sum(0)

    def jloss(q):
        mn, qq = pp.fused_pc_predict_fastbwd(jfs, q)
        return jnp.sum(mn * w32[0].T) + jnp.sum(qq * w32[1].T)

    g_jax = torch.tensor(np.asarray(jax.grad(jloss)(jnp.asarray(xq32))))
    e_tf32, e_jax = _normwise(g_tf32, g64), _normwise(g_jax, g64)
    assert e_tf32 < e_jax and e_tf32 < 2e-3, (e_tf32, e_jax)


def _backward_with_product(fs, xq, ctm, ctq, gtv):
    """The backward kernels' FP32 arithmetic around a given G^T v product:
    the 2 ct_qf column scale, the alpha ct_mean term, ct_z under the z < 0
    mask and the difference-form query contraction, summed over the GPs."""
    qs, z, kstar = fp._kstar_plain(fs, xq)
    ct_k = 2.0 * ctq[:, None, :] * gtv + fs.alpha[:, :, None] * ctm[:, None, :]
    ct_z = torch.where(z < 0, kstar * ct_k, torch.zeros_like(kstar))
    ct_qs = torch.stack([(ct_z * (fs.xs[:, :, j, None] - qs[:, None, :, j])).sum(1)
                         for j in range(qs.shape[-1])], dim=-1)
    return (ct_qs * fs.inv_ls[:, None, :]).sum(0)


def test_3xtf32_backward_arithmetic_on_real_factors(interpret_force):
    """The full-precision backward kernel's arithmetic -- G^T v as hi*hi +
    hi*lo + lo*hi of TF32 halves with FP32 sums, the rest of the backward
    in FP32 -- on the real GP factor stays within 5e-5 normwise of the
    float64 gradient (chip_smoke.py's TOL_GRAD_HIGH for the kernel) and
    closer to it than the JAX 3-pass bf16 backward (_bwd_kernel, the
    gradient of fused_pc_predict in Pallas interpret mode); one TF32 pass
    on the same product misses 5e-5, so the tolerance tells the two
    apart."""
    fs, fs64, jfs, xq32, w32 = _real_factor_problem()
    xq = torch.tensor(xq32)
    ctm, ctq = torch.tensor(w32[0]), torch.tensor(w32[1])
    _, _, v64 = fp.fused_fwd_plain(fs64, xq.double(), save_v=True)
    g64 = fp.fused_bwd_plain(fs64, xq.double(), v64, ctm.double(), ctq.double()).sum(0)
    _, _, v = fp.fused_fwd_plain(fs, xq, save_v=True)
    (gh, gl), (vh, vl) = _split_tf32(fs.G.transpose(1, 2)), _split_tf32(v)
    products = {
        "3xtf32": torch.bmm(gl, vh) + torch.bmm(gh, vl) + torch.bmm(gh, vh),
        "1xtf32": torch.bmm(gh, vh),
    }
    err = {name: _normwise(_backward_with_product(fs, xq, ctm, ctq, p), g64)
           for name, p in products.items()}

    def jloss(q):
        mn, qq = pp.fused_pc_predict(jfs, q)
        return jnp.sum(mn * w32[0].T) + jnp.sum(qq * w32[1].T)

    g_jax = torch.tensor(np.asarray(jax.grad(jloss)(jnp.asarray(xq32))))
    e_jax = _normwise(g_jax, g64)
    assert err["3xtf32"] <= 5e-5 and err["3xtf32"] < e_jax, (err, e_jax)
    assert err["1xtf32"] > 5e-5, err


def test_plain_backward_matches_autograd_of_plain_forward():
    """The hand-written plain backward (the kernel's reference) equals
    autograd through the plain forward, f64 to 1e-10 (same arithmetic,
    different association)."""
    x, params, st, xq, w = _gp_problem(3, b=2, n=30, d=3, m=9)
    fs = _port_state_f64(x, params, st)
    xq_t = torch.tensor(xq, requires_grad=True)
    mean, qf, v = fp.fused_fwd_plain(fs, xq_t, save_v=True)
    ctm, ctq = torch.tensor(w[0]), torch.tensor(w[1])
    (g_auto,) = torch.autograd.grad((mean * ctm).sum() + (qf * ctq).sum(), xq_t)
    g_hand = fp.fused_bwd_plain(fs, xq_t.detach(), v.detach(), ctm, ctq).sum(0)
    np.testing.assert_allclose(g_hand.numpy(), g_auto.numpy(), rtol=1e-10,
                               atol=1e-10 * g_auto.abs().max().item())


def test_plain_path_counts_no_launches():
    """CPU tensors take the plain version; only kernel launches count."""
    x, params, st, xq, _ = _gp_problem(4, b=2, n=20, d=3, m=5)
    fs = _port_state_f64(x, params, st)
    registry.reset_launch_counts()
    for prec in ("default", "high"):
        xq_t = torch.tensor(xq, requires_grad=True)
        mean, qf = fp.fused_pc_predict(fs, xq_t, prec)
        (mean.sum() + qf.sum()).backward()
    names = {"fused_predict_fwd", "fused_predict_bwd", "fused_predict_bwd_high"}
    assert names <= set(registry.LAUNCH_COUNTS)
    assert all(v == 0 for v in registry.LAUNCH_COUNTS.values())
    assert set(registry.KERNELS) == set(registry.LAUNCH_COUNTS)
    assert registry.KERNELS["fused_predict_bwd_high"][1].endswith("pallas_predict.py:281")


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No compiler means an error, never a silent plain-path fallback."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    # the library name carries a digest of source + flags
    p1 = _build.lib_path("fused_predict")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.lib_path("fused_predict") != p1


def test_fused_eligibility():
    """The JAX signature (kind, d, dtype): RBF or Matern-1.5 (not
    MaternProd), float32 and d up to the kernels' DMAX (read from the
    source) only."""
    from gpbayestools_hic_tpu_torch.ops import _build

    src = (_build._PKG_DIR / _build.SOURCES["fused_predict"]).read_text()
    assert f"constexpr int DMAX = {fp.FUSED_MAX_DIM};" in src
    assert fp.FUSED_MAX_DIM == 32
    assert fp.fused_eligible("RBF", 17, torch.float32)
    assert fp.fused_eligible("RBF", 32, torch.float32)
    assert not fp.fused_eligible("RBF", 33, torch.float32)
    assert not fp.fused_eligible("RBF", 17, torch.float64)
    assert fp.fused_eligible("Matern", 17, torch.float32)
    assert not fp.fused_eligible("Matern", 33, torch.float32)
    assert not fp.fused_eligible("MaternProd", 17, torch.float32)


def test_grad_precision_selects_the_backward_kernel():
    """"default" -> the fast backward, "high"/"highest" -> the
    full-precision one (its own entry point and counter), anything else
    raises at call time, before any backward runs."""
    assert GPConfig().grad_precision == "default"
    assert fp.backward_kernel("default") == "fused_predict_bwd"
    assert fp.backward_kernel("high") == fp.backward_kernel("highest") == "fused_predict_bwd_high"
    x, params, st, xq, _ = _gp_problem(5, b=2, n=20, d=3, m=5)
    fs = _port_state_f64(x, params, st)
    with pytest.raises(ValueError, match="grad_precision"):
        fp.fused_pc_predict(fs, torch.tensor(xq), "low")
    with pytest.raises(ValueError, match="grad_precision"):
        fp.fused_bwd(fs, torch.tensor(xq), None, None, None, "bf16")
    src = (_build._PKG_DIR / _build.SOURCES["fused_predict"]).read_text()
    assert "int fused_predict_bwd_high(" in src and "bwd_high_kernel<2>" in src
    assert "bwd_high_kernel<1>" in src and "mma.sync" not in src
    assert "int fused_predict_bwd(" in src and "bwd_wgmma_kernel<2>" in src
    assert "bwd_wgmma_kernel<1>" in src and "bwd_fp32_kernel" not in src


def test_high_precision_gradient_matches_jax_pallas(interpret_force):
    """grad_precision="high" in the port against the JAX fused_pc_predict
    (its 3-pass backward, Pallas interpret mode) on O(1) factors: values
    2e-4 and the gradient 5e-4 * scale, the tolerances of
    tests/test_pallas_predict.py:69 and :105 for that kernel."""
    x, params, _, xq, w = _gp_problem(6)
    rng = np.random.default_rng(13)
    b, n = params["log_amp"].shape[0], x.shape[0]
    linv = np.tril(rng.normal(size=(b, n, n)) * 0.1) + np.eye(n)[None]
    alpha = rng.normal(size=(b, n))
    jfs = pp.attach_fused_factors(pp.build_fused_state(params, x), linv, alpha)
    t = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    fs = fp.build_fused_state({k: t(v) for k, v in params.items()}, t(x), t(linv), t(alpha))
    xq32, w32 = xq.astype(np.float32), w.astype(np.float32)
    grads = {}
    for prec in ("high", "default"):
        xq_t = torch.tensor(xq32, requires_grad=True)
        mean, qf = fp.fused_pc_predict(fs, xq_t, prec)
        (grads[prec],) = torch.autograd.grad(
            (torch.sin(mean) * t(w32[0]).T).sum() + 1e-2 * (qf * t(w32[1]).T).sum(), xq_t)
    jmean, jqf = pp.fused_pc_predict(jfs, jnp.asarray(xq32))
    np.testing.assert_allclose(mean.detach().numpy(), np.asarray(jmean), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(qf.detach().numpy(), np.asarray(jqf), rtol=2e-4, atol=2e-4)

    def jloss(q):
        mn, qq = pp.fused_pc_predict(jfs, q)
        return jnp.sum(jnp.sin(mn) * w32[0].T) + 1e-2 * jnp.sum(qq * w32[1].T)

    jg = np.asarray(jax.grad(jloss)(jnp.asarray(xq32)))
    scale = max(np.abs(jg).max(), 1.0)
    np.testing.assert_allclose(grads["high"].numpy(), jg, atol=5e-4 * scale)
    # on the CPU both settings take the plain (full-precision) backward
    assert torch.equal(grads["high"], grads["default"])


def test_predict_variant_edits_apply_to_the_source():
    """tools/torch_predict_variants.py times design alternatives of the
    kernels as text edits of csrc/fused_predict.cu's knobs (ring depths,
    promotion interval, where k* is split, tile widths, warpgroups per
    block); every edit must still apply exactly once, and the kept variant
    is the source itself."""
    import importlib.util

    path = _build._PKG_DIR.parent / "tools" / "torch_predict_variants.py"
    spec = importlib.util.spec_from_file_location("torch_predict_variants", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = (_build._PKG_DIR / _build.SOURCES["fused_predict"]).read_text()
    assert set(tool.VARIANTS) == {
        "kept", "fwd_stages_3", "bwd_stages_3", "promote_2", "promote_4", "promote_never",
        "split_in_memory",
        "tn_64", "kstar_128x64", "kstar_64x128", "kstar_32x64", "one_consumer",
        "two_consumers", "fwd_no_products", "bwd_no_products", "bwd_no_round",
        "bwd_no_contraction", "high_stages_3", "high_no_products", "high_no_split"}
    assert tool.variant_source(src, tool.VARIANTS["kept"]) == src
    for name, edits in tool.VARIANTS.items():
        assert tool.variant_source(src, edits) != src or name == "kept"


# -------------------- the Hopper kernels' layouts and arithmetic (emulated)


def test_kernel_factor_layout_and_sizes():
    """build_fused_state's kernel factor, (b, 4, n + 1, ld) with ld = n
    rounded up to 4 (the 16-byte row stride TMA needs): planes 0 + 1 are
    [G; alpha] split into two TF32 values (to 2^-22 of the largest), plane
    2 is G^T rounded to nearest TF32 and plane 3 the rest of G^T rounded to
    TF32 (the three-pass backward's lo half), both with a zero row n, and
    every padding column is zero.  The Python mirrors of the library's
    sizes agree with the source's constants and count what the kernels
    take."""
    for n in (1, 5, 50, 257):
        x, params, st, _, _ = _gp_problem(7, b=2, n=n, d=3, m=4)
        t = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
        fs = fp.build_fused_state({k: t(v) for k, v in params.items()}, t(x),
                                  t(st.linv), t(st.alpha_vec))
        ld = fp.factor_ld(n)
        assert ld % 4 == 0 and n <= ld < n + 4
        assert fs.kf.shape == (2, fp.FACTOR_PLANES, n + 1, ld) == (2, 4, n + 1, ld)
        assert fs.kf.is_contiguous()
        ga = torch.cat([fs.G, fs.alpha[:, None, :]], 1)
        hi, lo = fs.kf[:, 0, :, :n], fs.kf[:, 1, :, :n]
        for half in (hi, lo):
            assert torch.equal(_round_tf32(half), half)
        assert torch.equal(hi, _round_tf32(ga))
        assert float(((hi.double() + lo.double()) - ga.double()).abs().max()) <= (
            2.0 ** -21 * float(ga.abs().max()))
        gt = fs.G.transpose(1, 2)
        assert torch.equal(fs.kf[:, 2, :n, :n], _round_tf32(gt))
        assert torch.equal(fs.kf[:, 3, :n, :n], _round_tf32(gt - _round_tf32(gt)))
        assert float(((fs.kf[:, 2, :n, :n].double() + fs.kf[:, 3, :n, :n].double())
                      - gt.double()).abs().max()) <= 2.0 ** -21 * float(gt.abs().max())
        assert torch.count_nonzero(fs.kf[:, 2:, n]) == 0
        assert torch.count_nonzero(fs.kf[..., n:]) == 0
        assert torch.equal(fp.round_tf32(ga), _round_tf32(ga))
    src = (_build._PKG_DIR / _build.SOURCES["fused_predict"]).read_text()
    assert f"constexpr int TN = {fp.TILE_ROWS};" in src
    assert f"constexpr int FACTOR_PLANES = {fp.FACTOR_PLANES};" in src
    assert "constexpr bool SPLIT_IN_SMEM = true;" in src and fp.KST_PLANES == 1  # raw k*
    assert [fp.tile_pairs(r) for r in (1, 128, 129, 257, 1000, 1001)] == [1, 1, 1, 2, 4, 4]
    b, n, m, d = 4, 1000, 1024, 17
    assert fp.scratch_floats(0, b, n, m, d) == b * 4 * m
    assert fp.scratch_floats(1, b, n, m, d) == fp.scratch_floats(2, b, n, m, d) == b * 4 * m * d
    assert fp.scratch_floats(0, 1, 1, 1, 1) == 1


def test_kernel_layout_v_is_a_padded_view():
    """The forward kernel saves v as v^T in plane 0 of a (2, b, m, ld)
    buffer whose plane 1 holds the call's k*^T (the fast backward's k*),
    and hands out the (b, n, m) view of plane 0; kernel_layout_v makes that
    layout from a plain v (equal values, zeros in the padding, the plain
    k*), which the plain backward reads as it is."""
    x, params, st, xq, w = _gp_problem(8, b=2, n=30, d=3, m=7)
    fs = _port_state_f64(x, params, st)
    xq = torch.tensor(xq)
    _, _, v = fp.fused_fwd_plain(fs, xq, save_v=True)
    kv = fp.kernel_layout_v(fs, xq, v)
    ld = fp.factor_ld(30)
    assert kv.shape == v.shape and kv.stride() == (7 * ld, 1, ld) and torch.equal(kv, v)
    assert kv.untyped_storage().nbytes() == 2 * 2 * 7 * ld * 8
    buf = torch.as_strided(kv, (2, 2, 7, ld), (2 * 7 * ld, 7 * ld, ld, 1))
    assert torch.count_nonzero(buf[..., 30:]) == 0
    assert torch.equal(buf[1, :, :, :30], fp._kstar_plain(fs, xq)[2].mT)
    ctm, ctq = torch.tensor(w[0]), torch.tensor(w[1])
    assert torch.equal(fp.fused_bwd_plain(fs, xq, kv, ctm, ctq),
                       fp.fused_bwd_plain(fs, xq, v, ctm, ctq))


def _rz_f32(x64: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 rounded toward zero."""
    y = x64.to(torch.float32)
    return torch.where(y.double().abs() > x64.abs(), torch.nextafter(y, torch.zeros_like(y)), y)


def _wgmma_product(a_hi, a_lo, b_hi, b_lo, promote_steps):
    """(b, M, K) x (b, N, K)^T as the forward kernel runs it, both operands
    K-major: each 8-deep step's three TF32 products (lo*hi + hi*lo +
    hi*hi; products of TF32 values are exact in float64) chained into a
    float32 sum that is truncated toward zero (a model of the tensor cores'
    accumulation, which is not rounded to nearest), promoted into the FP32
    running sum every promote_steps steps."""
    k = a_hi.shape[-1]
    acc = torch.zeros(a_hi.shape[0], a_hi.shape[1], b_hi.shape[1], dtype=torch.float32)
    part = torch.zeros_like(acc)
    steps = -(-k // 8)
    for s in range(steps):
        sl = slice(8 * s, 8 * s + 8)

        def f64(x):
            return x[..., sl].double()

        step = (f64(a_lo) @ f64(b_hi).mT + f64(a_hi) @ f64(b_lo).mT) + f64(a_hi) @ f64(b_hi).mT
        part = _rz_f32(part.double() + step)
        if (s + 1) % promote_steps == 0 or s == steps - 1:
            acc, part = acc + part, torch.zeros_like(acc)
    return acc


#: 8-deep steps of the forward's promotion interval: one ring stage of 32
#: contraction steps (PROMOTE = 1)
PROMOTE_STEPS = 4


def _wgmma_forward(fs, xq, promote_steps=PROMOTE_STEPS):
    """mean, qf of the forward kernel's arithmetic in its layouts: k*^T
    (walkers x training rows) split into TF32 halves as the kernel splits a
    landed stage, [G; alpha] halves from the kernel factor, v^T = k*^T
    [G; alpha]^T."""
    n = fs.G.shape[1]
    _, _, kstar = fp._kstar_plain(fs, xq)
    kt = kstar.transpose(1, 2).contiguous()
    kh = fp.round_tf32(kt)
    vt = _wgmma_product(kh, fp.round_tf32(kt - kh), fs.kf[:, 0, :, :n], fs.kf[:, 1, :, :n],
                        promote_steps)
    return vt[..., n], (vt[..., :n] ** 2).sum(-1)


def test_wgmma_forward_arithmetic_on_real_factors(interpret_force):
    """The forward kernel's arithmetic in its new layouts (walkers on the M
    side, both operands K-major and split into TF32 halves, each stage's
    products promoted to FP32) on the real GP factor stays within 1e-4
    normwise of a float64 evaluation in mean and qf (chip_smoke.py's check
    on the card), and its mean is closer than the JAX Pallas kernel's bf16
    3-pass mean."""
    fs, fs64, jfs, xq32, _ = _real_factor_problem()
    xq = torch.tensor(xq32)
    m64, q64, _ = fp.fused_fwd_plain(fs64, xq.double())
    mean, qf = _wgmma_forward(fs, xq)
    jmean, _ = pp.fused_pc_predict(jfs, jnp.asarray(xq32))
    e_mean, e_qf = _normwise(mean, m64), _normwise(qf, q64)
    jax_err = _normwise(torch.tensor(np.asarray(jmean)).T, m64)
    assert max(e_mean, e_qf) <= 1e-4 and e_mean < jax_err, (e_mean, e_qf, jax_err)


def test_promotion_interval_of_one_stage():
    """The promotion interval the forward kernel takes (one ring stage, 32
    contraction steps, into a fresh sum) keeps a GP of n = 1000 with a
    large alpha (noise 1e-3) within 1e-4 normwise of float64 in the mean,
    under a model of the tensor cores' accumulation that truncates (4.0e-5;
    two stages 4.8e-5, eight 1.05e-4); the same products chained over the
    whole contraction miss 1e-4 (on the H100: 7.2e-5 against 4.6e-6 at the
    flagship, PERF.md), so the interval is what holds the tolerance."""
    rng = np.random.default_rng(3)
    b, n, d, m = 2, 1000, 5, 64
    x = torch.tensor(rng.uniform(0, 1, (n, d)))
    params = {"log_ls": torch.tensor(np.log(rng.uniform(0.3, 1.0, (b, d)))),
              "log_amp": torch.tensor(np.log(rng.uniform(0.5, 2.0, b))),
              "log_noise": torch.tensor(np.log(np.full(b, 1e-3)))}
    st = _port_finalize(params, x, torch.tensor(rng.normal(size=(b, n))))
    fs = fp.build_fused_state(params, x, st.linv, st.alpha_vec)
    xq = torch.tensor(rng.uniform(0, 1, (m, d)), dtype=torch.float32)
    m64, q64, _ = fp.fused_fwd_plain(fp.state_as(fs, torch.float64), xq.double())
    err = {}
    for name, steps in (("kernel", PROMOTE_STEPS), ("never", 10**9)):
        mean, qf = _wgmma_forward(fs, xq, steps)
        err[name] = (_normwise(mean, m64), _normwise(qf, q64))
    assert max(err["kernel"]) <= 1e-4 and err["never"][0] > 1e-4, err


def _port_finalize(params, x, y):
    from gpbayestools_hic_tpu_torch.models.gp import finalize_gp_state

    return finalize_gp_state(params, x, y, GPConfig())


def _truncate_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 by dropping the low 13 bits, as the tensor cores read
    a float32 operand that was not rounded."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("v_rounding", ["nearest", "truncated"])
def test_wgmma_backward_operands_on_real_factors(interpret_force, v_rounding):
    """The fast backward kernel's product in its new layouts, (G^T v)^T =
    v^T (G^T)^T with both operands K-major: G^T from the kernel factor
    (rounded to nearest TF32 once, in memory) and v^T as the forward saves
    it, rounded to nearest in shared memory ("nearest", what the kernel
    does) or left for the tensor cores to truncate ("truncated", the
    kernel without its rounding pass); one TF32 pass, the rest of the
    backward in FP32 (the 2 ct_qf scale a row scale of the walkers).
    Either way it is closer to the float64 gradient than the JAX fast
    backward's one bf16 pass and inside chip_smoke.py's 2e-3; the rounded
    operands are exactly those of test_tf32_backward_arithmetic_beats_jax_bf16."""
    fs, fs64, jfs, xq32, w32 = _real_factor_problem()
    xq = torch.tensor(xq32)
    ctm, ctq = torch.tensor(w32[0]), torch.tensor(w32[1])
    _, _, v64 = fp.fused_fwd_plain(fs64, xq.double(), save_v=True)
    g64 = fp.fused_bwd_plain(fs64, xq.double(), v64, ctm.double(), ctq.double()).sum(0)
    n = fs.G.shape[1]
    _, _, v = fp.fused_fwd_plain(fs, xq, save_v=True)
    kv = fp.kernel_layout_v(fs, xq, v)
    vt = kv.transpose(1, 2)                    # (b, m, n): the rows of the saved v^T
    vt = _round_tf32(vt) if v_rounding == "nearest" else _truncate_tf32(vt)
    gt = fs.kf[:, 2, :n, :n]                  # G^T, rounded to nearest TF32
    if v_rounding == "nearest":
        assert torch.equal(vt, _round_tf32(v).transpose(1, 2))
        assert torch.equal(gt, _round_tf32(fs.G).transpose(1, 2))
    prod_t = torch.bmm(vt.double(), gt.double().mT).float()   # (G^T v)^T, (b, m, n)
    g = _backward_with_product(fs, xq, ctm, ctq, prod_t.transpose(1, 2))

    def jloss(q):
        mn, qq = pp.fused_pc_predict_fastbwd(jfs, q)
        return jnp.sum(mn * w32[0].T) + jnp.sum(qq * w32[1].T)

    g_jax = torch.tensor(np.asarray(jax.grad(jloss)(jnp.asarray(xq32))))
    e, e_jax = _normwise(g, g64), _normwise(g_jax, g64)
    assert e < e_jax and e < 2e-3, (e, e_jax)


def _wgmma_high_backward(fs, xq, ctm, ctq, promote_steps=PROMOTE_STEPS):
    """The three-pass backward kernel's arithmetic in its layouts: v^T as
    the forward saves it, split into TF32 halves as the kernel splits a
    landed stage; G^T's halves from planes 2 and 3 of the kernel factor;
    (G^T v)^T = v^T (G^T)^T as the forward's product runs (three passes,
    each stage's products promoted to FP32); the rest of the backward in
    FP32, summed over the GPs."""
    n = fs.G.shape[1]
    _, _, v = fp.fused_fwd_plain(fs, xq, save_v=True)
    vt = fp.kernel_layout_v(fs, xq, v).transpose(1, 2)  # (b, m, n): the saved v^T rows
    vh = fp.round_tf32(vt)
    prod_t = _wgmma_product(vh, fp.round_tf32(vt - vh), fs.kf[:, 2, :n, :n],
                            fs.kf[:, 3, :n, :n], promote_steps)
    return _backward_with_product(fs, xq, ctm, ctq, prod_t.transpose(1, 2))


def test_wgmma_high_backward_arithmetic_on_real_factors(interpret_force):
    """The three-pass backward kernel's arithmetic in its new layouts (v^T
    split in shared memory, G^T's halves from the kernel factor, walkers on
    the M side, each stage's products promoted to FP32) on the real GP
    factor: within chip_smoke.py's 5e-5 of the float64 gradient, closer to
    it than the JAX Pallas _bwd_kernel (3-pass bf16, interpret mode), and
    not the fast backward's one-pass result, which misses 5e-5."""
    fs, fs64, jfs, xq32, w32 = _real_factor_problem()
    xq = torch.tensor(xq32)
    ctm, ctq = torch.tensor(w32[0]), torch.tensor(w32[1])
    _, _, v64 = fp.fused_fwd_plain(fs64, xq.double(), save_v=True)
    g64 = fp.fused_bwd_plain(fs64, xq.double(), v64, ctm.double(), ctq.double()).sum(0)
    g = _wgmma_high_backward(fs, xq, ctm, ctq)
    n = fs.G.shape[1]
    _, _, v = fp.fused_fwd_plain(fs, xq, save_v=True)
    fast_t = torch.bmm(_round_tf32(v).transpose(1, 2).double(),
                       fs.kf[:, 2, :n, :n].double().mT).float()
    g_fast = _backward_with_product(fs, xq, ctm, ctq, fast_t.transpose(1, 2))

    def jloss(q):
        mn, qq = pp.fused_pc_predict(jfs, q)
        return jnp.sum(mn * w32[0].T) + jnp.sum(qq * w32[1].T)

    g_jax = torch.tensor(np.asarray(jax.grad(jloss)(jnp.asarray(xq32))))
    e, e_jax, e_fast = _normwise(g, g64), _normwise(g_jax, g64), _normwise(g_fast, g64)
    assert e <= 5e-5 and e < e_jax, (e, e_jax)
    assert e_fast > 5e-5 and not torch.equal(g, g_fast), (e, e_fast)


def test_high_backward_promotion_interval_of_one_stage():
    """The three-pass backward's promotion interval (one ring stage of 32
    contraction steps, whatever m) keeps a GP of n = 1000 with a large
    alpha (noise 1e-3) within 5e-5 of the float64 gradient under a model
    of the tensor cores' accumulation that truncates."""
    rng = np.random.default_rng(3)
    b, n, d, m = 2, 1000, 5, 64
    x = torch.tensor(rng.uniform(0, 1, (n, d)))
    params = {"log_ls": torch.tensor(np.log(rng.uniform(0.3, 1.0, (b, d)))),
              "log_amp": torch.tensor(np.log(rng.uniform(0.5, 2.0, b))),
              "log_noise": torch.tensor(np.log(np.full(b, 1e-3)))}
    st = _port_finalize(params, x, torch.tensor(rng.normal(size=(b, n))))
    fs = fp.build_fused_state(params, x, st.linv, st.alpha_vec)
    xq = torch.tensor(rng.uniform(0, 1, (m, d)), dtype=torch.float32)
    ctm = torch.tensor(rng.normal(size=(b, m)), dtype=torch.float32)
    ctq = torch.tensor(rng.normal(size=(b, m)), dtype=torch.float32)
    fs64 = fp.state_as(fs, torch.float64)
    _, _, v64 = fp.fused_fwd_plain(fs64, xq.double(), save_v=True)
    g64 = fp.fused_bwd_plain(fs64, xq.double(), v64, ctm.double(), ctq.double()).sum(0)
    g = _wgmma_high_backward(fs, xq, ctm, ctq)
    assert _normwise(g, g64) <= 5e-5, _normwise(g, g64)
