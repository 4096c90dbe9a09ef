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
    m64, _ = fp.fused_pc_predict(fp.FusedState(*(a.double() for a in fs)),
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
    fs64 = fp.FusedState(*(a.double() for a in fs))
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
    """The JAX signature (kind, d, dtype): RBF, float32 and d up to the
    kernels' DMAX (read from the source) only."""
    from gpbayestools_hic_tpu_torch.ops import _build

    src = (_build._PKG_DIR / _build.SOURCES["fused_predict"]).read_text()
    assert f"constexpr int DMAX = {fp.FUSED_MAX_DIM};" in src
    assert fp.FUSED_MAX_DIM == 32
    assert fp.fused_eligible("RBF", 17, torch.float32)
    assert fp.fused_eligible("RBF", 32, torch.float32)
    assert not fp.fused_eligible("RBF", 33, torch.float32)
    assert not fp.fused_eligible("RBF", 17, torch.float64)
    assert not fp.fused_eligible("Matern", 17, torch.float32)


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
    assert "int fused_predict_bwd_high(" in src and "launch_bwd<3>(" in src
    assert "int fused_predict_bwd(" in src and "launch_bwd<1>(" in src
    assert "bwd_tc_kernel<true, kPasses>" in src and "bwd_fp32_kernel" not in src


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
    forward kernel as text edits of csrc/fused_predict.cu; every edit must
    still apply exactly once, and the kept variant is the source itself."""
    import importlib.util

    path = _build._PKG_DIR.parent / "tools" / "torch_predict_variants.py"
    spec = importlib.util.spec_from_file_location("torch_predict_variants", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = (_build._PKG_DIR / _build.SOURCES["fused_predict"]).read_text()
    assert set(tool.VARIANTS) == {"kept", "g_split_in_memory", "cvt_rounding", "no_promotion",
                                  "rows_1_at_a_time", "rows_16_at_a_time", "no_copies",
                                  "no_products", "high_one_block_per_sm"}
    assert tool.variant_source(src, tool.VARIANTS["kept"]) == src
    for name, edits in tool.VARIANTS.items():
        assert tool.variant_source(src, edits) != src or name == "kept"
