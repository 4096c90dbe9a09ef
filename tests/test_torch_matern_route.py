"""PyTorch port: the Matern-1.5 family on the fused predict route.

A float32 emulator whose GPs use the ARD Matern-1.5 kernel (the BAND heads'
default) gets a fused state of kind "Matern" and takes the fused op as an
RBF emulator does; MaternProd keeps the plain ``gp_predict``.  The CPU
tests hold the Matern plain versions of the forward and both backwards
(which the CPU's fast-gradient route runs) against ``kernel_fn`` and
``gp_predict`` in float64, a query on a training point (r = 0) included,
and the query gradient against autograd of the plain predict; the route's
truth table per family; a PCSK Matern ``EmulatorBAND`` chain's Woodbury
posterior against the plain reference ``benchmark/reference/posterior_pcsk.py``;
and the RBF family's plain versions and chains bit for bit as they were.
The card tests (skipped without a CUDA device; the kernels have no CPU
mode) hold each Matern kernel against its plain version and float64 at the
PCSK cell's widest block (b 88, n 1095, d 20, m 4096) and at small m, with
its launches counted under its family.  The file imports neither JAX nor
the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_matern_route.py

Tolerances (normwise: largest absolute difference over the largest
magnitude of the reference), as for the RBF kernels: the forward against
its float32 plain version 5e-4 and against the float64 plain forward 1e-4;
the fast backward against the float64 plain backward 2e-3; the three-pass
backward 5e-5.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gpbayestools_hic_tpu_torch.models import emulator as emulator_mod
from gpbayestools_hic_tpu_torch.models.emulator import Emulator
from gpbayestools_hic_tpu_torch.models.gp import GPConfig, finalize_gp_state, gp_predict
from gpbayestools_hic_tpu_torch.ops import fused_predict as fp
from gpbayestools_hic_tpu_torch.ops.kernels import KernelConfig, kernel_fn, scaled_sqdist
from gpbayestools_hic_tpu_torch.ops.registry import LAUNCH_COUNTS

F64 = torch.float64


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _gp(kind, b=3, n=24, d=4, seed=0, dtype=F64, device="cpu", noise_diag=True):
    """A trained GP batch of family ``kind`` with power-of-two length scales
    (so that x / ls and x * (1 / ls) agree exactly and a query on a training
    point is at r = 0) and a per-design noise, and its fused state."""
    rng = np.random.default_rng(seed)
    opts = dict(dtype=dtype, device=device)
    x = torch.tensor(rng.uniform(0, 1, (n, d)), **opts)
    params = {"log_amp": torch.tensor(rng.uniform(-0.5, 0.5, b), **opts),
              "log_ls": torch.tensor(np.log(2.0) * rng.integers(-1, 2, (b, d)), **opts),
              "log_noise": torch.full((b,), -4.0, **opts)}
    y = torch.tensor(rng.normal(size=(b, n)), **opts)
    nd = torch.tensor(rng.uniform(0, 0.02, (b, n)), **opts) if noise_diag else None
    cfg = GPConfig(kernel=KernelConfig(kind), alpha=1e-6)
    st = finalize_gp_state(params, x, y, cfg, nd)
    return st, cfg, fp.build_fused_state(st.params, st.x, st.linv, st.alpha_vec, kind)


def _state64(st, kind):
    """The fused state of ``st`` in float64, from the trained factors."""
    ls = torch.exp(st.params["log_ls"])
    amp = torch.exp(st.params["log_amp"])
    return fp.FusedState(
        xs=st.x[None] / ls[:, None, :], G=torch.tril(st.linv), alpha=st.alpha_vec, amp=amp,
        inv_ls=1.0 / ls, kdiag=amp + torch.exp(st.params["log_noise"]), kind=kind)


def _queries(st, m, seed=1):
    """m random queries, the first two on training points (r = 0)."""
    rng = np.random.default_rng(seed)
    q = torch.tensor(rng.uniform(0, 1, (m, st.x.shape[1])), dtype=st.x.dtype)
    q[0], q[1] = st.x[0], st.x[5]
    return q


def test_matern_kstar_is_kernel_fn():
    st, cfg, _ = _gp("Matern")
    fs = _state64(st, "Matern")
    xq = _queries(st, 9)
    _, _, kstar = fp._kstar_plain(fs, xq)
    want = kernel_fn(st.params, st.x, xq, config=cfg.kernel, include_noise=False)
    torch.testing.assert_close(kstar, want, rtol=1e-13, atol=1e-15)
    # at r = 0, k* = amp exactly
    assert torch.equal(kstar[:, 0, 0], fs.amp)


def test_matern_plain_forward_matches_gp_predict_in_float64():
    st, cfg, _ = _gp("Matern")
    fs = _state64(st, "Matern")
    xq = _queries(st, 11)
    mean, qf, _ = fp.fused_fwd_plain(fs, xq)
    gm, gv = gp_predict(st, xq, config=cfg)
    torch.testing.assert_close(mean, gm, rtol=1e-11, atol=1e-12)
    torch.testing.assert_close(torch.clamp(fs.kdiag[:, None] - qf, min=0.0), gv,
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("fast_grad", [False, True])
def test_matern_plain_backward_matches_autograd(fast_grad):
    """The hand-written backward's query cotangent against autograd of the
    plain predict (``gp_predict``, both of its routes), r = 0 included."""
    st, cfg, _ = _gp("Matern", seed=2)
    fs = _state64(st, "Matern")
    xq = _queries(st, 10)
    rng = np.random.default_rng(4)
    ctm, ctq = (torch.tensor(rng.normal(size=(3, 10)), dtype=F64) for _ in range(2))
    xr = xq.clone().requires_grad_(True)
    gm, gv = gp_predict(st, xr, config=cfg, fast_grad=fast_grad)
    # var = kdiag - qf (never clipped here): d/dqf = -d/dvar
    (want,) = torch.autograd.grad((gm * ctm).sum() - (gv * ctq).sum(), xr)
    _, _, v = fp.fused_fwd_plain(fs, xq, save_v=True)
    got = fp.fused_bwd_plain(fs, xq, v, ctm, ctq).sum(0)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-10)


def test_matern_fused_op_gradient_on_the_cpu():
    """``fused_pc_predict`` on the CPU (the fast-gradient route there): its
    values and reverse-mode gradient equal the plain predict's in float64."""
    st, cfg, _ = _gp("Matern", seed=3)
    fs = _state64(st, "Matern")
    xq = _queries(st, 6).requires_grad_(True)
    mean, qf = fp.fused_pc_predict(fs, xq)
    (g,) = torch.autograd.grad(mean.sum() + qf.sum(), xq)
    x2 = xq.detach().clone().requires_grad_(True)
    gm, gv = gp_predict(st, x2, config=cfg)
    (want,) = torch.autograd.grad(gm.sum() - gv.sum(), x2)
    torch.testing.assert_close(mean.T, gm, rtol=1e-11, atol=1e-12)
    torch.testing.assert_close(g, want, rtol=1e-9, atol=1e-10)


def test_matern_kernel_layout_v_holds_the_weight():
    """A Matern v in the kernels' layout: v^T, k*^T, then the weight
    3 amp e^-s that the backwards read in place of k*."""
    st, _, fs = _gp("Matern", dtype=torch.float32)
    xq = _queries(st, 5)
    _, _, v = fp.fused_fwd_plain(fs, xq, save_v=True)
    kv = fp.kernel_layout_v(fs, xq, v)
    buf = kv.untyped_storage()
    n, ld = st.x.shape[0], fp.factor_ld(st.x.shape[0])
    full = torch.empty(0, dtype=torch.float32).set_(buf).view(fp.saved_planes("Matern"), 3, 5, ld)
    assert fp.saved_planes("Matern") == 3 and fp.saved_planes("RBF") == 2
    assert fp.weight_plane("Matern") == 2 and fp.weight_plane("RBF") == 1
    _, z, kstar = fp._kstar_plain(fs, xq)
    assert torch.equal(full[1, :, :, :n], kstar.mT)
    s = torch.sqrt(3.0 * scaled_sqdist(fs.xs, xq[None] * fs.inv_ls[:, None, :]))
    torch.testing.assert_close(full[2, :, :, :n], (3.0 * fs.amp[:, None, None]
                                                   * torch.exp(-s)).mT, rtol=1e-6, atol=0.0)
    assert torch.equal(fp.fused_bwd_plain(fs, xq, kv, *torch.ones(2, 3, 5)),
                       fp.fused_bwd_plain(fs, xq, v, *torch.ones(2, 3, 5)))


def test_state_as_keeps_the_family():
    _, _, fs = _gp("Matern", dtype=torch.float32)
    f64 = fp.state_as(fs, F64)
    assert f64.kind == "Matern" and all(getattr(f64, f).dtype == F64 for f in fp.TENSOR_FIELDS)
    with pytest.raises(ValueError, match="MaternProd"):
        fp.build_fused_state({}, None, None, None, "MaternProd")


def _band_head(tmp_path, kind, dtype=torch.float32):
    """A PCSK ``EmulatorBAND`` with kernel ``kind`` on 30 design points in
    3 dimensions, loaded by the known-hyperparameter path."""
    from gpbayestools_hic_tpu_torch.models.emulator_band import EmulatorBAND
    from gpbayestools_hic_tpu_torch.utils.synthetic import (
        write_parameter_file, write_training_pickle)

    rng = np.random.default_rng(9)
    design = rng.uniform(0, 1, (30, 3))
    out = 2.0 + np.sin(design @ rng.uniform(0.5, 2.0, (3, 5)))
    pkl = write_training_pickle(str(tmp_path / f"{kind}.pkl"), design, out, 0.01 * out)
    par = write_parameter_file(str(tmp_path / "pars.txt"), 3)
    e = EmulatorBAND(pkl, par, method="PCSK", kernel_kind=kind, gp_maxiter=0, device="cpu",
                     dtype=dtype)
    x, z_t, _, nd = e._prepare_training(np.ones(e.nev, dtype=bool), kind)
    k = z_t.shape[0]
    params = {"log_amp": torch.zeros(k, dtype=dtype), "log_ls": torch.zeros(k, 3, dtype=dtype),
              "log_noise": torch.full((k,), -4.0, dtype=dtype)}
    e._finalize_training(finalize_gp_state(params, x, z_t, e.gp_config, nd))
    return e


@pytest.mark.parametrize("kind", ["RBF", "Matern", "MaternProd"])
@pytest.mark.parametrize("on_cuda", [False, True])
@pytest.mark.parametrize("fast_grad", [False, True])
def test_route_truth_table_by_family(tmp_path, monkeypatch, kind, on_cuda, fast_grad):
    """A float32 head of either fused family gets a fused state of its kind
    and takes the fused op when ``fast_grad`` is set or its queries are on
    the card (no derivative taken); a MaternProd head never does."""
    e = _band_head(tmp_path, kind)
    fused = kind in ("RBF", "Matern")
    assert (e._fused is not None) is fused
    if fused:
        assert e._fused.kind == kind
    monkeypatch.setattr(emulator_mod, "records_derivative", lambda x: False)
    x = SimpleNamespace(is_cuda=on_cuda)
    assert Emulator._takes_fused(e, x, fast_grad) is (fused and (fast_grad or on_cuda))


def test_float64_heads_keep_the_plain_route(tmp_path):
    assert _band_head(tmp_path, "Matern", F64)._fused is None


def test_matern_head_fast_grad_takes_the_fused_plain_version(tmp_path, monkeypatch):
    """On the CPU a Matern head's fast-gradient predict runs the fused op's
    plain version (never ``gp_predict``), and agrees with ``gp_predict``."""
    e = _band_head(tmp_path, "Matern")
    x = torch.tensor(np.random.default_rng(2).uniform(0, 1, (7, 3)), dtype=torch.float32)
    pm, pv = e.predict_pc_raw(x)
    monkeypatch.setattr(emulator_mod, "gp_predict", None)
    fm_, fv = e.predict_pc_raw_fastgrad(x)
    assert float((fm_ - pm).abs().max()) <= 2e-5 * float(pm.abs().max())
    assert float((fv - pv).abs().max()) <= 2e-5 * float(pv.abs().max())


def _tiny_pcsk():
    from benchmark.harness.calls import sub_seed
    from benchmark.harness.problem import make_problem
    from benchmark.tests.test_bench_pcsk import tiny_pcsk_spec

    cfg = tiny_pcsk_spec()["config"]
    return cfg, make_problem(cfg, sub_seed(2**31 + 7, 0))


def test_pcsk_matern_woodbury_posterior_matches_the_reference(tmp_path):
    """A float32 chain over PCSK Matern heads (fused route: the plain
    versions on the CPU) against the float64 plain reference: log posterior
    and its gradient in the HMC coordinates."""
    from benchmark.harness.problem_pcsk import build_pcsk_chain
    from benchmark.reference.posterior_pcsk import PosteriorPCSK, evaluate_u
    from gpbayestools_hic_tpu_torch.samplers.hmc import make_value_and_grad

    cfg, problem = _tiny_pcsk()
    chain = build_pcsk_chain(problem, cfg, str(tmp_path), torch.device("cpu"), "auto")
    assert all(e._fused is not None and e._fused.kind == "Matern" for e in chain.emuList)
    fn, state = chain.posterior_with_state()
    d = cfg["ndim"]
    rng = np.random.default_rng(5)
    tf = {"mu": torch.tensor(rng.normal(size=d) * 0.3, dtype=torch.float32),
          "chol": torch.eye(d) * 0.7, "lo": torch.zeros(d), "width": torch.ones(d)}
    u = torch.tensor(rng.normal(size=(32, d)), dtype=torch.float32)
    _, lp_x, g = make_value_and_grad(fn, state, tf, True)(u)
    _, r_x, r_g = evaluate_u(PosteriorPCSK(problem, cfg), u.double(), tf["mu"].double(),
                             tf["chol"].double(), rows=16)
    assert np.all(np.isfinite(r_x))
    np.testing.assert_allclose(lp_x.double().numpy(), r_x, rtol=0, atol=2e-3)
    scale = max(np.median(np.linalg.norm(r_g, axis=1)), 1e-12)
    assert np.max(np.linalg.norm(g.double().numpy() - r_g, axis=1)) <= 1e-3 * scale


# ---------------------------------------------------- RBF bit for bit as before


def _parent_kstar_plain(fs, xq):
    qs = xq[None, :, :] * fs.inv_ls[:, None, :]
    z = -0.5 * scaled_sqdist(fs.xs, qs)
    kstar = fs.amp[:, None, None] * torch.exp(torch.clamp(z, max=0.0))
    return qs, z, kstar


def _parent_fwd_plain(fs, xq, save_v=False):
    _, _, kstar = _parent_kstar_plain(fs, xq)
    v = torch.bmm(fs.G, kstar)
    mean = torch.einsum("bn,bnm->bm", fs.alpha, kstar)
    qf = (v * v).sum(1)
    return mean, qf, (v if save_v else None)


def _parent_bwd_plain(fs, xq, v, ct_mean, ct_qf):
    qs, z, kstar = _parent_kstar_plain(fs, xq)
    ct_v = 2.0 * v * ct_qf[:, None, :]
    ct_k = torch.bmm(fs.G.transpose(1, 2), ct_v) + fs.alpha[:, :, None] * ct_mean[:, None, :]
    ct_z = torch.where(z < 0, kstar * ct_k, torch.zeros_like(kstar))
    ct_qs = torch.stack([(ct_z * (fs.xs[:, :, j, None] - qs[:, None, :, j])).sum(1)
                         for j in range(qs.shape[-1])], dim=-1)
    return ct_qs * fs.inv_ls[:, None, :]


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_rbf_plain_versions_bit_for_bit(dtype):
    """The RBF family's plain forward and backward are the parent's, op for
    op (the parent's code copied above)."""
    st, _, fs = _gp("RBF", dtype=torch.float32)
    fs = fp.state_as(fs, dtype)
    assert fs.kind == "RBF"
    xq = _queries(st, 9).to(dtype)
    got, want = fp.fused_fwd_plain(fs, xq, save_v=True), _parent_fwd_plain(fs, xq, save_v=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    rng = np.random.default_rng(6)
    ctm, ctq = (torch.tensor(rng.normal(size=(3, 9)), dtype=dtype) for _ in range(2))
    assert torch.equal(fp.fused_bwd_plain(fs, xq, got[2], ctm, ctq),
                       _parent_bwd_plain(fs, xq, got[2], ctm, ctq))
    kv = fp.kernel_layout_v(fs, xq, got[2])
    assert kv.untyped_storage().nbytes() == 2 * 3 * 9 * fp.factor_ld(24) * kv.element_size()


def test_rbf_chain_bit_for_bit(tmp_path, monkeypatch):
    """The flagship-shaped RBF chain (the benchmark's tiny bes-hmc problem,
    float32 on the CPU: the fused op's plain versions): log posterior and
    gradient equal those of the same chain on the parent's plain versions."""
    from benchmark.harness.calls import sub_seed
    from benchmark.harness.problem import build_chain, make_problem
    from benchmark.tests.conftest import tiny_spec
    from gpbayestools_hic_tpu_torch.samplers.hmc import make_value_and_grad

    cfg = tiny_spec("bes-hmc")["config"]
    chain = build_chain(make_problem(cfg, sub_seed(2**31 + 9, 0)), cfg, str(tmp_path),
                        torch.device("cpu"), "auto")
    fn, state = chain.posterior_with_state()
    d = cfg["ndim"]
    tf = {"mu": torch.zeros(d), "chol": torch.eye(d), "lo": torch.zeros(d),
          "width": torch.ones(d)}
    u = torch.tensor(np.random.default_rng(8).normal(size=(16, d)), dtype=torch.float32)
    now = make_value_and_grad(fn, state, tf, True)(u)
    monkeypatch.setattr(fp, "fused_fwd_plain", _parent_fwd_plain)
    monkeypatch.setattr(fp, "fused_bwd_plain", _parent_bwd_plain)
    before = make_value_and_grad(fn, state, tf, True)(u)
    assert all(torch.equal(a, b) for a, b in zip(now, before))


# ------------------------------------------------------------------ the card


def _card_case(dev, b, n, d, m, seed=11):
    st, _, fs = _gp("Matern", b=b, n=n, d=d, seed=seed, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=dev)
    xq = torch.tensor(rng.uniform(0, 1, (m, d)), **f32)
    xq[0] = st.x[0]
    ctm, ctq = (torch.tensor(rng.normal(size=(b, m)), **f32) for _ in range(2))
    return fs, xq, ctm, ctq


def _rel(a, b):
    return (a.double() - b.double()).abs().max().item() / b.double().abs().max().item()


@pytest.mark.parametrize("b,n,d,m", [(88, 1095, 20, 4096), (88, 1095, 20, 37), (24, 1095, 20, 256),
                                     (11, 300, 20, 1)])
def test_cuda_matern_kernels_match_plain_and_float64(cuda_device, b, n, d, m):
    fs, xq, ctm, ctq = _card_case(cuda_device, b, n, d, m)
    fs64 = fp.state_as(fs, F64)
    before = dict(LAUNCH_COUNTS)
    mk, qk, vk = fp.fused_fwd(fs, xq, save_v=True)
    mp, qp, vp = fp.fused_fwd_plain(fs, xq, save_v=True)
    m64, q64, v64 = fp.fused_fwd_plain(fs64, xq.double(), save_v=True)
    assert max(_rel(mk, mp), _rel(qk, qp), _rel(vk, vp)) <= 5e-4
    assert max(_rel(mk, m64), _rel(qk, q64)) <= 1e-4
    g64 = fp.fused_bwd_plain(fs64, xq.double(), v64, ctm.double(), ctq.double()).sum(0)
    g = fp.fused_bwd(fs, xq, vk, ctm, ctq).sum(0)
    gh = fp.fused_bwd(fs, xq, vk, ctm, ctq, "high").sum(0)
    assert torch.isfinite(g).all() and torch.isfinite(gh).all()
    assert _rel(g, g64) <= 2e-3 and _rel(gh, g64) <= 5e-5
    assert not torch.equal(g, gh)
    after = dict(LAUNCH_COUNTS)
    for name in ("fused_predict_fwd_matern", "fused_predict_bwd_matern",
                 "fused_predict_bwd_high_matern"):
        assert after[name] == before[name] + 1, name
    for name in ("fused_predict_fwd", "fused_predict_bwd", "fused_predict_bwd_high"):
        assert after[name] == before[name], name


def test_cuda_a_forward_without_backward_writes_no_weight(cuda_device):
    """Without a gradient the Matern forward keeps k*^T alone (values equal
    to the saving call's)."""
    fs, xq, _, _ = _card_case(cuda_device, 4, 200, 20, 100)
    m1, q1, v = fp.fused_fwd(fs, xq)
    m2, q2, _ = fp.fused_fwd(fs, xq, save_v=True)
    assert v is None and torch.equal(m1, m2) and torch.equal(q1, q2)


def test_cuda_a_backward_given_a_short_buffer_raises(cuda_device):
    """A Matern backward needs the three-plane buffer: an RBF-shaped one is
    refused before any launch."""
    fs, xq, ctm, ctq = _card_case(cuda_device, 4, 200, 20, 64)
    _, _, v = fp.fused_fwd(fs._replace(kind="RBF"), xq, save_v=True)
    with pytest.raises(ValueError, match="saved v"):
        fp.fused_bwd(fs, xq, v, ctm, ctq)


def test_cuda_pcsk_chain_launches_the_matern_kernels(cuda_device, tmp_path):
    """The tiny PCSK chain on the card: one Matern forward and one fast
    Matern backward per block a value-and-gradient call, no RBF launch, and
    the log posterior within 0.005 of the float64 reference."""
    from benchmark.harness.problem_pcsk import build_pcsk_chain
    from benchmark.reference.posterior_pcsk import PosteriorPCSK, evaluate

    cfg, problem = _tiny_pcsk()
    chain = build_pcsk_chain(problem, cfg, str(tmp_path), cuda_device, "auto")
    x = torch.tensor(np.random.default_rng(1).uniform(0.05, 0.95, (64, cfg["ndim"])),
                     dtype=torch.float32, device=cuda_device, requires_grad=True)
    fn, state = chain.posterior_with_state()
    before = dict(LAUNCH_COUNTS)
    with torch.enable_grad():
        lp = fn(state, x)
        lp.sum().backward()
    torch.cuda.synchronize()
    after = dict(LAUNCH_COUNTS)
    nb = len(cfg["blocks"])
    assert after["fused_predict_fwd_matern"] - before["fused_predict_fwd_matern"] == nb
    assert after["fused_predict_bwd_matern"] - before["fused_predict_bwd_matern"] == nb
    assert after["fused_predict_fwd"] == before["fused_predict_fwd"]
    ref = evaluate(PosteriorPCSK(problem, cfg), x.detach().double().cpu(), rows=32)
    assert np.max(np.abs(lp.detach().double().cpu().numpy() - ref)) <= 5e-3
