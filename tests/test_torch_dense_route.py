"""PyTorch port: the route of the GP predict inside ``Emulator``.

``Emulator._takes_fused`` sends a predict to the fused op when the emulator
has a fused state (float32 RBF) and either the caller asked for the fast
gradient or the queries are on the card with no derivative taken of them;
everything else runs ``gp_predict``.  The CPU tests hold the truth table
and keep every CPU predict bit for bit on the plain assembly.  The card
tests (skipped without a CUDA device) hold the dense likelihoods' predict
on the fused forward against the plain route and float64, count its
launches, keep a differentiating caller on the plain route bit for bit,
and hold the ``generic`` and ``stitched`` log posteriors to the float64
oracle.  The file imports neither JAX nor the JAX package, so on a
machine with only PyTorch it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_dense_route.py

Tolerances (normwise: largest absolute difference over the largest
magnitude of the reference): fused against plain route 1e-5 in mean and
covariance; against the plain forward in float64 1e-4 in the PC mean and
in the variance's quadratic form (the forward kernel's contract); the
log posterior within 0.005 of the float64 oracle.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from gpbayestools_hic_tpu_torch.models import emulator as emulator_mod
from gpbayestools_hic_tpu_torch.models.emulator import Emulator, records_derivative
from gpbayestools_hic_tpu_torch.models.gp import gp_predict
from gpbayestools_hic_tpu_torch.ops import fused_predict as fp
from gpbayestools_hic_tpu_torch.ops.registry import LAUNCH_COUNTS, reset_launch_counts
from gpbayestools_hic_tpu_torch.utils.synthetic import (
    write_parameter_file, write_training_pickle)

#: the flagship's nine emulator blocks (observables each)
BLOCKS = (28, 28, 12, 170, 14, 21, 28, 73, 170)


def _plain_assembly(e, x, extra_std):
    """``_predict_full`` as it was before the route existed: ``gp_predict``
    and the PC-to-observable assembly, op for op."""
    x = e._transform_x(x)
    gp_mean, gp_var = gp_predict(e.gp_state, x, config=e.gp_config)
    gp_mean = gp_mean.T
    gp_var = gp_var.T + extra_std[:, None] ** 2
    if e.perform_no_PCA_:
        mean = gp_mean * e._scaler_scale + e._scaler_mean
        cov = torch.diag_embed(gp_var * e._scaler_scale**2)
    else:
        mean = gp_mean @ e._trans_t + e._scaler_mean
        cov = (gp_var @ e._var_trans_t).reshape(-1, e.nobs, e.nobs)
        cov = cov + e._cov_trunc_t
    if e.exp_and_cov_diagonal_:
        mean = torch.exp(mean)
        fstd = torch.sqrt(torch.diagonal(cov, dim1=1, dim2=2))
        cov = torch.diag_embed((fstd * mean) ** 2)
    return mean, cov


def _rel(a, b):
    return (a - b).abs().max().item() / b.abs().max().item()


# ------------------------------------------------------------------ CPU


@pytest.mark.parametrize("has_fused", [True, False])
@pytest.mark.parametrize("on_cuda", [True, False])
@pytest.mark.parametrize("fast_grad", [True, False])
@pytest.mark.parametrize("derivative", [True, False])
def test_route_truth_table(monkeypatch, has_fused, on_cuda, fast_grad, derivative):
    """The fused op exactly when the emulator has a fused state and either
    ``fast_grad`` is set or the queries are on the card and no derivative
    of them is taken."""
    monkeypatch.setattr(emulator_mod, "records_derivative", lambda x: x.derivative)
    emu = SimpleNamespace(_fused=object() if has_fused else None)
    x = SimpleNamespace(is_cuda=on_cuda, derivative=derivative)
    expect = has_fused and (fast_grad or (on_cuda and not derivative))
    assert Emulator._takes_fused(emu, x, fast_grad) is expect


def _under_jacfwd(x):
    seen = []
    torch.func.jacfwd(lambda t: seen.append(records_derivative(t)) or t * 2)(x)
    return seen[0]


def _under_vmap(x):
    seen = []
    torch.func.vmap(lambda t: seen.append(records_derivative(t)) or t * 2)(x[None])
    return seen[0]


def _dual(x):
    with fwAD.dual_level():
        return records_derivative(fwAD.make_dual(x, torch.ones_like(x)))


def _no_grad(x):
    with torch.no_grad():
        return records_derivative(x.requires_grad_(True))


@pytest.mark.parametrize("case,expect", [
    (lambda x: records_derivative(x), False),
    (lambda x: records_derivative(x.requires_grad_(True)), True),
    (_no_grad, False),
    (lambda x: records_derivative(x.requires_grad_(True) * 2), True),
    (_under_jacfwd, True),
    (_under_vmap, True),
    (_dual, True),
], ids=["plain", "requires_grad", "no_grad", "derived", "jacfwd", "vmap", "forward_ad"])
def test_records_derivative(case, expect):
    """Reverse mode under grad, forward mode and ``torch.func`` transforms
    count as a derivative taken; a tensor under ``no_grad`` does not."""
    assert case(torch.rand(3)) is expect


@pytest.fixture(scope="module")
def toy_emulators(tmp_path_factory):
    """A float32 (fused state) and a float64 (none) emulator of one toy
    problem on the CPU: 60 events, d = 4, 7 observables, 3 PCs."""
    tmp = tmp_path_factory.mktemp("route")
    rng = np.random.default_rng(3)
    d, nev, nobs = 4, 60, 7
    design = rng.uniform(0, 1, size=(nev, d))
    base = 2.0 + np.sin(design @ rng.uniform(0.5, 2.0, size=(d, nobs)))
    pkl = write_training_pickle(str(tmp / "train.pkl"), design, base, 0.01 * np.abs(base))
    par = write_parameter_file(str(tmp / "pars.txt"), d)
    emus = {}
    for dtype in (torch.float32, torch.float64):
        e = Emulator(pkl, par, npc=3, gp_maxiter=0, device="cpu", dtype=dtype)
        e.trainEmulator(np.ones(nev, dtype=bool))
        emus[dtype] = e
    assert emus[torch.float32]._fused is not None and emus[torch.float64]._fused is None
    return emus


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "requires_grad"])
def test_cpu_predict_full_is_the_plain_assembly_bit_for_bit(toy_emulators, monkeypatch,
                                                            dtype, grad):
    """On the CPU ``_predict_full`` runs ``gp_predict`` whatever the dtype
    and gradient, and equals the plain assembly bit for bit."""
    e = toy_emulators[dtype]

    def refuse(*args, **kwargs):
        raise AssertionError("the fused op ran on the CPU dense route")

    monkeypatch.setattr(emulator_mod, "fused_pc_predict", refuse)
    x = torch.rand((9, 4), dtype=dtype, generator=torch.Generator().manual_seed(1))
    extra = torch.linspace(0.0, 0.1, 9, dtype=dtype)
    x.requires_grad_(grad)
    with torch.set_grad_enabled(grad):
        mean, cov = e._predict_full(x, extra)
        ref_mean, ref_cov = _plain_assembly(e, x, extra)
    assert torch.equal(mean, ref_mean) and torch.equal(cov, ref_cov)
    with torch.set_grad_enabled(grad):
        mean_d, var_d = e.predict_diag(x)
        gp_var = gp_predict(e.gp_state, x, config=e.gp_config)[1].T
    assert torch.equal(mean_d, ref_mean)
    assert torch.equal(var_d, gp_var @ (e._trans_t**2) + e._cov_trunc_diag_t)
    if grad:
        (g,) = torch.autograd.grad(mean.sum() + cov.sum(), x)
        assert torch.isfinite(g).all()


def test_cpu_fast_grad_keeps_the_fused_op(toy_emulators, monkeypatch):
    """``fast_grad`` on a float32 emulator keeps today's route on the CPU:
    the fused op (its plain version here)."""
    e = toy_emulators[torch.float32]
    seen = []
    real = emulator_mod.fused_pc_predict

    def spy(*args, **kwargs):
        seen.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(emulator_mod, "fused_pc_predict", spy)
    x = torch.rand((5, 4), generator=torch.Generator().manual_seed(2))
    e.predict_pc_raw_fastgrad(x)
    assert seen == [1]
    e.predict_pc_raw(x)
    assert seen == [1]


# ----------------------------------------------------------------- card


@pytest.fixture(scope="module")
def card_chain(tmp_path_factory):
    """The flagship's shapes on the card, float32: nine emulators of 4 RBF
    GPs each over one 1095-point, 20-parameter design, blocks as
    :data:`BLOCKS` (synthetic physics, hyperparameters at their start)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the fused kernels have no CPU mode)")
    from gpbayestools_hic_tpu_torch.utils.synthetic import build_synthetic_chain

    chain, _ = build_synthetic_chain(
        nev=1095, ndim=20, nobs_blocks=BLOCKS, npc=4, gp_maxiter=0,
        tmpdir=str(tmp_path_factory.mktemp("dense_route")), device="cuda",
        dtype=torch.float32)
    assert all(e._fused is not None for e in chain.emuList)
    return chain


def _plain_route(e, fn):
    """``fn()`` with the emulator's fused state hidden (the plain route)."""
    fused, e._fused = e._fused, None
    try:
        return fn()
    finally:
        e._fused = fused


@pytest.mark.parametrize("m", [1, 37, 2048])
def test_cuda_dense_predict_takes_the_fused_forward(card_chain, m):
    """``_predict_full`` under ``no_grad`` on the card: one forward launch
    per emulator, mean and covariance within 1e-5 of the plain route, the
    PC mean and the variance's quadratic form within 1e-4 of the plain
    forward in float64; at each of the nine block widths."""
    x = torch.as_tensor(card_chain.random_pos(m, seed=7), dtype=torch.float32,
                        device="cuda")
    extra = torch.zeros(m, dtype=torch.float32, device="cuda")
    for e in card_chain.emuList:
        with torch.no_grad():
            before = LAUNCH_COUNTS["fused_predict_fwd"]
            mean, cov = e._predict_full(x, extra)
            assert LAUNCH_COUNTS["fused_predict_fwd"] == before + 1
            gp_mean, gp_var = e._gp_pc(x)
            pm, pc = _plain_route(e, lambda: e._predict_full(x, extra))
        assert mean.shape == (m, e.nobs) and cov.shape == (m, e.nobs, e.nobs)
        assert _rel(mean, pm) < 1e-5, e.nobs
        assert _rel(cov, pc) < 1e-5, e.nobs
        fs64 = fp.state_as(e._fused, torch.float64)
        mean64, qf64, _ = fp.fused_fwd_plain(fs64, x.double())
        var64 = torch.clamp(fs64.kdiag[:, None] - qf64, min=0.0)
        assert _rel(gp_mean.T.double(), mean64) < 1e-4, e.nobs
        assert (gp_var.T.double() - var64).abs().max().item() / qf64.abs().max().item() < 1e-4


@pytest.mark.parametrize("mode", ["generic", "stitched"])
def test_cuda_dense_posterior_launches_one_forward_per_emulator(card_chain, mode):
    """A dense posterior call at 2048 walkers launches the fused forward
    exactly once per emulator, and no backward."""
    card_chain.likelihood_mode = mode
    log_post, state = card_chain.posterior_with_state()
    x = torch.as_tensor(card_chain.random_pos(2048, seed=8), dtype=torch.float32,
                        device="cuda")
    with torch.no_grad():
        log_post(state, x)
        reset_launch_counts()
        for calls in (1, 2):
            log_post(state, x)
            assert LAUNCH_COUNTS["fused_predict_fwd"] == calls * len(card_chain.emuList)
    assert LAUNCH_COUNTS["fused_predict_bwd"] == LAUNCH_COUNTS["fused_predict_bwd_high"] == 0
    card_chain.likelihood_mode = "auto"


def test_cuda_recorded_gradient_keeps_the_plain_route(card_chain):
    """Queries that record a gradient (and a ``jacfwd`` through the plain
    core) launch no predict kernel, and ``_predict_full`` equals the plain
    assembly bit for bit."""
    from gpbayestools_hic_tpu_torch.utils.sensitivity import sensitivity_matrix

    x = torch.as_tensor(card_chain.random_pos(37, seed=9), dtype=torch.float32,
                        device="cuda").requires_grad_(True)
    extra = torch.zeros(37, dtype=torch.float32, device="cuda")
    for e in card_chain.emuList:
        before = dict(LAUNCH_COUNTS)
        mean, cov = e._predict_full(x, extra)
        (g,) = torch.autograd.grad(mean.sum() + cov.sum(), x)
        assert dict(LAUNCH_COUNTS) == before
        ref_mean, ref_cov = _plain_assembly(e, x, extra)
        assert torch.equal(mean, ref_mean) and torch.equal(cov, ref_cov)
        assert torch.isfinite(g).all()
    e = card_chain.emuList[0]
    theta = torch.as_tensor(card_chain.random_pos(1, seed=10)[0], dtype=torch.float32,
                            device="cuda")
    before = dict(LAUNCH_COUNTS)
    jac = torch.func.jacfwd(lambda t: e._pc_core(t[None], fast_grad=False, raw=False)[0][0])(theta)
    assert dict(LAUNCH_COUNTS) == before and torch.isfinite(jac).all()
    # sensitivity_matrix: the Jacobian on the plain route, the mean (no
    # derivative) on the fused forward
    s = sensitivity_matrix(e, theta.cpu().numpy())
    assert LAUNCH_COUNTS["fused_predict_fwd"] == before["fused_predict_fwd"] + 1
    assert np.isfinite(s).all()


@pytest.mark.parametrize("mode", ["generic", "stitched"])
def test_cuda_dense_log_posterior_matches_float64(card_chain, mode):
    """The dense log posterior at 2048 walkers on the fused forward within
    0.005 of the float64 oracle."""
    from gpbayestools_hic_tpu_torch.utils.validation import f64_log_posterior

    x = card_chain.random_pos(2048, seed=11)
    card_chain.likelihood_mode = mode
    try:
        before = LAUNCH_COUNTS["fused_predict_fwd"]
        lp = np.asarray(card_chain.log_posterior(x), np.float64)
        assert LAUNCH_COUNTS["fused_predict_fwd"] == before + len(card_chain.emuList)
    finally:
        card_chain.likelihood_mode = "auto"
    gap = np.abs(lp - f64_log_posterior(card_chain, x)).max()
    assert gap < 0.005, gap
