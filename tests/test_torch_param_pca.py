"""PyTorch port: parameter-space PCA (viscosity curves, fit, transform)
against the JAX package's ``models/param_pca.py``, in float64 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpbayestools_hic_tpu.models import param_pca as jpp
from gpbayestools_hic_tpu_torch.models import param_pca as pp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the suite runs in
    parallel worker processes, where multi-threaded torch ops on every
    worker oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _design(nev=30, seed=42):
    """20-parameter design in the flagship layout (physical-ish ranges for
    the three viscosity groups)."""
    rng = np.random.default_rng(seed)
    lo, hi = np.zeros(20), np.ones(20)
    lo[15:19], hi[15:19] = 0.01, 0.3   # zeta
    lo[12:15], hi[12:15] = 0.01, 0.4   # eta
    lo[2:5], hi[2:5] = 0.5, 3.0        # yloss
    return lo + (hi - lo) * rng.uniform(size=(nev, 20)), lo, hi


@pytest.mark.parametrize("curve,npar,grid", [
    ("zeta", 4, np.linspace(0.0, 0.5, 100)),
    ("eta", 3, np.linspace(0.0, 0.6, 100)),
    ("yloss", 3, np.linspace(0.0, 6.2, 100)),
])
def test_curves_match_jax(curve, npar, grid):
    """Each curve on its grid, for a batch of parameter rows, equals the
    JAX curve to 1e-14 (same branches, including the quirks at 0)."""
    params = np.random.default_rng(0).uniform(0.01, 3.0, size=(7, npar))
    got = pp._CURVES[curve](torch.tensor(params), torch.tensor(grid)).numpy()
    ref = np.asarray(jpp._CURVES[curve](jnp.asarray(params), jnp.asarray(grid)))
    np.testing.assert_allclose(got, ref, rtol=1e-14, atol=1e-15)


def test_branch_quirks_kept():
    zero = torch.tensor([0.0], dtype=torch.float64)
    f64 = dict(dtype=torch.float64)
    # eta/s: mu_B = 0 falls through to eta_4
    assert float(pp.eta_over_s_vs_mu_B(torch.tensor([[0.1, 0.2, 0.3]], **f64), zero)[0, 0]) == 0.3
    # y_loss: y_init = 0 takes the third branch, y4 - 2 (y6 - y4)
    assert float(pp.y_loss_vs_y_init(torch.tensor([[1.0, 2.0, 2.5]], **f64), zero)[0, 0]) == 1.0
    # zeta/s: the branch is taken at T < T_zeta0 (not the shifted peak)
    z = pp.zeta_over_s_vs_T(torch.tensor([[1.0, 0.2, 0.05, 0.1]], dtype=torch.float64),
                            torch.tensor([0.19]), mu_B=0.5)
    T_peak = 0.2 - 0.15 * 0.25
    assert float(z[0, 0]) == pytest.approx(np.exp(-(0.19 - T_peak) ** 2 / (2 * 0.1**2)))


def test_fit_matches_jax_and_apply_reproduces_the_design():
    """fit_param_pca gives the JAX state, new design and ranges (1e-10);
    applying the state to the training design (tensor, numpy and packed
    forms) reproduces the new design, and matches the JAX transform on
    other points."""
    design, lo, hi = _design()
    state, new_design, new_min, new_max = pp.fit_param_pca(design, lo, hi)
    jstate, jnew, jmin, jmax = jpp.fit_param_pca(design, lo, hi)
    assert state.npcs == tuple(int(n) for n in jstate.npcs)
    np.testing.assert_allclose(new_design, np.asarray(jnew), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(new_min, jmin, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(new_max, jmax, rtol=1e-10, atol=1e-12)
    for s, js in zip(state.scalers, jstate.scalers):
        for a, b in zip(s, js):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-12)
    assert new_design.shape == (30, 10 + sum(state.npcs))
    groups = pp.default_groups()
    np.testing.assert_allclose(pp.apply_param_pca(state, groups, design), new_design,
                               rtol=1e-10, atol=1e-12)
    q, _, _ = _design(nev=9, seed=3)
    ref = np.asarray(jpp.apply_param_pca(jstate, tuple(jpp.default_groups()), jnp.asarray(q)))
    as_tensor = pp.apply_param_pca(state, groups, torch.tensor(q))
    packed = pp.apply_param_pca_packed(pp.pack_param_pca(state), groups, torch.tensor(q))
    np.testing.assert_allclose(as_tensor.numpy(), ref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(packed.numpy(), ref, rtol=1e-10, atol=1e-12)
    with pytest.raises(ValueError, match="2-D"):
        pp.apply_param_pca(state, groups, torch.tensor(q[0]))


def test_transform_jacobian_matches_jax():
    """The packed transform is differentiable in the query: its Jacobian
    (autograd) equals jax.jacfwd of the JAX packed transform (1e-10)."""
    design, lo, hi = _design()
    state, *_ = pp.fit_param_pca(design, lo, hi)
    jstate, *_ = jpp.fit_param_pca(design, lo, hi)
    q = _design(nev=2, seed=8)[0]
    packed = pp.pack_param_pca(state)
    jac = torch.autograd.functional.jacobian(
        lambda x: pp.apply_param_pca_packed(packed, pp.default_groups(), x), torch.tensor(q))
    jpacked = jpp.pack_param_pca(jstate)
    jjac = jax.jacfwd(lambda x: jpp.apply_param_pca_packed(
        jpacked, tuple(jpp.default_groups()), x))(jnp.asarray(q))
    np.testing.assert_allclose(jac.numpy(), np.asarray(jjac), rtol=1e-10, atol=1e-12)


def test_group_order_validation():
    design, lo, hi = _design()
    bad = [
        pp.ParamPCAGroup("yloss", (2, 3, 4), tuple(np.linspace(0, 6.2, 100)), "yloss"),
        pp.ParamPCAGroup("bulk", (15, 16, 17, 18), tuple(np.linspace(0, 0.5, 100)), "zeta"),
    ]
    with pytest.raises(ValueError, match="descending"):
        pp.fit_param_pca(design, lo, hi, bad)


def test_emulator_parametrization_methods_match_jax(tmp_path):
    """The Emulator's three curve methods give the JAX Emulator's values
    for a scalar (a float) and for a grid."""
    from gpbayestools_hic_tpu.models import Emulator as JEmulator
    from gpbayestools_hic_tpu_torch.models import Emulator

    e, je = Emulator.__new__(Emulator), JEmulator.__new__(JEmulator)
    grid = np.linspace(0.0, 0.5, 11)
    for args, T in (((0.1, 0.18, 0.03, 0.05), 0.2), ((0.1, 0.18, 0.03, 0.05), grid)):
        got = e.parametrization_zeta_over_s_vs_T(*args, T, 0.3)
        ref = je.parametrization_zeta_over_s_vs_T(*args, T, 0.3)
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-14)
    got = e.parametrization_eta_over_s_vs_mu_B(0.1, 0.2, 0.3, 0.25)
    assert isinstance(got, float)
    assert got == pytest.approx(je.parametrization_eta_over_s_vs_mu_B(0.1, 0.2, 0.3, 0.25),
                                rel=1e-14)
    np.testing.assert_allclose(
        e.parametrization_y_loss_vs_y_init(1.0, 2.0, 2.5, grid * 10),
        np.asarray(je.parametrization_y_loss_vs_y_init(1.0, 2.0, 2.5, grid * 10)), rtol=1e-14)
