"""PyTorch port: emulator validation and diagnostics against the JAX
package on the CPU in float64 -- the ``testEmulatorErrors*`` arrays, the
validation harness (``validate_emulator``, ``validate_multiple_emulators``,
``holdout_scan``, ``save_metrics_csv``), ``print_learning_curve``,
``outputPCAvsParam``, ``getAvgTrainingDataRelError`` and
``predict_device``."""

import pickle

import numpy as np
import pytest
import torch

from gpbayestools_hic_tpu.models import Emulator as JEmulator
from gpbayestools_hic_tpu.models import EmulatorBAND as JBAND
from gpbayestools_hic_tpu.models import validation as jval
from gpbayestools_hic_tpu_torch.models import Emulator, EmulatorBAND
from gpbayestools_hic_tpu_torch.models import validation as val

F64 = dict(device="cpu", dtype=torch.float64)
# both optimizers take the same path for these few iterations (see
# tests/test_torch_band.py), so fits agree to ~1e-10 and arrays to 1e-8
MAXITER = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tensors are tiny and the suite runs in
    parallel worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """36 events, 3 parameters, 7 observables; a logTrafo-friendly positive
    model, and a copy with NaNs (one in a holdout row) for the impute
    heads."""
    tmp = tmp_path_factory.mktemp("valid")
    rng = np.random.default_rng(21)
    design = rng.uniform(0, 1, size=(36, 3))
    base = 2.5 + np.sin(design @ rng.uniform(1, 2.5, size=(3, 7)))
    err = 0.01 * base
    par = tmp / "p.txt"
    par.write_text("".join(f"p{i}: l, 0.0, 1.0\n" for i in range(3)))
    out = {"par": str(par)}
    holed = base.copy()
    holed[4, 2] = np.nan
    holed[-1, 5] = np.nan
    for tag, b in (("clean", base), ("holed", holed)):
        pkl = tmp / f"{tag}.pkl"
        with open(pkl, "wb") as f:
            pickle.dump({str(i): {"parameter": design[i], "obs": np.stack([b[i], err[i]])}
                         for i in range(36)}, f)
        out[tag] = str(pkl)
    return out


VARIANTS = {
    "sklearn": lambda mod, d, **kw: mod["Emulator"](d["clean"], d["par"], npc=3, **kw),
    "sklearn-log": lambda mod, d, **kw: mod["Emulator"](d["clean"], d["par"], npc=3,
                                                         logTrafo=True, **kw),
    "PCSK": lambda mod, d, **kw: mod["BAND"](d["clean"], d["par"], method="PCSK", **kw),
    "PCGPwImpute": lambda mod, d, **kw: mod["BAND"](d["holed"], d["par"], method="PCGPwImpute",
                                                     max_rel_uncertainty_data=10.0, **kw),
}
PORT = {"Emulator": lambda *a, **k: Emulator(*a, **k, **F64),
        "BAND": lambda *a, **k: EmulatorBAND(*a, **k, **F64)}
JAX = {"Emulator": JEmulator, "BAND": JBAND}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("with_training", [False, True])
def test_emulator_error_arrays_match_jax(data, variant, with_training):
    """(pred, pred_err, truth, truth_err) of testEmulatorErrors and
    testEmulatorErrorsWithTrainingPoints (6 held out): 1e-8 relative, NaN
    truth at imputed entries as in JAX."""
    pe = VARIANTS[variant](PORT, data, gp_maxiter=MAXITER)
    je = VARIANTS[variant](JAX, data, gp_maxiter=MAXITER)
    name = "testEmulatorErrorsWithTrainingPoints" if with_training else "testEmulatorErrors"
    if variant in ("PCSK", "PCGPwImpute"):
        got, want = getattr(pe, name)(6), getattr(je, name)(6)
    else:
        got, want = getattr(pe, name)(6, kernel_type="RBF"), getattr(je, name)(6, kernel_type="RBF")
    assert got[0].shape == ((30 if with_training else 6), 7)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-12, equal_nan=True)
    if variant == "PCGPwImpute" and not with_training:
        assert np.isnan(got[2][-1, 5])


def test_validation_harness_matches_jax(data, tmp_path):
    """validate_emulator's metric dict, validate_multiple_emulators,
    holdout_scan and the CSV: the port's against the JAX package's (1e-8
    relative; the CSV text equal to 1e-8 in its numbers)."""
    def factories(mod):
        return {v: (lambda v=v: VARIANTS[v](mod, data, gp_maxiter=MAXITER))
                for v in ("sklearn", "PCSK")}

    got = val.validate_multiple_emulators(factories(PORT), n_test_points=5)
    want = jval.validate_multiple_emulators(factories(JAX), n_test_points=5)
    assert list(got) == list(want)
    for name in want:
        for key in ("E", "H", "pred", "pred_err", "truth", "truth_err"):
            np.testing.assert_allclose(got[name][key], want[name][key], rtol=1e-8, atol=1e-12)
        for key in ("mean_E", "mean_log_H"):
            assert got[name][key] == pytest.approx(want[name][key], rel=1e-8)
    val.save_metrics_csv(tmp_path / "p.csv", got)
    jval.save_metrics_csv(tmp_path / "j.csv", want)
    p_lines = (tmp_path / "p.csv").read_text().splitlines()
    j_lines = (tmp_path / "j.csv").read_text().splitlines()
    assert p_lines[0] == j_lines[0] == "variant,observable,E,H" and len(p_lines) == len(j_lines)
    for a, b in zip(p_lines[1:], j_lines[1:]):
        a, b = a.split(","), b.split(",")
        assert a[:2] == b[:2]
        np.testing.assert_allclose(np.float64(a[2:]), np.float64(b[2:]), rtol=1e-8)

    scan = val.holdout_scan(factories(PORT)["sklearn"], test_sizes=(4, 8))
    jscan = jval.holdout_scan(factories(JAX)["sklearn"], test_sizes=(4, 8))
    for key in ("test_sizes", "mean_E", "mean_log_H"):
        np.testing.assert_allclose(scan[key], jscan[key], rtol=1e-8)


@pytest.mark.parametrize("variant", ["sklearn", "PCSK"])
def test_diagnostics_match_jax(data, variant):
    """print_learning_curve (2 fractions, 3 folds), outputPCAvsParam and
    getAvgTrainingDataRelError: the port's against the JAX package's
    (1e-8; the learning curve's R^2 to 1e-7)."""
    pe = VARIANTS[variant](PORT, data, gp_maxiter=5)
    je = VARIANTS[variant](JAX, data, gp_maxiter=5)
    got = pe.print_learning_curve(train_sizes=(0.5, 0.9), n_folds=3)
    want = je.print_learning_curve(train_sizes=(0.5, 0.9), n_folds=3)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-7, atol=1e-9)
    (dp, zp), (dj, zj) = pe.outputPCAvsParam(), je.outputPCAvsParam()
    np.testing.assert_array_equal(dp, dj)
    np.testing.assert_allclose(np.abs(zp), np.abs(np.asarray(zj)), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(pe.getAvgTrainingDataRelError(), je.getAvgTrainingDataRelError(),
                               rtol=1e-12)


def test_predict_device_returns_device_tensors(data):
    """predict_device takes and returns tensors on the emulator's device,
    equal to predict (1e-12), differentiable in X, with extra_std added to
    the variance."""
    e = Emulator(data["clean"], data["par"], npc=3, gp_maxiter=MAXITER, **F64)
    e.trainEmulatorAutoMask()
    x = torch.tensor(np.random.default_rng(0).uniform(size=(4, 3)), requires_grad=True)
    mean, cov = e.predict_device(x)
    assert isinstance(mean, torch.Tensor) and mean.device.type == "cpu"
    m_np, c_np = e.predict(x.detach().numpy())
    np.testing.assert_allclose(mean.detach().numpy(), m_np, rtol=1e-12)
    np.testing.assert_allclose(cov.detach().numpy(), c_np, rtol=1e-12, atol=1e-15)
    (g,) = torch.autograd.grad(mean.sum(), x)
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0
    _, cov2 = e.predict_device(x, extra_std=torch.full((4,), 0.1, dtype=torch.float64))
    assert float((cov2 - cov).detach().diagonal(dim1=1, dim2=2).min()) > 0
