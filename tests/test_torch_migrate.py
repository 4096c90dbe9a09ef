"""PyTorch port: importing reference emulators (``models/migrate.py``)
against the JAX package on the CPU in float64.

The reference repository is not available, so the reference objects are
stand-ins built here with the reference's attribute layout: a sklearn head
with real fitted ``GaussianProcessRegressor``s, scalers and PCA (plain,
``logTrafo``, ``perform_no_PCA``, a Matern kernel, and parameter-space PCA
groups), and a BAND wrapper holding its training state.  Both packages'
``from_reference`` must give the same predictions (1e-10)."""

import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gpbayestools_hic_tpu.models import Emulator as JEmulator
from gpbayestools_hic_tpu.models import param_pca as jpp
from gpbayestools_hic_tpu.models.migrate import band_from_reference as j_band_from_reference
from gpbayestools_hic_tpu_torch.models import Emulator, EmulatorBAND
from gpbayestools_hic_tpu_torch.models.migrate import band_from_reference

F64 = dict(device="cpu", dtype=torch.float64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tensors are tiny and the suite runs in
    parallel worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class RefEmulator:
    """Stand-in for the reference's sklearn-backed Emulator."""


class RefEmulatorBAND:
    """Stand-in for the reference's surmise-backed EmulatorBAND."""


def _sklearn_standin(design, gp_design, data, *, kernel="RBF", log=False, no_pca=False,
                     npc=3, lo=None, hi=None):
    from sklearn.decomposition import PCA
    from sklearn.gaussian_process import GaussianProcessRegressor
    from sklearn.gaussian_process import kernels as K
    from sklearn.preprocessing import StandardScaler

    ndim = design.shape[1]
    ref = RefEmulator()
    ref.logTrafo_, ref.exp_and_cov_diagonal_, ref.perform_no_PCA_ = log, False, no_pca
    ref.parameterTrafoPCA_ = False
    ref.npc, (ref.nev, ref.nobs) = npc, data.shape
    ref.pardict = {f"p{i}": [f"$p_{i}$", 0.0, 1.0] for i in range(ndim)}
    ref.design_min = np.zeros(gp_design.shape[1]) if lo is None else lo
    ref.design_max = np.ones(gp_design.shape[1]) if hi is None else hi
    ref.model_data = np.log(data) if log else data
    ref.model_data_err = 0.01 * np.abs(ref.model_data)
    ref.design_points = design
    ref.scaler = StandardScaler().fit(ref.model_data)
    z = ref.scaler.transform(ref.model_data)
    if not no_pca:
        ref.pca = PCA(whiten=True, svd_solver="full").fit(z)
        z = ref.pca.transform(z)
    base = (K.RBF(np.ones(gp_design.shape[1])) if kernel == "RBF"
            else K.Matern(np.ones(gp_design.shape[1]), nu=1.5))
    ncols = data.shape[1] if no_pca else npc
    ref.gps = [GaussianProcessRegressor(K.ConstantKernel(1.0) * base + K.WhiteKernel(0.05),
                                        alpha=0.1).fit(gp_design, z[:, k])
               for k in range(ncols)]
    return ref


def _param_pca_standin(rng):
    """20 flagship-layout parameters; the three parameter-PCA groups as the
    reference stores them (sklearn-attribute scalers and PCAs), fitted by
    the JAX package's parameter-PCA code."""
    lo, hi = np.zeros(20), np.ones(20)
    lo[15:19], hi[15:19] = 0.01, 0.3
    lo[12:15], hi[12:15] = 0.01, 0.4
    lo[2:5], hi[2:5] = 0.5, 3.0
    design = lo + (hi - lo) * rng.uniform(size=(30, 20))
    state, new_design, new_lo, new_hi = jpp.fit_param_pca(design, lo, hi, jpp.default_groups())
    data = 2.0 + np.sin(design @ rng.uniform(0.3, 1.0, size=(20, 5)))
    ref = _sklearn_standin(design, np.asarray(new_design), data, lo=new_lo, hi=new_hi)
    ref.parameterTrafoPCA_ = True
    ref.pardict = {f"p{i}": ["l", lo[i], hi[i]] for i in range(20)}
    ref.indices_zeta_s_parameters = [15, 16, 17, 18]
    ref.indices_eta_s_parameters = [12, 13, 14]
    ref.indices_yloss_parameters = [2, 3, 4]
    for name, sc, pc, npc in zip(("bulk", "shear", "yloss"), state.scalers, state.pcas,
                                 state.npcs):
        setattr(ref, f"paramTrafoScaler_{name}", SimpleNamespace(
            mean_=np.asarray(sc.mean), scale_=np.asarray(sc.scale), var_=np.asarray(sc.var)))
        setattr(ref, f"paramTrafoPCA_{name}", SimpleNamespace(
            mean_=np.asarray(pc.mean), components_=np.asarray(pc.components),
            explained_variance_=np.asarray(pc.explained_variance),
            explained_variance_ratio_=np.asarray(pc.explained_variance_ratio),
            n_components_=int(npc)))
    ref.PCA_new_design_points = np.asarray(new_design)
    return ref, lo, hi


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(13)
    design = rng.uniform(size=(30, 3))
    data = 2.5 + np.sin(design @ rng.uniform(1, 2, size=(3, 6)))
    return rng, design, data


@pytest.mark.parametrize("variant", ["rbf", "matern", "log", "no-pca", "param-pca"])
def test_from_reference_matches_jax(problem, variant, tmp_path):
    """The port's conversion of a live stand-in and of its dill file predict
    what the JAX package's conversion predicts (mean and covariance, 1e-10
    relative); the converted head keeps the low-rank path."""
    import dill

    rng, design, data = problem
    if variant == "param-pca":
        ref, lo, hi = _param_pca_standin(rng)
        xq = lo + (hi - lo) * rng.uniform(0.1, 0.9, size=(6, 20))
    else:
        ref = _sklearn_standin(design, design, data, kernel="Matern" if variant == "matern" else "RBF",
                               log=variant == "log", no_pca=variant == "no-pca")
        xq = rng.uniform(0.1, 0.9, size=(6, 3))
    sav = tmp_path / "ref.sav"
    with open(sav, "wb") as f:
        dill.dump(ref, f)
    je = JEmulator.from_reference(ref)
    for pe in (Emulator.from_reference(ref, **F64), Emulator.from_reference(str(sav), **F64)):
        assert type(pe) is Emulator and pe.has_lowrank_cov == (variant != "no-pca")
        (mp, cp), (mj, cj) = pe.predict(xq), je.predict(xq)
        np.testing.assert_allclose(mp, mj, rtol=1e-10)
        np.testing.assert_allclose(cp, cj, rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(pe.gp_state.lml.numpy(), np.asarray(je.gp_state.lml),
                                   rtol=1e-10)


def test_band_from_reference_matches_jax(problem, tmp_path):
    """A BAND stand-in (PCSK) is rebuilt by a retrain on its stored state in
    either package: the generic entry point dispatches it, and the port's
    head predicts what the JAX one does (1e-8; both fits at gp_maxiter=8)."""
    import dill

    rng, design, data = problem
    ref = RefEmulatorBAND()
    ref.method_ = "PCSK"
    ref.logTrafo_ = ref.parameterTrafoPCA_ = ref.exp_and_cov_diagonal_ = False
    ref.max_rel_uncertainty_data_ = 0.1
    ref.pardict = {f"p{i}": [f"$p_{i}$", 0.0, 1.0] for i in range(3)}
    ref.design_min, ref.design_max = np.zeros(3), np.ones(3)
    ref.model_data, ref.model_data_err, ref.design_points = data, 0.01 * data, design
    ref.emu = {"opaque": "surmise emulator stand-in"}
    sav = tmp_path / "band.sav"
    with open(sav, "wb") as f:
        dill.dump(ref, f)
    pe = band_from_reference(str(sav), gp_maxiter=8, **F64)
    je = j_band_from_reference(ref, gp_maxiter=8)
    assert isinstance(pe, EmulatorBAND) and pe.method_ == "PCSK"
    xq = rng.uniform(0.1, 0.9, size=(5, 3))
    np.testing.assert_allclose(pe.predict(xq)[0], je.predict(xq)[0], rtol=1e-8)
    assert isinstance(Emulator.from_reference(ref, **F64), EmulatorBAND)
    ref.method_ = "NoSuchMethod"
    with pytest.raises(ValueError, match="unknown method_"):
        band_from_reference(ref, **F64)
    with pytest.raises(ValueError, match="no fitted sklearn GPs"):
        Emulator.from_reference(object(), **F64)


def test_missing_module_error(tmp_path):
    """A dill file that needs a module that is not installed (the real
    failure of surmise-backed files) gets the targeted error naming the
    retrain path, as in the JAX package."""
    mod = tmp_path / "fake_surmise_pkg.py"
    mod.write_text("class FakeEmu:\n    pass\n")
    script = textwrap.dedent(f"""
        import sys, dill
        sys.path.insert(0, {str(tmp_path)!r})
        import fake_surmise_pkg
        with open({str(tmp_path / 'poisoned.sav')!r}, 'wb') as f:
            dill.dump(fake_surmise_pkg.FakeEmu(), f, byref=True)
    """)
    subprocess.run([sys.executable, "-c", script], check=True, timeout=120)
    mod.unlink()
    with pytest.raises(ValueError, match="retrain natively"):
        Emulator.from_reference(str(tmp_path / "poisoned.sav"), **F64)
