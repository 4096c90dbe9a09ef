"""PyTorch port: emulator loading/training parity with the JAX package, the
save-file class mapping, and the port's import isolation.

JAX emulators are trained and saved here (``Emulator.save``); the port
loads the same files, so both packages compute from the same GP factors.
All comparisons run in float64 on the CPU.
"""

import ast
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gpbayestools_hic_tpu.models import Emulator as JEmulator
from gpbayestools_hic_tpu.ops import scalers as jscalers
from gpbayestools_hic_tpu.runtime import parse_model_parameter_file as j_parse
from gpbayestools_hic_tpu.utils import io as jio
from gpbayestools_hic_tpu_torch.models.emulator import Emulator
from gpbayestools_hic_tpu_torch.ops import scalers
from gpbayestools_hic_tpu_torch.runtime import parse_model_parameter_file
from gpbayestools_hic_tpu_torch.utils import io

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "gpbayestools_hic_tpu_torch"
F64 = dict(device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module")
def toy_files(tmp_path_factory):
    """Training pickle + parameter file (3 parameters, 40 events, 6 obs)."""
    tmp = tmp_path_factory.mktemp("emu")
    rng = np.random.default_rng(7)
    ndim, nev, nobs = 3, 40, 6
    design = rng.uniform(0, 1, size=(nev, ndim))
    freqs = rng.uniform(1, 2.5, size=(ndim, nobs))
    base = 2.0 + np.sin(design @ freqs) + 0.2 * (design**2) @ freqs
    pkl = tmp / "train.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({str(i): {"parameter": design[i],
                              "obs": np.stack([base[i], 0.01 * np.abs(base[i])])}
                     for i in range(nev)}, f)
    par = tmp / "pars.txt"
    par.write_text("p0: $p_0$, 0.0, 1.0  # c\np1: $p_1$, 0.0, 1.0\np2: $p_2$, 0.0, 1.0\n")
    return tmp, str(pkl), str(par)


VARIANTS = {
    "rbf0": dict(gp_maxiter=0),
    "rbf5": dict(gp_maxiter=5),
    "matern0": dict(gp_maxiter=0, kernel_type="Matern"),
    "nopca0": dict(gp_maxiter=0, perform_no_PCA=True),
    "expdiag0": dict(gp_maxiter=0, logTrafo=True, exp_and_cov_diagonal=True),
}


@pytest.fixture(scope="module")
def jax_saves(toy_files):
    """JAX emulators of each variant, trained and saved to disk."""
    tmp, pkl, par = toy_files
    out = {}
    for name, kw in VARIANTS.items():
        kw = dict(kw)
        kernel = kw.pop("kernel_type", "RBF")
        e = JEmulator(pkl, par, npc=3, **kw)
        e.trainEmulator(np.ones(e.nev, dtype=bool), kernel_type=kernel)
        path = tmp / f"emu_{name}.pkl"
        e.save(str(path))
        out[name] = (e, str(path))
    return out


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loaded_emulator_predict_matches_jax(jax_saves, variant):
    """Predict mean/cov and the raw PC mean/var of a loaded JAX save match
    the JAX emulator to 1e-10 (f64, same factors; summation order only)."""
    je, path = jax_saves[variant]
    e = Emulator.load(path, **F64)
    X = np.random.default_rng(3).uniform(0.05, 0.95, size=(9, 3))
    mean, cov = e.predict(X)
    jmean, jcov = je.predict(X)
    np.testing.assert_allclose(mean, jmean, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(cov, jcov, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(e.predict(X, return_cov=False), jmean, rtol=1e-10)
    np.testing.assert_allclose(
        e.predict(X, extra_std=0.3)[1], je.predict(X, extra_std=0.3)[1], rtol=1e-10, atol=1e-12)
    x = torch.tensor(X)
    for fast in (False, True):
        gm, gv = (e.predict_pc_raw_fastgrad if fast else e.predict_pc_raw)(x)
        jfn = je.predict_pc_raw_pure_fastgrad if fast else je.predict_pc_raw_pure
        jgm, jgv = jfn(je.predict_state, X)
        np.testing.assert_allclose(gm.numpy(), np.asarray(jgm), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(gv.numpy(), np.asarray(jgv), rtol=1e-10, atol=1e-12)
    assert e.has_lowrank_cov == je.has_lowrank_cov
    if e.has_lowrank_cov:
        a, ct = e.lowrank_parts()
        ja, jct = je.lowrank_parts()
        np.testing.assert_array_equal(a, np.asarray(ja))
        np.testing.assert_array_equal(ct, np.asarray(jct))


def test_port_training_maxiter0_reproduces_jax_state(toy_files, jax_saves):
    """The port's own trainEmulator(gp_maxiter=0) rebuilds JAX's GPState
    (chol, alpha, linv, lml) and transform matrices to 1e-10 (f64)."""
    _, pkl, par = toy_files
    je, _ = jax_saves["rbf0"]
    e = Emulator(pkl, par, npc=3, gp_maxiter=0, **F64)
    e.trainEmulatorAutoMask()
    js, ps = je.gp_state, e.gp_state
    for name in ("chol", "alpha_vec", "linv", "lml", "y"):
        np.testing.assert_allclose(getattr(ps, name).numpy(), np.asarray(getattr(js, name)),
                                   rtol=1e-10, atol=1e-12, err_msg=name)
    for k in ("log_amp", "log_ls", "log_noise"):
        np.testing.assert_allclose(ps.params[k].numpy(), np.asarray(js.params[k]), rtol=1e-12)
    np.testing.assert_allclose(e._var_trans, np.asarray(je._var_trans), rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(e._cov_trunc, np.asarray(je._cov_trunc), rtol=1e-10, atol=1e-14)
    X = np.random.default_rng(4).uniform(0.05, 0.95, size=(5, 3))
    np.testing.assert_allclose(e.predict(X)[1], je.predict(X)[1], rtol=1e-10, atol=1e-12)


def test_training_with_iterations_not_ported(toy_files):
    _, pkl, par = toy_files
    e = Emulator(pkl, par, npc=3, gp_maxiter=5, **F64)
    with pytest.raises(NotImplementedError, match="item 6"):
        e.trainEmulatorAutoMask()
    with pytest.raises(NotImplementedError, match="parameterTrafoPCA"):
        Emulator(pkl, par, npc=3, parameterTrafoPCA=True, **F64)


def test_f32_emulator_routes_through_fused_path(jax_saves):
    """A float32 RBF emulator's fast-gradient raw predict takes the fused
    op (the kernels on CUDA, the plain version here) and agrees with the
    f64 path to float32 accuracy (1e-4: f32 rounding of the factors)."""
    je, path = jax_saves["rbf5"]
    e32 = Emulator.load(path, device="cpu")
    e64 = Emulator.load(path, **F64)
    assert e32._fused is not None and e64._fused is None
    X = np.random.default_rng(5).uniform(0.05, 0.95, size=(7, 3))
    gm32, gv32 = e32.predict_pc_raw_fastgrad(torch.tensor(X, dtype=torch.float32))
    gm64, gv64 = e64.predict_pc_raw_fastgrad(torch.tensor(X))
    np.testing.assert_allclose(gm32.numpy(), gm64.numpy(), atol=1e-4)
    np.testing.assert_allclose(gv32.numpy(), gv64.numpy(), atol=1e-4)


def test_no_gpu_without_explicit_cpu_raises(jax_saves, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Emulator.load(jax_saves["rbf0"][1])


def test_unpickler_maps_jax_state_classes(jax_saves):
    tree, meta = io.load_pytree(jax_saves["rbf0"][1])
    assert type(tree["scaler"]) is scalers.StandardScalerState
    assert type(tree["pca"]) is scalers.PCAState
    assert meta["npc_used"] == 3


def test_unpickler_rejects_unported_classes(tmp_path):
    from gpbayestools_hic_tpu.models.param_pca import ParamPCAState

    path = tmp_path / "pp.pkl"
    jio.save_pytree(str(path), {"pp": ParamPCAState((), (), ())}, {})
    with pytest.raises(NotImplementedError, match="ParamPCAState"):
        io.load_pytree(str(path))


def test_save_pytree_round_trip(tmp_path):
    tree = {"a": torch.arange(3.0), "s": scalers.StandardScalerState(
        np.ones(2), np.ones(2), np.zeros(2)), "n": None}
    io.save_pytree(tmp_path / "t.pkl", tree, {"k": 1})
    back, meta = io.load_pytree(tmp_path / "t.pkl")
    np.testing.assert_array_equal(back["a"], np.arange(3.0))
    assert isinstance(back["s"], scalers.StandardScalerState) and back["n"] is None
    assert meta == {"k": 1}


def test_host_helpers_match_jax(toy_files, tmp_path):
    """Own copies of the numpy helpers give the JAX package's results."""
    _, pkl, par = toy_files
    assert parse_model_parameter_file(par) == j_parse(par)
    td, jtd = io.load_training_pickle(pkl, log_trafo=True), jio.load_training_pickle(pkl, log_trafo=True)
    for a, b in zip(td[:4], jtd[:4]):
        np.testing.assert_array_equal(a, b)
    data = np.random.default_rng(0).normal(size=(30, 5))
    for a, b in zip(scalers.fit_standard_scaler(data), jscalers.fit_standard_scaler(data)):
        np.testing.assert_array_equal(a, np.asarray(b))
    p, jp = scalers.fit_pca(data), jscalers.fit_pca(data)
    for a, b in zip(p[:4], jp[:4]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-12)
    np.testing.assert_allclose(scalers.pca_transform(p, data, npc=3),
                               np.asarray(jscalers.pca_transform(jp, data, npc=3)), rtol=1e-12)
    exp = tmp_path / "exp.pkl"
    with open(exp, "wb") as f:
        pickle.dump({"0": {"obs": np.stack([np.arange(1.0, 4.0), np.full(3, 0.1)])}}, f)
    for a, b in zip(io.load_exp_data_pickle(exp), jio.load_exp_data_pickle(exp)):
        np.testing.assert_array_equal(a, b)


def test_isolation_subprocess_loads_jax_save_without_jax(jax_saves):
    """A fresh process imports the port and loads a JAX-saved emulator:
    neither jax nor any gpbayestools_hic_tpu module gets imported."""
    code = (
        "import sys\n"
        "from gpbayestools_hic_tpu_torch.models import Emulator\n"
        "from gpbayestools_hic_tpu_torch.samplers import Chain\n"
        f"e = Emulator.load({jax_saves['rbf5'][1]!r}, device='cpu')\n"
        "m, c = e.predict([[0.5, 0.5, 0.5]])\n"
        "assert m.shape == (1, 6) and c.shape == (1, 6, 6)\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "bad = [k for k in sys.modules if k == 'gpbayestools_hic_tpu' "
        "or k.startswith('gpbayestools_hic_tpu.')]\n"
        "assert not bad, bad\n"
        "print('isolated')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "isolated" in out.stdout


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_isolation_ast_scan():
    """No port file (nor chip_smoke.py) imports jax or the JAX package."""
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "gpbayestools_hic_tpu"), (f, mod)
