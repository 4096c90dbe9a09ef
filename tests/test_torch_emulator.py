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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the suite runs in
    parallel worker processes, where multi-threaded torch ops on every
    worker oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def test_no_gpu_without_explicit_cpu_raises(toy_files, jax_saves, monkeypatch):
    """Loading, and building an emulator to train, ask for CUDA unless the
    caller passes device='cpu'; without a card they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Emulator.load(jax_saves["rbf0"][1])
    _, pkl, par = toy_files
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Emulator(pkl, par, npc=3, gp_maxiter=30)


def test_unpickler_maps_jax_state_classes(jax_saves):
    tree, meta = io.load_pytree(jax_saves["rbf0"][1])
    assert type(tree["scaler"]) is scalers.StandardScalerState
    assert type(tree["pca"]) is scalers.PCAState
    assert meta["npc_used"] == 3


def test_unpickler_rejects_unported_classes(tmp_path):
    """A pickled JAX-package name the port has (the BAND head, and the mesh
    helpers, since they were ported) maps to the port's; one it lacks (the
    XLA compilation cache switch) raises UnpicklingError naming it,
    instead of importing the JAX package."""
    from gpbayestools_hic_tpu.config import enable_compilation_cache
    from gpbayestools_hic_tpu.models.emulator_band import EmulatorBAND
    from gpbayestools_hic_tpu.parallel.mesh import make_mesh
    from gpbayestools_hic_tpu_torch.models.emulator_band import EmulatorBAND as PortBAND
    from gpbayestools_hic_tpu_torch.parallel.mesh import make_mesh as port_make_mesh

    path = tmp_path / "band.pkl"
    with open(path, "wb") as f:
        pickle.dump({"tree": {"cls": EmulatorBAND, "fn": make_mesh}, "meta": {}}, f)
    tree = io.load_pytree(str(path))[0]
    assert tree["cls"] is PortBAND and tree["fn"] is port_make_mesh
    with open(path, "wb") as f:
        pickle.dump({"tree": {"fn": enable_compilation_cache}, "meta": {}}, f)
    with pytest.raises(pickle.UnpicklingError, match="enable_compilation_cache"):
        io.load_pytree(str(path))


def test_save_pytree_round_trip(tmp_path):
    """Tensors come back as numpy arrays; NamedTuples are written as plain
    tuples (so that no class of the port is in the file)."""
    tree = {"a": torch.arange(3.0), "s": scalers.StandardScalerState(
        np.ones(2), np.ones(2), np.zeros(2)), "n": None}
    io.save_pytree(tmp_path / "t.pkl", tree, {"k": 1})
    back, meta = io.load_pytree(tmp_path / "t.pkl")
    np.testing.assert_array_equal(back["a"], np.arange(3.0))
    assert type(back["s"]) is tuple and back["n"] is None
    np.testing.assert_array_equal(scalers.StandardScalerState(*back["s"]).var, np.zeros(2))
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


def test_isolation_subprocess_loads_jax_save_without_jax(jax_saves, jax_pca_save):
    """A fresh process imports the port (the samplers and the walker mesh
    included), loads JAX-saved emulators, one with a ParamPCAState, and
    evaluates one over a mesh: neither jax nor any gpbayestools_hic_tpu
    module gets imported."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from gpbayestools_hic_tpu_torch.models import Emulator\n"
        "from gpbayestools_hic_tpu_torch.samplers import Chain\n"
        "from gpbayestools_hic_tpu_torch.samplers import flows, ptlmc, smc\n"
        "from gpbayestools_hic_tpu_torch.utils import priors\n"
        "from gpbayestools_hic_tpu_torch.parallel import WalkerMesh, sharded_log_prob\n"
        f"e = Emulator.load({jax_saves['rbf5'][1]!r}, device='cpu')\n"
        "m, c = e.predict([[0.5, 0.5, 0.5]])\n"
        "assert m.shape == (1, 6) and c.shape == (1, 6, 6)\n"
        "f = sharded_log_prob(lambda x: e.predict_pc_raw(x)[0].sum(1), WalkerMesh(['cpu'] * 2))\n"
        "import torch\n"
        "assert f(torch.full((3, 3), 0.5)).shape == (3,)\n"
        f"p = Emulator.load({jax_pca_save[1]!r}, device='cpu')\n"
        "assert p.parameterTrafoPCA_ and len(p.param_pca_state.npcs) == 3\n"
        f"m = p.predict(np.full((2, 20), 0.2), return_cov=False)\n"
        "assert m.shape == (2, 6) and np.isfinite(m).all()\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "bad = [k for k in sys.modules if k == 'gpbayestools_hic_tpu' "
        "or k.startswith('gpbayestools_hic_tpu.')]\n"
        "assert not bad, bad\n"
        "print('isolated')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "isolated" in out.stdout


def test_every_port_module_imports_without_optional_packages():
    """A fresh process with sklearn, matplotlib and dill blocked (the GPU
    machine has none of them) imports every module of the port: they load
    lazily, inside the functions that need them."""
    modules = sorted(
        ".".join(("gpbayestools_hic_tpu_torch",) + p.relative_to(PORT).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PORT.rglob("*.py"))
    code = (
        "import importlib, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('sklearn', 'matplotlib', 'dill'):\n"
        "            raise ModuleNotFoundError(f'No module named {name!r}', name=name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('sklearn', 'matplotlib', 'dill', 'jax', 'gpbayestools_hic_tpu')]\n"
        "assert not bad, bad\n"
        "print('imported', len(sys.argv), flush=True)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "imported" in out.stdout
    assert len(modules) > 35


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_isolation_ast_scan():
    """No port file (nor chip_smoke.py, nor the port's tools/torch_*.py, nor
    examples_torch/) imports jax or the JAX package."""
    files = (sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
             + sorted((REPO / "tools").glob("torch_*.py"))
             + sorted((REPO / "examples_torch").glob("*.py")))
    assert len(files) > 40
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "gpbayestools_hic_tpu"), (f, mod)


def test_grad_precision_wiring_and_save_round_trip(toy_files):
    """As tests/test_pallas_predict.py::test_grad_precision_wiring_and_roundtrip:
    ``gp_grad_precision`` set before training reaches ``GPConfig``; a JAX
    save carries it into the port's loaded emulator (default "default");
    an unknown value raises."""
    tmp, pkl, par = toy_files
    e = Emulator(pkl, par, npc=2, gp_maxiter=0, **F64)
    assert e.gp_grad_precision == "default"
    e.gp_grad_precision = "high"
    e.trainEmulatorAutoMask()
    assert e.gp_config.grad_precision == "high"
    bad = Emulator(pkl, par, npc=2, gp_maxiter=0, **F64)
    bad.gp_grad_precision = "bf16"
    with pytest.raises(ValueError, match="grad_precision"):
        bad.trainEmulatorAutoMask()

    je = JEmulator(pkl, par, npc=2, gp_maxiter=0)
    je.gp_grad_precision = "high"
    je.trainEmulatorAutoMask()
    path = tmp / "emu_high.pkl"
    je.save(str(path))
    loaded = Emulator.load(str(path), device="cpu")
    assert loaded.gp_grad_precision == "high" and loaded.gp_config.grad_precision == "high"
    assert loaded._fused is not None
    x = torch.tensor(np.random.default_rng(1).uniform(0.1, 0.9, size=(4, 3)),
                     dtype=torch.float32, requires_grad=True)
    mean, var = loaded.predict_pc_raw_fastgrad(x)
    (g,) = torch.autograd.grad(mean.sum() + var.sum(), x)
    assert torch.isfinite(g).all()


def test_emulator_past_the_kernels_dim_takes_the_plain_path(tmp_path):
    """A float32 RBF emulator with d = 33 (one past the fused kernels'
    DMAX) gets no fused state, as the JAX package's fused_eligible(kind,
    d, dtype) keeps it off its kernel; its fast-gradient raw predict and
    its predict match the JAX Emulator trained on the same file (float32
    on the port's side: 1e-4)."""
    from gpbayestools_hic_tpu_torch.ops import fused_predict as fp

    rng = np.random.default_rng(33)
    ndim, nev, nobs = 33, 60, 5
    design = rng.uniform(0, 1, size=(nev, ndim))
    base = 2.0 + np.sin(design @ rng.uniform(0.2, 0.5, size=(ndim, nobs)))
    pkl = tmp_path / "train.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({str(i): {"parameter": design[i],
                              "obs": np.stack([base[i], 0.01 * np.abs(base[i])])}
                     for i in range(nev)}, f)
    par = tmp_path / "pars.txt"
    par.write_text("".join(f"p{i}: $p_{i}$, 0.0, 1.0\n" for i in range(ndim)))
    je = JEmulator(str(pkl), str(par), npc=3, gp_maxiter=0)
    je.trainEmulator(np.ones(nev, dtype=bool))
    path = tmp_path / "emu.pkl"
    je.save(str(path))
    assert not fp.fused_eligible("RBF", ndim, torch.float32)
    e32 = Emulator.load(str(path), device="cpu")
    assert e32._dtype == torch.float32 and e32._fused is None
    X = rng.uniform(0.05, 0.95, size=(7, ndim))
    gm, gv = e32.predict_pc_raw_fastgrad(torch.tensor(X, dtype=torch.float32))
    jgm, jgv = je.predict_pc_raw_pure_fastgrad(je.predict_state, X)
    np.testing.assert_allclose(gm.numpy(), np.asarray(jgm), atol=1e-4)
    np.testing.assert_allclose(gv.numpy(), np.asarray(jgv), atol=1e-4)
    mean, cov = e32.predict(X)
    jmean, jcov = je.predict(X)
    np.testing.assert_allclose(mean, jmean, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(cov, jcov, rtol=1e-3, atol=1e-6)


# ------------------------------------------------------------ training


@pytest.fixture(scope="module")
def pca_files(tmp_path_factory):
    """Training pickle + parameter file of a 20-parameter flagship-layout
    design (40 events, 6 observables), for parameterTrafoPCA."""
    tmp = tmp_path_factory.mktemp("emu_pca")
    rng = np.random.default_rng(11)
    nev, ndim, nobs = 40, 20, 6
    lo, hi = np.zeros(ndim), np.ones(ndim)
    lo[15:19], hi[15:19] = 0.01, 0.3
    lo[12:15], hi[12:15] = 0.01, 0.4
    lo[2:5], hi[2:5] = 0.5, 3.0
    design = lo + (hi - lo) * rng.uniform(size=(nev, ndim))
    base = 2.0 + np.sin(design @ rng.uniform(0.5, 1.5, size=(ndim, nobs)))
    pkl = tmp / "train.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({str(i): {"parameter": design[i],
                              "obs": np.stack([base[i], 0.01 * np.abs(base[i])])}
                     for i in range(nev)}, f)
    par = tmp / "pars.txt"
    par.write_text("".join(f"p{i}: $p_{i}$, {lo[i]}, {hi[i]}\n" for i in range(ndim)))
    return tmp, str(pkl), str(par), lo, hi


TRAINED = {  # name -> (which files, Emulator kwargs, kernel)
    "rbf30": ("toy", dict(gp_maxiter=30), "RBF"),
    "maternprod30": ("toy", dict(gp_maxiter=30), "MaternProd"),
    "pca30": ("pca", dict(gp_maxiter=30, parameterTrafoPCA=True), "RBF"),
}


@pytest.fixture(scope="module")
def jax_trained(toy_files, pca_files):
    """JAX emulators trained at gp_maxiter=30 on the files, once."""
    out = {}
    for name, (which, kw, kernel) in TRAINED.items():
        _, pkl, par = (toy_files if which == "toy" else pca_files[:3])
        e = JEmulator(pkl, par, npc=3, **kw)
        e.trainEmulator(np.ones(e.nev, dtype=bool), kernel_type=kernel)
        out[name] = e
    return out


@pytest.fixture(scope="module")
def jax_pca_save(jax_trained, pca_files):
    path = pca_files[0] / "jax_pca.pkl"
    jax_trained["pca30"].save(str(path))
    return jax_trained["pca30"], str(path)


def _query(which, m, seed):
    rng = np.random.default_rng(seed)
    if which == "toy":
        return rng.uniform(0.05, 0.95, size=(m, 3))
    design = rng.uniform(size=(m, 20))
    design[:, 15:19] = 0.01 + 0.29 * design[:, 15:19]
    design[:, 12:15] = 0.01 + 0.39 * design[:, 12:15]
    design[:, 2:5] = 0.5 + 2.5 * design[:, 2:5]
    return design


@pytest.mark.parametrize("name", list(TRAINED))
def test_port_training_matches_jax(toy_files, pca_files, jax_trained, name):
    """An Emulator trained by the port (gp_maxiter=30, float64) on the
    pickle the JAX Emulator trained on: the fitted GP state (LML to 1e-6,
    log-hyperparameters to 1e-5: optimizer tolerance), the parameter-PCA
    design, and predict's mean and covariance (1e-6 relative: the optima
    agree to 1e-5 in the hyperparameters)."""
    which, kw, kernel = TRAINED[name]
    _, pkl, par = toy_files if which == "toy" else pca_files[:3]
    e = Emulator(pkl, par, npc=3, **kw, **F64)
    e.trainEmulator(np.ones(e.nev, dtype=bool), kernel_type=kernel)
    je = jax_trained[name]
    np.testing.assert_allclose(e.gp_state.lml.numpy(), np.asarray(je.gp_state.lml),
                               rtol=0, atol=1e-6)
    for k in ("log_amp", "log_ls", "log_noise"):
        np.testing.assert_allclose(e.gp_state.params[k].numpy(),
                                   np.asarray(je.gp_state.params[k]), rtol=0, atol=1e-5)
    if e.parameterTrafoPCA_:
        np.testing.assert_allclose(e.PCA_new_design_points, je.PCA_new_design_points,
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(e.design_max, je.design_max, rtol=1e-10, atol=1e-12)
    X = _query(which, 6, 1)
    mean, cov = e.predict(X)
    jmean, jcov = je.predict(X)
    np.testing.assert_allclose(mean, jmean, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(cov, jcov, rtol=1e-6, atol=1e-8)
    gm, gv = e.predict_pc_raw_fastgrad(torch.tensor(X))
    jgm, jgv = je.predict_pc_raw_pure_fastgrad(je.predict_state, X)
    np.testing.assert_allclose(gm.numpy(), np.asarray(jgm), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(gv.numpy(), np.asarray(jgv), rtol=1e-6, atol=1e-8)


def test_joint_training_equals_each_emulator_alone_and_jax(tmp_path):
    """train_emulators_jointly (one fit over both emulators' GPs) gives
    each emulator what its own trainEmulator gives (LML rtol 1e-4, the
    JAX package's own joint-vs-individual check), and the JAX joint fit
    (LML to 1e-6, log-hyperparameters to 1e-5); its checks refuse a
    different design."""
    from gpbayestools_hic_tpu.models import train_emulators_jointly as j_joint
    from gpbayestools_hic_tpu_torch.models import train_emulators_jointly

    rng = np.random.default_rng(5)
    design = rng.uniform(0, 1, size=(30, 3))
    par = tmp_path / "p.txt"
    par.write_text("".join(f"p{i}: $p_{i}$, 0.0, 1.0\n" for i in range(3)))
    pkls = []
    for b, nobs in enumerate((4, 5)):
        base = 2.0 + np.sin(design @ rng.uniform(1, 2.5, size=(3, nobs)))
        pkl = tmp_path / f"t{b}.pkl"
        with open(pkl, "wb") as f:
            pickle.dump({str(i): {"parameter": design[i],
                                  "obs": np.stack([base[i], 0.01 * np.abs(base[i])])}
                         for i in range(30)}, f)
        pkls.append(str(pkl))

    def emus(cls, **kw):
        return [cls(p, str(par), npc=2, gp_maxiter=30, **kw) for p in pkls]

    joint = emus(Emulator, **F64)
    stats = {}
    train_emulators_jointly(joint, stats=stats)
    assert stats["iterations"] > 0 and stats["host_syncs"] == stats["trials"]
    alone = emus(Emulator, **F64)
    for e in alone:
        e.trainEmulatorAutoMask()
    jjoint = emus(JEmulator)
    j_joint(jjoint)
    X = np.random.default_rng(6).uniform(0.05, 0.95, size=(4, 3))
    for e, a, je in zip(joint, alone, jjoint):
        np.testing.assert_allclose(e.gp_state.lml.numpy(), a.gp_state.lml.numpy(), rtol=1e-4)
        np.testing.assert_allclose(e.gp_state.lml.numpy(), np.asarray(je.gp_state.lml),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(e.gp_state.params["log_ls"].numpy(),
                                   np.asarray(je.gp_state.params["log_ls"]), rtol=0, atol=1e-5)
        np.testing.assert_allclose(e.predict(X)[0], je.predict(X)[0], rtol=1e-6)
    other = emus(Emulator, **F64)
    other[1].design_points = other[1].design_points + 0.1
    with pytest.raises(ValueError, match="design"):
        train_emulators_jointly(other)
    mixed = emus(Emulator, **F64)
    mixed[1].seed = 3
    with pytest.raises(ValueError, match="seed"):
        train_emulators_jointly(mixed)


def test_sample_y_moments_and_random_state(toy_files):
    """sample_y draws (m, n_samples, nobs) whose mean and covariance match
    predict (3000 draws: mean to 0.05 of the spread, covariance to 15%);
    an int seed reproduces, None draws afresh, a bad type raises."""
    _, pkl, par = toy_files
    e = Emulator(pkl, par, npc=3, gp_maxiter=30, **F64)
    e.trainEmulatorAutoMask()
    X = _query("toy", 3, 2)
    draws = e.sample_y(X, n_samples=3000, random_state=0)
    assert draws.shape == (3, 3000, 6) and np.isfinite(draws).all()
    mean, cov = e.predict(X)
    sd = np.sqrt(np.diagonal(cov, axis1=1, axis2=2))
    np.testing.assert_allclose(draws.mean(1), mean, atol=0.05 * sd.max())
    for i in range(3):
        np.testing.assert_allclose(np.cov(draws[i].T), cov[i], rtol=0.15,
                                   atol=0.15 * np.abs(cov[i]).max())
    np.testing.assert_array_equal(e.sample_y(X, 5, random_state=7), e.sample_y(X, 5, random_state=7))
    np.testing.assert_array_equal(e.sample_y(X, 5, random_state=np.random.default_rng(1)),
                                  e.sample_y(X, 5, random_state=np.random.default_rng(1)))
    assert not np.array_equal(e.sample_y(X, 5), e.sample_y(X, 5))
    with pytest.raises(TypeError, match="random_state"):
        e.sample_y(X, 5, random_state="seed")


def test_port_save_loads_in_jax_without_the_port(pca_files, tmp_path):
    """A port-trained emulator with parameter PCA, saved by the port, is
    loaded by the JAX package's Emulator.load in a fresh process that
    never imports the port, and predicts what the port predicts (1e-10,
    float64); the port loads its own save back the same."""
    _, pkl, par = pca_files[:3]
    e = Emulator(pkl, par, npc=3, gp_maxiter=10, parameterTrafoPCA=True, **F64)
    e.gp_map_prior_strength = 0.2
    e.trainEmulatorAutoMask()
    path, out = tmp_path / "port.pkl", tmp_path / "jax_pred.npz"
    e.save(str(path))
    X = _query("pca", 5, 3)
    np.save(tmp_path / "X.npy", X)
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "jax.config.update('jax_enable_x64', True)\n"
        "from gpbayestools_hic_tpu.models import Emulator\n"
        f"e = Emulator.load({str(path)!r})\n"
        f"X = np.load({str(tmp_path / 'X.npy')!r})\n"
        "m, c = e.predict(X)\n"
        "assert e.gp_config.map_prior_strength == 0.2\n"
        f"np.savez({str(out)!r}, m=m, c=c)\n"
        "bad = [k for k in sys.modules if k.startswith('gpbayestools_hic_tpu_torch')]\n"
        "assert not bad, bad\n"
        "print('jax-loaded')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "jax-loaded" in res.stdout
    mean, cov = e.predict(X)
    ref = np.load(out)
    np.testing.assert_allclose(ref["m"], mean, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ref["c"], cov, rtol=1e-10, atol=1e-12)
    back = Emulator.load(str(path), **F64)
    assert back.gp_config.map_prior_strength == 0.2
    np.testing.assert_allclose(back.predict(X)[1], cov, rtol=1e-12, atol=1e-14)


def test_jax_param_pca_save_loads_in_the_port(jax_pca_save):
    """A JAX save with a ParamPCAState loads in the port (the class mapped
    onto the port's) and predicts as the JAX emulator does (1e-10, float64,
    same factors), in every predict entry."""
    je, path = jax_pca_save
    e = Emulator.load(path, **F64)
    assert type(e.param_pca_state).__module__.startswith("gpbayestools_hic_tpu_torch")
    X = _query("pca", 6, 4)
    mean, cov = e.predict(X)
    jmean, jcov = je.predict(X)
    np.testing.assert_allclose(mean, jmean, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(cov, jcov, rtol=1e-10, atol=1e-12)
    dm, dv = e.predict_diag(torch.tensor(X))
    jdm, jdv = je.predict_diag_device(jnp_array(X))
    np.testing.assert_allclose(dv.numpy(), np.asarray(jdv), rtol=1e-10, atol=1e-12)
    for fast in (False, True):
        gm, gv = (e.predict_pc_raw_fastgrad if fast else e.predict_pc_raw)(torch.tensor(X))
        jfn = je.predict_pc_raw_pure_fastgrad if fast else je.predict_pc_raw_pure
        jgm, jgv = jfn(je.predict_state, X)
        np.testing.assert_allclose(gm.numpy(), np.asarray(jgm), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(gv.numpy(), np.asarray(jgv), rtol=1e-10, atol=1e-12)


def jnp_array(x):
    import jax.numpy as jnp

    return jnp.asarray(x)
