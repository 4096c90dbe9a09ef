"""PyTorch port: the BAND emulator heads (PCGP, PCSK, PCGPwImpute, PCGPwM)
against the JAX package's ``EmulatorBAND`` on the CPU in float64, the golden
fixture, save files across the two packages, joint training with unequal
PC counts, and a PCSK RBF head's fused predict."""

import os
import pickle

import numpy as np
import pytest
import torch

from gpbayestools_hic_tpu.models import Emulator as JEmulator
from gpbayestools_hic_tpu.models import EmulatorBAND as JBAND
from gpbayestools_hic_tpu.models.joint import train_emulators_jointly as j_joint
from gpbayestools_hic_tpu_torch.models import Emulator, EmulatorBAND
from gpbayestools_hic_tpu_torch.models.joint import train_emulators_jointly

F64 = dict(device="cpu", dtype=torch.float64)
# the optimizers of both packages take the same path (hyperparameters within
# 1e-9) for 10 iterations on these problems; later, rounding-level
# differences grow (3.5e-8 at 15 iterations on the PCSK RBF head), and a
# line-search acceptance at the rounding level can end a lane in one
# package and not the other
MAXITER = 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tensors are tiny and the suite runs in
    parallel worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dataset(rng, nev=40, ndim=3, nobs=8, err_level=0.01):
    design = rng.uniform(0, 1, size=(nev, ndim))
    freqs = rng.uniform(1, 3, size=(ndim, nobs))
    base = 2.0 + np.sin(design @ freqs) + 0.3 * (design**2) @ freqs
    err = err_level * np.abs(base) * rng.uniform(0.5, 1.0, size=base.shape)
    return design, base, np.abs(err)


def _write(tmp, tag, design, base, err):
    pkl = tmp / f"{tag}.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({str(i): {"parameter": design[i], "obs": np.stack([base[i], err[i]])}
                     for i in range(design.shape[0])}, f)
    par = tmp / f"{tag}_pars.txt"
    par.write_text("".join(f"p{i}: $p_{i}$, 0.0, 1.0\n" for i in range(design.shape[1])))
    return str(pkl), str(par)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Clean data, and data with NaNs (two in training rows) for the
    impute heads."""
    tmp = tmp_path_factory.mktemp("band")
    design, base, err = _dataset(np.random.default_rng(42))
    holed = base.copy()
    holed[3, 1] = np.nan
    holed[11, 5] = np.nan
    return {"clean": _write(tmp, "clean", design, base, err),
            "holed": _write(tmp, "holed", design, holed, err),
            "design": design, "base": base, "tmp": tmp}


HEADS = {
    "PCGP": dict(method="PCGP"),
    "PCSK": dict(method="PCSK"),
    "PCGPwImpute": dict(method="PCGPwImpute", max_rel_uncertainty_data=10.0),
    "PCGPwM": dict(method="PCGPwM", max_rel_uncertainty_data=10.0),
    "PCSK-RBF": dict(method="PCSK", kernel_kind="RBF"),
}


def _pair(files, name, **extra):
    kw = {**HEADS[name], "gp_maxiter": MAXITER, **extra}
    data = "holed" if "Impute" in kw["method"] or kw["method"] == "PCGPwM" else "clean"
    pkl, par = files[data]
    je, pe = JBAND(pkl, par, **kw), EmulatorBAND(pkl, par, **kw, **F64)
    je.trainEmulatorAutoMask()
    pe.trainEmulatorAutoMask()
    return je, pe


@pytest.mark.parametrize("name", list(HEADS))
def test_head_matches_jax(files, name):
    """Kept PCs, the PC-space noise diagonal, the fitted hyperparameters
    (1e-8), and predict mean and covariance (1e-8 relative) equal the JAX
    head's on the same data."""
    je, pe = _pair(files, name)
    assert pe._npc_used == je._npc_used < 8
    mask = np.ones(pe.nev, dtype=bool)
    nd_j = je._pc_noise_diag(mask, je._npc_used)
    nd_p = pe._pc_noise_diag(mask, pe._npc_used)
    if nd_j is None:
        assert nd_p is None
    else:
        assert nd_p.device.type == "cpu" and nd_p.dtype == torch.float64
        np.testing.assert_allclose(nd_p.numpy(), np.asarray(nd_j), rtol=1e-12, atol=1e-15)
    for k in ("log_amp", "log_ls", "log_noise"):
        np.testing.assert_allclose(pe.gp_state.params[k].numpy(),
                                   np.asarray(je.gp_state.params[k]), rtol=0, atol=1e-8,
                                   err_msg=k)
    x = files["design"][:5] * 0.9 + 0.05
    (mj, cj), (mp, cp) = je.predict(x), pe.predict(x)
    np.testing.assert_allclose(mp, mj, rtol=1e-8)
    np.testing.assert_allclose(cp, cj, rtol=1e-8, atol=1e-12)
    mt, ct = pe.predict_test_emu_errors(None, x)
    assert mt.shape == (pe.nobs, 5) and ct.shape == (5, pe.nobs, pe.nobs)


def test_unknown_method_or_kernel_raises(files):
    pkl, par = files["clean"]
    with pytest.raises(ValueError, match="not implemented"):
        EmulatorBAND(pkl, par, method="NoSuchMethod", **F64)
    with pytest.raises(ValueError, match="kernel"):
        EmulatorBAND(pkl, par, kernel_kind="Cubic", **F64)


# the golden fixture (tools/make_golden_fixtures.py, JAX package, x64) at
# the default gp_maxiter=200.  The JAX test holds hyperparameters to 1e-5,
# means to 1e-6 and variances to 1e-5 relative.  The two packages' fits
# agree to 1e-11 for the first 20 iterations on this data; later one GP
# lane of each variant ends its run a few iterations apart from JAX's (a
# line-search acceptance at the rounding level), and the fixture pins
# where the JAX lane stopped.  Measured gaps
# (relative): PCGP hyperparameters 2.8e-3, mean 1.2e-5, variance 6.6e-5;
# PCSK 1.7e-2, 1.7e-4, 1.0e-3; PCGP_surmise 1.3e-2, 4.0e-5, 4.4e-4.  The
# tolerances are about twice those.
GOLDEN = {
    "PCGP": (dict(method="PCGP"), 6e-3, 3e-5, 1.5e-4),
    "PCSK": (dict(method="PCSK"), 4e-2, 4e-4, 2.5e-3),
    "PCGP_surmise": (dict(method="PCGP", kernel_kind="MaternProd", map_prior_strength=1.0),
                     3e-2, 1e-4, 1e-3),
}


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    fix = np.load(os.path.join(os.path.dirname(__file__), "fixtures", "band_golden.npz"))
    pkl, par = _write(tmp_path_factory.mktemp("golden"), "golden", fix["design"], fix["base"],
                      fix["err"])
    heads = {}
    for tag, (kw, *_) in GOLDEN.items():
        heads[tag] = EmulatorBAND(pkl, par, **kw, **F64)
        heads[tag].trainEmulatorAutoMask()
    return fix, heads


@pytest.mark.parametrize("tag", list(GOLDEN))
def test_heads_match_golden_fixture(golden, tag):
    """The port's heads against the committed golden arrays at the measured
    gaps above; PCSK and the surmise kernel family are not aliases of
    PCGP."""
    fix, heads = golden
    _, tol_par, tol_mean, tol_var = GOLDEN[tag]
    emu = heads[tag]
    assert emu._npc_used == int(fix[f"{tag}_npc"])
    for k in ("log_ls", "log_amp", "log_noise"):
        np.testing.assert_allclose(emu.gp_state.params[k].numpy(), fix[f"{tag}_{k}"],
                                   rtol=tol_par, err_msg=f"{tag} {k}")
    mean, cov = emu.predict(fix["xq"])
    np.testing.assert_allclose(mean, fix[f"{tag}_mean"], rtol=tol_mean)
    np.testing.assert_allclose(np.diagonal(cov, axis1=1, axis2=2), fix[f"{tag}_covdiag"],
                               rtol=tol_var, atol=1e-12)
    if tag != "PCGP":
        pcgp = heads["PCGP"].predict(fix["xq"], return_cov=False)
        assert np.max(np.abs(mean - pcgp)) > (1e-4 if tag == "PCSK" else 1e-6)


def test_impute_does_not_leak_holdout_rows(files, tmp_path):
    """Perturbing the held-out rows leaves the imputed training fit bit for
    bit unchanged; the held-out imputed truth is NaN in the validation
    arrays, as in the JAX package."""
    design, base = files["design"], files["base"]
    states = []
    for tag, bump in (("a", 0.0), ("b", 3.0)):
        data = base.copy()
        data[5, 2] = np.nan
        data[-1, 4] = np.nan
        data[-3:, :] += bump
        pkl, par = _write(tmp_path, tag, design, data, 0.01 * np.abs(base))
        emu = EmulatorBAND(pkl, par, method="PCGPwImpute", gp_maxiter=MAXITER,
                           max_rel_uncertainty_data=100.0, **F64)
        pred, _, truth, _ = emu.testEmulatorErrors(number_test_points=3)
        assert np.isnan(truth[-1, 4]) and np.isfinite(pred).all()
        states.append({k: v.clone() for k, v in emu.gp_state.params.items()})
    for k in states[0]:
        assert torch.equal(states[0][k], states[1][k]), k
    # the JAX head on the same (unperturbed) data: the same arrays
    je = JBAND(pkl, par, method="PCGPwImpute", gp_maxiter=MAXITER, max_rel_uncertainty_data=100.0)
    jarrs = je.testEmulatorErrors(number_test_points=3)
    for a, b in zip(emu.testEmulatorErrors(number_test_points=3), jarrs):
        np.testing.assert_allclose(a, b, rtol=1e-8, equal_nan=True)


@pytest.mark.parametrize("name", ["PCSK", "PCGPwM"])
def test_band_saves_load_across_packages(files, name):
    """A port BAND save loads in the JAX package as an EmulatorBAND and a
    JAX save in the port, both predicting as the saver did (1e-10); the
    impute state survives, and a loaded PCGPwM head retrains with its
    noise inflation at the imputed rows."""
    je, pe = _pair(files, name)
    tmp = files["tmp"]
    pe.save(tmp / f"port_{name}.sav")
    je.save(str(tmp / f"jax_{name}.sav"))
    j_loaded = JEmulator.load(str(tmp / f"port_{name}.sav"))
    p_loaded = Emulator.load(tmp / f"jax_{name}.sav", **F64)
    assert type(j_loaded).__name__ == "EmulatorBAND" and isinstance(p_loaded, EmulatorBAND)
    assert p_loaded.method_ == j_loaded.method_ == name
    x = files["design"][:4]
    for got, want in ((j_loaded.predict(x), pe.predict(x)), (p_loaded.predict(x), je.predict(x))):
        np.testing.assert_allclose(got[0], want[0], rtol=1e-10)
        np.testing.assert_allclose(got[1], want[1], rtol=1e-10, atol=1e-14)
    if name == "PCGPwM":
        assert p_loaded._impute_mask[3, 1] and p_loaded._impute_mask[11, 5]
        assert j_loaded._impute_mask[3, 1] and j_loaded._impute_col_var[1] > 0
        p_loaded.trainEmulatorAutoMask()
        nd = p_loaded._pc_noise_diag(np.ones(p_loaded.nev, bool), p_loaded._npc_used).numpy()
        assert nd[:, 3].sum() > 0 and nd[:, 11].sum() > 0
        clean = [i for i in range(p_loaded.nev) if i not in (3, 11)]
        np.testing.assert_allclose(nd[:, clean], 0.0)
    with pytest.raises(ValueError, match="plain Emulator save"):
        pkl, par = files["clean"]
        plain = Emulator(pkl, par, npc=3, gp_maxiter=0, **F64)
        plain.trainEmulatorAutoMask()
        plain.save(tmp / "plain.sav")
        EmulatorBAND.load(tmp / "plain.sav", **F64)


def test_joint_training_with_unequal_npc(files, tmp_path):
    """Two PCSK heads on one design keep different PC counts; the joint fit
    gives each what it gets alone (bit for bit) and what the JAX package's
    joint fit gives (1e-8)."""
    design = files["design"]
    rng = np.random.default_rng(8)
    wide = 2.0 + np.sin(design @ rng.uniform(1, 3, size=(3, 12)))
    narrow = 2.0 + np.sin(design @ rng.uniform(0.5, 1, size=(3, 4)))
    sets = [_write(tmp_path, f"g{i}", design, b, 0.01 * np.abs(b))
            for i, b in enumerate((wide, narrow))]
    kw = dict(method="PCSK", gp_maxiter=MAXITER)
    port = [EmulatorBAND(pkl, par, **kw, **F64) for pkl, par in sets]
    jax_ = [JBAND(pkl, par, **kw) for pkl, par in sets]
    train_emulators_jointly(port)
    j_joint(jax_)
    assert port[0]._npc_used != port[1]._npc_used
    for (pkl, par), pe, je in zip(sets, port, jax_):
        alone = EmulatorBAND(pkl, par, **kw, **F64)
        alone.trainEmulatorAutoMask()
        for k in ("log_amp", "log_ls", "log_noise"):
            assert torch.equal(pe.gp_state.params[k], alone.gp_state.params[k]), k
            np.testing.assert_allclose(pe.gp_state.params[k].numpy(),
                                       np.asarray(je.gp_state.params[k]), rtol=0, atol=1e-8)
        np.testing.assert_allclose(pe.predict(design[:3])[0], je.predict(design[:3])[0],
                                   rtol=1e-8)


def test_pcsk_rbf_fused_predict(files):
    """A PCSK RBF head in float32 gets the fused state (its per-design noise
    is inside L^-1 and K^-1 y, kdiag is amp + the learned white level); its
    fused raw predict (the kernels' plain version on the CPU) matches its
    plain gp_predict in float32 (2e-5 relative to the largest value) and
    the JAX head's float64 predict (1e-4)."""
    je, _ = _pair(files, "PCSK-RBF")
    path = files["tmp"] / "pcsk_rbf.sav"
    je.save(str(path))
    e32 = Emulator.load(path, device="cpu", dtype=torch.float32)
    assert e32._fused is not None
    x = files["design"][:6] * 0.8 + 0.1
    xt = torch.tensor(x, dtype=torch.float32)
    fm, fv = e32.predict_pc_raw_fastgrad(xt)
    pm, pv = e32.predict_pc_raw(xt)
    jm, jv = je.predict_pc_raw_pure(je.predict_state, x)
    for got, want, scale in ((fm, pm, pm), (fv, pv, pv)):
        assert float((got - want).abs().max()) <= 2e-5 * float(scale.abs().max())
    for got, want in ((fm, jm), (fv, jv)):
        want = np.asarray(want)
        assert float(np.abs(got.double().numpy() - want).max()) <= 1e-4 * np.abs(want).max()


def test_woodbury_block_with_many_pcs():
    """The Woodbury block of an emulator that keeps 60 PCs (as the BAND
    heads do: 11 to 70 on the flagship's blocks) against the dense Gaussian
    log-likelihood it replaces: float64 to 1e-9; float32 to 5e-4 (measured
    7.1e-5 with the (M^-1 + V) form; the form that subtracts a Woodbury
    correction from d M d^T gave 3.8e-3 here, and 0.025 on the flagship's
    nine PCSK heads on the H100)."""
    from types import SimpleNamespace

    from gpbayestools_hic_tpu_torch.samplers.chain import make_lowrank_block, woodbury_blocks

    rng = np.random.default_rng(0)
    n, nobs, npc, m = 300, 170, 60, 64
    design = rng.uniform(size=(n, 17))
    data = 2 + np.sin(design @ rng.uniform(0.5, 2, (17, nobs)))
    mu, sd = data.mean(0), data.std(0)
    _, s, vt = np.linalg.svd((data - mu) / sd, full_matrices=False)
    trans = vt * (s / np.sqrt(n - 1))[:, None] * sd
    a, rest = trans[:npc], trans[npc:]
    cov_trunc = rest.T @ rest + np.diag(1e-4 * sd**2)
    exp_mean = mu + 0.1 * rng.normal(size=nobs)
    exp_var = (0.05 * np.abs(exp_mean)) ** 2
    gm, v = rng.normal(size=(m, npc)), rng.uniform(0.01, 0.3, (m, npc))

    class Head:
        scaler = SimpleNamespace(mean=mu)

        def lowrank_parts(self):
            return a, cov_trunc

        def predict_pc_parts_fastgrad(self, x):
            return torch.tensor(gm, dtype=x.dtype), torch.tensor(v, dtype=x.dtype), None

    want = []
    for i in range(m):
        chol = np.linalg.cholesky(a.T @ np.diag(v[i]) @ a + cov_trunc + np.diag(exp_var))
        w = np.linalg.solve(chol, gm[i] @ a + mu - exp_mean)
        want.append(-0.5 * w @ w - np.log(np.diag(chol)).sum())
    for dtype, tol in ((torch.float64, 1e-9), (torch.float32, 5e-4)):
        blk, bs = make_lowrank_block(Head(), exp_mean, exp_var, dtype, torch.device("cpu"))
        lp, _ = woodbury_blocks((bs,), (blk.predict(torch.zeros(m, 1, dtype=dtype)),))
        got = lp[:, 0].double().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=str(dtype))
