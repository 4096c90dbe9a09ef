"""PyTorch port: the analysis toolkit against the JAX package on the CPU in
float64 -- metrics, closure, io, the LHS design, k-means, sensitivity,
plotting and profiling.  Tolerances are stated per test."""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpbayestools_hic_tpu.runtime as jrt
import gpbayestools_hic_tpu_torch.runtime as prt
from gpbayestools_hic_tpu.design import lhd as jlhd
from gpbayestools_hic_tpu.models import Emulator as JEmulator
from gpbayestools_hic_tpu.utils import closure as jclosure
from gpbayestools_hic_tpu.utils import cluster as jcluster
from gpbayestools_hic_tpu.utils import io as jio
from gpbayestools_hic_tpu.utils import metrics as jmetrics
from gpbayestools_hic_tpu.utils.sensitivity import sensitivity_matrix as j_sensitivity
from gpbayestools_hic_tpu_torch.config import new_generator
from gpbayestools_hic_tpu_torch.design import Design, generate_lhs
from gpbayestools_hic_tpu_torch.design import lhd
from gpbayestools_hic_tpu_torch.models import Emulator
from gpbayestools_hic_tpu_torch.utils import closure, cluster, io, metrics
from gpbayestools_hic_tpu_torch.utils.profiling import device_trace, time_fn, timed
from gpbayestools_hic_tpu_torch.utils.sensitivity import sensitivity_matrix, sensitivity_matrix_fd

F64 = dict(device="cpu", dtype=torch.float64)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tensors are tiny and the suite runs in
    parallel worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ metrics


def test_validation_metrics_match_jax():
    """E, H, <log H>, coverage, Delta_d (weighted and not) and the summary
    table: the port's numpy copies equal the JAX package's (1e-15, NaN
    truth entries included)."""
    rng = np.random.default_rng(3)
    truth = rng.uniform(1, 2, (12, 5))
    truth[2, 3] = np.nan
    pred = truth * (1 + 0.05 * rng.normal(size=truth.shape))
    err = 0.04 * np.abs(rng.normal(size=truth.shape)) + 0.01
    np.testing.assert_allclose(metrics.rms_relative_error(pred, truth),
                               jmetrics.rms_relative_error(pred, truth), rtol=1e-15)
    np.testing.assert_allclose(metrics.honesty(pred, err, truth),
                               jmetrics.honesty(pred, err, truth), rtol=1e-15)
    assert metrics.mean_log_honesty(pred, err, truth) == jmetrics.mean_log_honesty(pred, err, truth)
    for ns in (1.0, 2.0):
        assert metrics.coverage(pred, err, truth, ns) == jmetrics.coverage(pred, err, truth, ns)
    chain = rng.uniform(0, 1, (4, 30, 3))
    w = rng.uniform(size=120)
    args = (chain, [0.5, 0.4, 0.6], [0, 0, -1], [1, 1, 1])
    assert metrics.delta_d(*args) == pytest.approx(jmetrics.delta_d(*args), rel=1e-15)
    assert metrics.delta_d(*args, weights=w) == pytest.approx(
        jmetrics.delta_d(*args, weights=w), rel=1e-15)
    walkers = rng.normal(size=(8, 60, 2))
    assert metrics.summary(walkers, names=["a", "b"]) == jmetrics.summary(walkers, names=["a", "b"])
    with pytest.raises(ValueError, match="names"):
        metrics.summary(walkers, names=["a"])


# ------------------------------------------------------------------ closure


def test_closure_helpers_match_jax():
    """Percentiles (weighted and not), the weighted quantile, the systematic
    resample and the posterior predictive equal the JAX package's on the
    same inputs (exact: the same numpy code and draws; the predictive to
    1e-12 through each package's emulator predict)."""
    rng = np.random.default_rng(4)
    chain = rng.normal(size=(6, 40, 3))
    w = rng.uniform(size=240)
    np.testing.assert_array_equal(closure.percentile_params(chain),
                                  jclosure.percentile_params(chain))
    np.testing.assert_array_equal(closure.percentile_params(chain, weights=w),
                                  jclosure.percentile_params(chain, weights=w))
    np.testing.assert_array_equal(closure.resample_weighted(chain, w, seed=2),
                                  jclosure.resample_weighted(chain, w, seed=2))
    with pytest.raises(ValueError, match="log-weights"):
        closure.weighted_quantile(chain[0, :, 0], -w[:40], (0.5,))

    class Linear:
        def __init__(self, a):
            self.a = a

        def predict(self, thetas, return_cov=False):
            return np.asarray(thetas) @ self.a

    emus = [Linear(rng.normal(size=(3, 4))), Linear(rng.normal(size=(3, 2)))]
    for kw in ({}, {"weights": w}):
        np.testing.assert_array_equal(
            closure.posterior_predictive(chain, emus, n_draws=9, seed=5, **kw),
            jclosure.posterior_predictive(chain, emus, n_draws=9, seed=5, **kw))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A JAX emulator (RBF, 4 PCs, 3 parameters) and its save loaded by the
    port in float64 and float32."""
    tmp = tmp_path_factory.mktemp("toolkit")
    rng = np.random.default_rng(11)
    design = rng.uniform(0.2, 1.0, size=(40, 3))
    base = 2.0 + np.sin(design @ rng.uniform(0.5, 1.5, size=(3, 6)))
    pkl = tmp / "t.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({str(i): {"parameter": design[i],
                              "obs": np.stack([base[i], 0.005 * np.abs(base[i])])}
                     for i in range(40)}, f)
    par = tmp / "p.txt"
    par.write_text("".join(f"p{i}: l, 0.2, 1.0\n" for i in range(3)))
    je = JEmulator(str(pkl), str(par), npc=4, gp_maxiter=10)
    je.trainEmulatorAutoMask()
    path = tmp / "e.sav"
    je.save(str(path))
    return (je, Emulator.load(path, **F64),
            Emulator.load(path, device="cpu", dtype=torch.float32), tmp, str(pkl), str(par))


def test_posterior_predictive_through_emulators_matches_jax(trained):
    """posterior_predictive through a loaded emulator: port float64 against
    the JAX emulator, 1e-12 relative."""
    je, e, *_ = trained
    chain = np.random.default_rng(1).uniform(0.3, 0.9, size=(8, 50, 3))
    np.testing.assert_allclose(closure.posterior_predictive(chain, [e], n_draws=5),
                               jclosure.posterior_predictive(chain, [je], n_draws=5),
                               rtol=1e-12)


# ---------------------------------------------------------------------- io


def test_delete_parameters_from_pickle_matches_jax(tmp_path):
    """Both packages write the same file from the same input."""
    rng = np.random.default_rng(2)
    design = rng.uniform(0, 1, size=(10, 5))
    data = {str(i): {"parameter": design[i], "obs": np.stack([np.ones(4), np.full(4, 0.01)])}
            for i in range(10)}
    src = tmp_path / "in.pkl"
    with open(src, "wb") as f:
        pickle.dump(data, f)
    assert io.delete_parameters_from_pickle(src, tmp_path / "p.pkl", [1, 3]) == 10
    jio.delete_parameters_from_pickle(src, tmp_path / "j.pkl", [1, 3])
    td = io.load_training_pickle(tmp_path / "p.pkl")
    np.testing.assert_array_equal(td.design_points, design[:, [0, 2, 4]])
    np.testing.assert_array_equal(td.design_points, jio.load_training_pickle(tmp_path / "j.pkl").design_points)


# ------------------------------------------------------------------ design


@pytest.mark.parametrize("energy", ["_maxpro_energy", "_maximin_energy", "_pairwise_logsq"])
def test_lhs_energies_match_jax(energy):
    """The MaxPro and maximin energies on the same x: 1e-12 relative."""
    x = np.random.default_rng(5).uniform(size=(25, 4))
    np.testing.assert_allclose(getattr(lhd, energy)(torch.tensor(x)).numpy(),
                               np.asarray(getattr(jlhd, energy)(jnp.asarray(x))), rtol=1e-12)


@pytest.mark.parametrize("method", ["maxpro", "maximin"])
def test_anneal_tracks_the_full_energy_and_stays_latin(method):
    """The annealer updates only rows i and j of the pairwise matrix; the
    energy it returns is the full energy of the design it returns (1e-12
    relative), the design is Latin and better than its start."""
    n, d = 20, 3
    gen = new_generator(CPU, 7)
    x0 = lhd._random_lhs(gen, n, d)
    x, e = lhd._anneal(gen, x0, niters=3000, criterion=method)
    full = lhd._maxpro_energy(x) if method == "maxpro" else lhd._maximin_energy(x)
    start = lhd._maxpro_energy(x0) if method == "maxpro" else lhd._maximin_energy(x0)
    assert float(e) == pytest.approx(float(full), rel=1e-12)
    assert float(e) < float(start)
    for k in range(d):
        assert sorted(np.floor(x[:, k].numpy() * n).astype(int).tolist()) == list(range(n))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_random_lhs_is_latin_in_its_dtype(dtype):
    """Each value lies inside its stratum after rounding to the dtype (the
    flagship's 1000 x 17 in float32)."""
    x = lhd._random_lhs(new_generator(CPU, 1), 1000, 17, dtype=dtype).double().numpy()
    for k in range(17):
        assert sorted(np.floor(x[:, k] * 1000).astype(int).tolist()) == list(range(1000))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_lhs_quality_matches_jax(seed):
    """Different streams, so quality not points: over seeds the port's
    maximin design beats random designs' minimum distance, and the port's
    MaxPro criterion is within log(2) of the JAX design's."""
    x = generate_lhs(30, 2, seed=seed, method="maximin", cache=False, device="cpu")
    rng = np.random.default_rng(seed)
    rand = np.mean([lhd.min_pairwise_distance(rng.uniform(size=(30, 2))) for _ in range(5)])
    assert lhd.min_pairwise_distance(x) > rand
    for k in range(2):
        assert sorted(np.floor(x[:, k] * 30).astype(int).tolist()) == list(range(30))
    ours = generate_lhs(16, 3, seed=seed, cache=False, device="cpu")
    theirs = np.asarray(jlhd.generate_lhs(16, 3, seed=seed, cache=False))
    e_ours = float(lhd._maxpro_energy(torch.tensor(ours)))
    e_jax = float(lhd._maxpro_energy(torch.tensor(theirs)))
    assert e_ours < e_jax + np.log(2.0), (e_ours, e_jax)


def test_lhs_cache_is_shared_with_jax(tmp_path, monkeypatch):
    """Both packages write and read cache/lhs/npoints{}_ndim{}_seed{}.npy:
    a design one made, the other loads unchanged; the default niters and
    the method are part of the name."""
    monkeypatch.setattr(prt, "workdir", tmp_path)
    monkeypatch.setattr(jrt, "workdir", tmp_path)
    x1 = generate_lhs(10, 2, seed=5, device="cpu")
    assert (tmp_path / "cache" / "lhs" / "npoints10_ndim2_seed5.npy").exists()
    np.testing.assert_array_equal(np.asarray(jlhd.generate_lhs(10, 2, seed=5)), x1)
    np.testing.assert_array_equal(generate_lhs(10, 2, seed=5, device="cpu"), x1)
    j2 = np.asarray(jlhd.generate_lhs(12, 2, seed=5, method="maximin"))
    np.testing.assert_array_equal(generate_lhs(12, 2, seed=5, method="maximin", device="cpu"), j2)
    assert not np.array_equal(generate_lhs(10, 2, seed=5, niters=500, device="cpu"), x1)
    with pytest.raises(ValueError, match="unknown LHS method"):
        generate_lhs(10, 2, seed=0, method="maxPro", device="cpu")


def test_design_class(toy_parfile, tmp_path, monkeypatch):
    """Design as the JAX package's: ranges, padded names, files, a fixed
    default seed; it asks for CUDA unless told otherwise."""
    monkeypatch.setattr(prt, "workdir", tmp_path)
    d = Design(toy_parfile, npoints=12, seed=7, device="cpu")
    arr = np.asarray(d)
    assert d.ndim == 3 and arr.shape == (12, 3) and d.points[0] == "parameter_00"
    assert (arr[:, 1] >= -2).all() and (arr[:, 2] <= 30).all()
    d.write_files(tmp_path)
    key, val = (tmp_path / "main" / "parameter_00").read_text().split("\n")[0].split()
    assert key == "p0" and np.isclose(float(val), arr[0, 0])
    np.testing.assert_array_equal(np.asarray(Design(toy_parfile, npoints=12, device="cpu")),
                                  np.asarray(Design(toy_parfile, npoints=12, device="cpu")))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Design(toy_parfile, npoints=12, seed=8)


# ------------------------------------------------------------------ cluster


def _jax_init(x, k, key, n_init):
    import jax

    return np.stack([np.asarray(jcluster._kmeans_pp_init(kk, jnp.asarray(x), k))
                     for kk in jax.random.split(key, n_init)])


@pytest.mark.parametrize("k,n_init", [(3, 5), (4, 2)])
def test_kmeans_matches_jax_from_the_same_starts(k, n_init):
    """From JAX's k-means++ starts, the port's Lloyd iterations (JAX's stop
    rule) give JAX's centers (1e-12), labels and inertia (1e-12)."""
    import jax

    rng = np.random.default_rng(k)
    x = np.concatenate([rng.normal(c, 0.8, size=(50, 3))
                        for c in ([0, 0, 0], [2, 2, 0], [-2, 1, 1])])
    key = jax.random.PRNGKey(k)
    cj, lj, ij = jcluster.kmeans(jnp.asarray(x), k, key=key, n_init=n_init)
    cp, lp, ip = cluster.kmeans(torch.tensor(x), k, init=_jax_init(x, k, key, n_init))
    np.testing.assert_allclose(cp.numpy(), np.asarray(cj), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(lp.numpy(), np.asarray(lj))
    assert float(ip) == pytest.approx(float(ij), rel=1e-12)


def test_kmeans_seeding_and_duplicates():
    """Seeding from an explicit generator is reproducible; all-duplicate
    points give finite centers and zero inertia; n < k raises."""
    x = torch.tensor(np.random.default_rng(0).normal(size=(60, 2)))
    a = cluster.kmeans(x, 3, generator=torch.Generator().manual_seed(3))
    b = cluster.kmeans(x, 3, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    c, _, inertia = cluster.kmeans(torch.full((20, 3), 2.5, dtype=torch.float64), 2, n_init=2)
    assert torch.isfinite(c).all() and float(inertia) == 0.0
    with pytest.raises(ValueError, match="n_clusters"):
        cluster.kmeans(x[:2], 3)


def test_posterior_cluster_workflow(tmp_path):
    """sort_chain_likelihood writes what the JAX one writes;
    generate_posterior_clusters writes one cluster per column, and on the
    CPU in float32 it matches float64 from the same starts (1e-5)."""
    rng = np.random.default_rng(9)
    chain = rng.normal(size=(500, 3))
    path = tmp_path / "chain.pkl"
    with open(path, "wb") as f:
        pickle.dump({"chain": chain, "weights": np.ones(500) / 500,
                     "logl": -np.sum(chain**2, axis=1), "logp": np.zeros(500)}, f)
    ours = cluster.sort_chain_likelihood(path, tmp_path / "p.pkl")
    theirs = jcluster.sort_chain_likelihood(path, tmp_path / "j.pkl")
    for key in theirs:
        np.testing.assert_array_equal(ours[key], theirs[key])
    c64, labels = cluster.generate_posterior_clusters(path, 2, n_top_samples=200,
                                                      output_dir=tmp_path, **F64)
    np.testing.assert_allclose(np.loadtxt(tmp_path / "cluster_centers.txt"), c64.T)
    c32, _ = cluster.generate_posterior_clusters(path, 2, n_top_samples=200,
                                                 output_dir=tmp_path / "f32", device="cpu")
    np.testing.assert_allclose(c32, c64, rtol=1e-5, atol=1e-6)
    assert labels.shape == (200,)


# ------------------------------------------------------------- sensitivity


def test_sensitivity_jacfwd_matches_jax(trained):
    """torch.func.jacfwd through the plain predict core, float64, against
    the JAX package's jax.jacfwd: 1e-8 absolute; central differences
    within the JAX test's 0.05; float32 within 1e-4 of float64."""
    je, e, e32, *_ = trained
    theta = np.array([0.6, 0.5, 0.7])
    s = sensitivity_matrix(e, theta)
    np.testing.assert_allclose(s, j_sensitivity(je, theta), rtol=0, atol=1e-8)
    np.testing.assert_allclose(s, sensitivity_matrix_fd(e, theta, rel_step=0.01), atol=0.05)
    np.testing.assert_allclose(sensitivity_matrix(e32, theta), s, rtol=0, atol=1e-4)


def test_sensitivity_through_param_pca_and_logtrafo(tmp_path):
    """jacfwd through the parameter-PCA transform (20 parameters) of a
    logTrafo emulator: against JAX's jacfwd at 1e-8."""
    rng = np.random.default_rng(6)
    lo, hi = np.zeros(20), np.ones(20)
    lo[15:19], hi[15:19] = 0.01, 0.3
    lo[12:15], hi[12:15] = 0.01, 0.4
    lo[2:5], hi[2:5] = 0.5, 3.0
    design = lo + (hi - lo) * rng.uniform(size=(30, 20))
    base = np.exp(1.0 + 0.5 * np.sin(design @ rng.uniform(0.3, 1.0, size=(20, 5))))
    pkl = tmp_path / "t.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({str(i): {"parameter": design[i],
                              "obs": np.stack([base[i], 0.01 * base[i]])} for i in range(30)}, f)
    par = tmp_path / "p.txt"
    par.write_text("".join(f"p{i}: l, {lo[i]}, {hi[i]}\n" for i in range(20)))
    je = JEmulator(str(pkl), str(par), npc=3, gp_maxiter=5, logTrafo=True,
                   parameterTrafoPCA=True)
    je.trainEmulatorAutoMask()
    je.save(str(tmp_path / "e.sav"))
    e = Emulator.load(tmp_path / "e.sav", **F64)
    theta = 0.5 * (lo + hi)
    np.testing.assert_allclose(sensitivity_matrix(e, theta), j_sensitivity(je, theta),
                               rtol=0, atol=1e-8)


# ------------------------------------------------------- plots, profiling


def test_plots_write_files(tmp_path):
    """Every plot writes its file; weights are checked as in the JAX
    package.  Skipped where matplotlib is not installed."""
    pytest.importorskip("matplotlib")
    from gpbayestools_hic_tpu_torch.models.param_pca import eta_over_s_vs_mu_B
    from gpbayestools_hic_tpu_torch.utils import plotting

    rng = np.random.default_rng(0)
    samples = rng.normal([0.5, 0.4, 0.3], 0.05, size=(400, 3))
    w = np.exp(5.0 * samples[:, 0])
    files = {name: tmp_path / f"{name}.png" for name in ("trace", "corner", "band", "obs")}
    plotting.trace_plot(samples, weights=w, fig_path=str(files["trace"]))
    plotting.corner_plot([samples, samples[:200]], weights=[w, None], chain_names=["a", "b"],
                         truths=[0.5, 0.4, 0.3], fig_path=str(files["corner"]))
    plotting.posterior_band_plot(eta_over_s_vs_mu_B, samples, np.linspace(1e-3, 0.6, 20),
                                 [0, 1, 2], n_samples=100, weights=w, truth_params=[0.5, 0.4, 0.3],
                                 fig_path=str(files["band"]))
    plotting.observables_plot(rng.normal(size=(5, 8)), np.zeros(8), np.ones(8),
                              obs_labels=[f"o{i}" for i in range(8)], fig_path=str(files["obs"]))
    assert all(f.exists() and f.stat().st_size > 0 for f in files.values())
    with pytest.raises(ValueError, match="aligned"):
        plotting.corner_plot([samples, samples], weights=w)


def test_timers_and_trace_on_the_cpu(tmp_path):
    """timed and time_fn measure a CPU computation (no device to wait for);
    device_trace writes a Chrome trace."""
    with timed("matmul") as t:
        t["result"] = {"y": torch.ones(50, 50) @ torch.ones(50, 50)}
    assert t["seconds"] > 0
    assert time_fn(lambda a: a @ a, torch.ones(30, 30), iters=3) > 0
    with device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(10, 10).sum()
    assert prof is not None and (tmp_path / "trace" / "trace.json").exists()
