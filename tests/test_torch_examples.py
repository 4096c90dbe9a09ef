"""The ``examples_torch/`` workflow on the CPU at tiny sizes: the scripts
themselves, in their documented order, each with ``device="cpu"`` and the
sizes cut through their keyword arguments (the scripts' defaults are the
workflow's real sizes)."""

import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest
import torch

EXAMPLES = Path(__file__).resolve().parent.parent / "examples_torch"
SMALL_SMC = dict(n_effective=100, n_active=50, n_prior=200, n_max_steps=5, n_total=300,
                 n_evidence=200, flow_fit_steps=40)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tensors are tiny and the suite runs in
    parallel worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name):
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The dataset and the trained emulators (steps 1 and 3), made once."""
    tmp = tmp_path_factory.mktemp("examples_torch")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        _load("make_synthetic_dataset").main(npoints=40)
        _load("emulator_training").main(device="cpu", gp_maxiter=10)
        yield tmp
    finally:
        os.chdir(cwd)


@pytest.fixture
def in_workdir(workdir, monkeypatch):
    monkeypatch.chdir(workdir)
    return workdir / "synthetic_data"


def test_dataset_and_training(in_workdir):
    for group in ("dNdy", "meanpT", "vn"):
        assert (in_workdir / f"emulator_sklearn_{group}.sav").exists()
        assert (in_workdir / f"emulator_pcsk_{group}.sav").exists()
    assert np.loadtxt(in_workdir / "truth_parameters.txt").shape == (6,)


def test_lhd(tmp_path, monkeypatch):
    import gpbayestools_hic_tpu_torch.runtime as rt

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(rt, "workdir", tmp_path)
    _load("generate_LHD_Bayes").main(npoints=20, device="cpu")
    assert len(list((tmp_path / "design_points" / "main").iterdir())) == 20


def test_validation(in_workdir):
    _load("emulator_validation").main(n_test_points=8, test_sizes=(5, 10), device="cpu",
                                      gp_maxiter=5)
    lines = (in_workdir / "validation_dNdy.csv").read_text().splitlines()
    assert lines[0] == "variant,observable,E,H" and len(lines) == 1 + 3 * 10


def test_analysis_refuses_several_devices(in_workdir):
    """More devices than the machine has (none here) raise before the
    emulators are loaded."""
    with pytest.raises(ValueError, match="requested 2 devices but only 0 available"):
        _load("run_bayesian_analysis").main("HMC", devices=2, device="cpu")


def test_sampling_plots_closure_sensitivity_clusters(in_workdir):
    """HMC and a small pocoMC run, then the plots, the closure test, the
    sensitivity study and the posterior clusters, all reading what the
    earlier steps wrote."""
    pytest.importorskip("matplotlib")
    from gpbayestools_hic_tpu_torch.samplers.flows import FlowConfig

    analysis = _load("run_bayesian_analysis")
    analysis.main("HMC", device="cpu", nsteps=8, nwalkers=16, nburnsteps=8, n_leapfrog=4)
    analysis.main("pocoMC", device="cpu", flow_config=FlowConfig(n_layers=2, hidden=16),
                  **SMALL_SMC)
    assert (in_workdir / "mcmc" / "chain_hmc.pkl").exists()
    assert (in_workdir / "mcmc" / "chain_smc.pkl").exists()

    _load("plot_mcmc").main(device="cpu")
    _load("closure_test").main(device="cpu")
    for name in ("plot_trace", "plot_corner", "plot_eta_band", "corner", "closure_ppc"):
        assert (in_workdir / f"{name}.png").exists(), name

    s_ad, s_fd = _load("sensitivity_analysis").main(device="cpu")
    assert s_ad.shape == (10, 6) and np.isfinite(s_ad).all()
    assert np.abs(s_ad - s_fd).max() < 0.05

    _load("generate_posterior_clusters").main(n_top_samples=100, device="cpu")
    assert np.loadtxt(in_workdir / "cluster_centers.txt").shape == (6, 3)
    obs = np.loadtxt(in_workdir / "cluster_observables.txt")
    assert obs.shape == (24, 3) and np.isfinite(obs).all()


def test_analysis_on_a_cpu_mesh_of_two(in_workdir):
    """The analysis script with a mesh (two shards on the CPU) passed
    through to the sampler: the ensemble sampler's chain file has the
    contract's shape and finite samples."""
    import pickle

    from gpbayestools_hic_tpu_torch.parallel import WalkerMesh

    _load("run_bayesian_analysis").main(
        "emcee", device="cpu", mesh=WalkerMesh(["cpu"] * 2), nsteps=8, nburnsteps=8,
        nwalkers=16, nthin=1)
    with open(in_workdir / "mcmc" / "chain_ensemble.pkl", "rb") as f:
        chain = pickle.load(f)["chain"]
    assert chain.shape == (16, 8, 6) and np.isfinite(chain).all()
