"""The calibration problem of one run, and the port's chain built from it.

:func:`make_problem`: the configuration fixes one problem, drawn on the
host from its ``problem_seed`` (numpy): the design (uniform in the unit
box), the experimental truth point, the synthetic physics' frequencies
(``obs = 2 + sin(design @ freqs)``), the training and experimental errors
and each GP's hyperparameters within the configuration's
``hyper_ranges``.  The run's ``--seed`` then hands the program that
problem in another order: the design points, the parameters (the design's
columns, the truth, the frequencies' rows and the length scales alike)
and the observables within each block are permuted.  Every seed thus
poses the same posterior up to a relabelling of its axes, with the same
sizes, and the sampler's own draws (start points, streams) come from the
seed too; a fresh problem per seed changed the posterior's geometry and
with it HMC's autocorrelation time from 1.0 to 2.4 (PERF.md).

:func:`build_chain` hands the problem to the port as a user with known
hyperparameters would: reference-format training and experimental
pickles (``utils/synthetic.py``'s writers) under a temporary directory,
one ``Emulator`` per block (scaler and PCA as in training), the GP factors
from the known-hyperparameter path ``models/gp.py::finalize_gp_state``
(the port's own training step without the optimizer), then ``Chain`` and
``loadEmulator``.  The reference (``benchmark/reference``) reads only the
problem.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def base_problem(cfg: dict) -> dict:
    """The configuration's one problem, float64 numpy, from its
    ``problem_seed``."""
    d, n, npc = int(cfg["ndim"]), int(cfg["n_design"]), int(cfg["npc"])
    nobs = sum(int(b) for b in cfg["blocks"])
    ngp = npc * len(cfg["blocks"])
    phys = cfg["physics"]
    hr = cfg["hyper_ranges"]
    rng = np.random.default_rng(int(cfg["problem_seed"]))
    design = rng.uniform(0.0, 1.0, (n, d))
    truth = rng.uniform(*phys["truth_range"], d)
    freqs = rng.uniform(*phys["freq_range"], (d, nobs))
    outputs = 2.0 + np.sin(design @ freqs)
    exp_mean = 2.0 + np.sin(truth @ freqs)
    return {
        "design": design,
        "outputs": outputs,
        "train_err": phys["train_err_frac"] * np.abs(outputs),
        "exp_mean": exp_mean,
        "exp_err": phys["exp_err_frac"] * np.abs(exp_mean),
        "truth": truth,
        "lo": np.zeros(d),
        "hi": np.ones(d),
        "hyper": {
            "log_amp": rng.uniform(*hr["log_amp"], ngp),
            "log_ls": rng.uniform(*hr["log_ls"], (ngp, d)),
            "log_noise": rng.uniform(*hr["log_noise"], ngp),
        },
    }


def make_problem(cfg: dict, seed: int) -> dict:
    """The configuration's problem in the order that ``seed`` draws."""
    base = base_problem(cfg)
    rng = np.random.default_rng(int(seed))
    n, d = base["design"].shape
    rows = rng.permutation(n)
    cols = rng.permutation(d)
    obs = []
    i0 = 0
    for nobs in cfg["blocks"]:
        obs.append(i0 + rng.permutation(int(nobs)))
        i0 += int(nobs)
    obs = np.concatenate(obs)
    hyper = base["hyper"]
    return {
        "design": base["design"][rows][:, cols],
        "outputs": base["outputs"][rows][:, obs],
        "train_err": base["train_err"][rows][:, obs],
        "exp_mean": base["exp_mean"][obs],
        "exp_err": base["exp_err"][obs],
        "truth": base["truth"][cols],
        "lo": base["lo"][cols],
        "hi": base["hi"][cols],
        "hyper": {"log_amp": hyper["log_amp"], "log_ls": hyper["log_ls"][:, cols],
                  "log_noise": hyper["log_noise"]},
    }


def build_chain(problem: dict, cfg: dict, tmpdir: str, device, mode: str,
                dtype=torch.float32):
    """The port's ``Chain`` over the problem, on ``device`` in ``dtype`` (the
    cells run float32; the tests also float64 on the CPU), with
    ``likelihood_mode = mode``."""
    from gpbayestools_hic_tpu_torch.models.emulator import Emulator
    from gpbayestools_hic_tpu_torch.models.gp import finalize_gp_state
    from gpbayestools_hic_tpu_torch.samplers.chain import Chain
    from gpbayestools_hic_tpu_torch.utils.synthetic import (
        write_exp_pickle, write_parameter_file, write_training_pickle,
    )

    npc = int(cfg["npc"])
    d = int(cfg["ndim"])
    parfile = write_parameter_file(os.path.join(tmpdir, "pars.txt"), d)
    hyper = problem["hyper"]
    emus = []
    i0 = 0
    for b, nobs in enumerate(cfg["blocks"]):
        i1 = i0 + int(nobs)
        pkl = write_training_pickle(
            os.path.join(tmpdir, f"train{b}.pkl"), problem["design"],
            problem["outputs"][:, i0:i1], problem["train_err"][:, i0:i1])
        emu = Emulator(pkl, parfile, npc=npc, gp_maxiter=0, device=device, dtype=dtype)
        emu.gp_alpha = float(cfg.get("gp_alpha", 0.1))
        emu.gp_grad_precision = cfg.get("grad_precision", "default")
        x, z_t, _, noise_diag = emu._prepare_training(np.ones(emu.nev, dtype=bool),
                                                      cfg.get("kernel", "RBF"))
        gps = slice(b * npc, (b + 1) * npc)

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        params = {"log_amp": t(hyper["log_amp"][gps]), "log_ls": t(hyper["log_ls"][gps]),
                  "log_noise": t(hyper["log_noise"][gps])}
        emu._finalize_training(finalize_gp_state(params, x, z_t, emu.gp_config, noise_diag))
        emus.append(emu)
        i0 = i1
    exp_pkl = write_exp_pickle(os.path.join(tmpdir, "exp.pkl"), problem["exp_mean"],
                               problem["exp_err"])
    chain = Chain(mcmc_path=os.path.join(tmpdir, "mcmc", "chain.pkl"),
                  expdata_path=exp_pkl, model_parafile=parfile,
                  device=device, dtype=dtype)
    chain.loadEmulator(emus)
    chain.likelihood_mode = mode
    return chain
