"""The port's chain over PCSK emulator heads, built from a run's problem.

:func:`build_pcsk_chain` is ``problem.py::build_chain`` for a configuration
with ``method`` "PCSK": one ``EmulatorBAND(method="PCSK",
kernel_kind=<kernel>)`` per block over the same reference-format pickles,
each keeping the PCs that ``target_variance`` asks for (the configuration's
``npc_blocks``, which it asserts), its per-(PC, design) noise from the
problem's ``train_err`` (``_prepare_training``'s ``noise_diag``), and the
GP factors from the known-hyperparameter path (``finalize_gp_state``,
``_finalize_training``), then ``Chain`` and ``loadEmulator``.  Block b's
GPs take the hyperparameters ``hyper[b * npc : b * npc + k_b]`` of the
problem's draws, ``npc`` being the configuration's scalar (the largest
block's count), as the reference (``benchmark/reference/posterior_pcsk.py``)
takes them.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def build_pcsk_chain(problem: dict, cfg: dict, tmpdir: str, device, mode: str,
                     dtype=torch.float32):
    """The port's ``Chain`` over nine PCSK heads, on ``device`` in ``dtype``,
    with ``likelihood_mode = mode``."""
    from gpbayestools_hic_tpu_torch.models.emulator_band import EmulatorBAND
    from gpbayestools_hic_tpu_torch.models.gp import finalize_gp_state
    from gpbayestools_hic_tpu_torch.samplers.chain import Chain
    from gpbayestools_hic_tpu_torch.utils.synthetic import (
        write_exp_pickle, write_parameter_file, write_training_pickle,
    )

    npc = int(cfg["npc"])
    kernel = cfg["kernel"]
    parfile = write_parameter_file(os.path.join(tmpdir, "pars.txt"), int(cfg["ndim"]))
    hyper = problem["hyper"]
    emus = []
    i0 = 0
    for b, nobs in enumerate(cfg["blocks"]):
        i1 = i0 + int(nobs)
        pkl = write_training_pickle(
            os.path.join(tmpdir, f"train{b}.pkl"), problem["design"],
            problem["outputs"][:, i0:i1], problem["train_err"][:, i0:i1])
        emu = EmulatorBAND(pkl, parfile, method=cfg["method"], kernel_kind=kernel,
                           target_variance=float(cfg["target_variance"]), gp_maxiter=0,
                           device=device, dtype=dtype)
        emu.gp_alpha = float(cfg["gp_alpha"])
        emu.gp_grad_precision = cfg.get("grad_precision", "default")
        x, z_t, _, noise_diag = emu._prepare_training(np.ones(emu.nev, dtype=bool), kernel)
        k = int(z_t.shape[0])
        want = cfg.get("npc_blocks")
        if want is not None and k != int(want[b]):
            raise AssertionError(f"block {b}: the head keeps {k} PCs, the configuration "
                                 f"says {want[b]}")
        gps = slice(b * npc, b * npc + k)

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
