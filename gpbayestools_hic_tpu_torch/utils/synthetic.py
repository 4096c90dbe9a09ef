"""Synthetic flagship-shaped calibration problems.

The port's own copy of the JAX package's ``utils/synthetic.py``: the
training/exp pickles follow the reference's on-disk contracts (training
pickle ``{event_id: {"parameter": (d,), "obs": (2, nobs)}}``; one-event
experimental pickle), and :func:`build_synthetic_chain` draws the same
numbers from the same seed, so both packages build the same problem.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time

import numpy as np


def write_training_pickle(path, design, obs_mean, obs_err):
    """Write a reference-schema training pickle."""
    with open(path, "wb") as f:
        pickle.dump(
            {
                str(i): {
                    "parameter": design[i],
                    "obs": np.stack([obs_mean[i], obs_err[i]]),
                }
                for i in range(design.shape[0])
            },
            f,
        )
    return path


def write_exp_pickle(path, exp_mean, exp_err):
    """Write a reference-schema experimental-data pickle."""
    with open(path, "wb") as f:
        pickle.dump({"0": {"obs": np.stack([exp_mean, exp_err])}}, f)
    return path


def write_parameter_file(path, ndim):
    """Unit-box parameter file in the reference text format."""
    with open(path, "w") as f:
        f.write("".join(f"p{i}: $p_{i}$, 0.0, 1.0\n" for i in range(ndim)))
    return path


def build_synthetic_chain(
    *,
    nev: int,
    ndim: int,
    nobs_blocks,
    npc: int,
    gp_maxiter: int,
    seed: int = 0,
    freq_range=(0.5, 2.0),
    train_err_frac: float = 0.01,
    exp_err_frac: float = 0.05,
    tmpdir: str | None = None,
    device=None,
    dtype=None,
    fit_stats: dict | None = None,
):
    """Train one Emulator per observable block on smooth synthetic physics
    (``obs = 2 + sin(design @ freqs)``) and load them into a Chain whose
    experimental data comes from a random truth point.

    All blocks share the design, so the whole ensemble trains as ONE
    batched GP fit (:func:`..models.joint.train_emulators_jointly`), as
    the JAX package's ``build_synthetic_chain`` does.  ``fit_stats``, when
    given, receives the optimizer's counts.  Returns ``(chain,
    gp_train_seconds)``.
    """
    import torch

    from ..models.emulator import Emulator
    from ..models.joint import train_emulators_jointly
    from ..samplers.chain import Chain

    tmpdir = tmpdir or tempfile.mkdtemp(prefix="synthetic_chain_")
    rng = np.random.default_rng(seed)
    design = rng.uniform(0, 1, size=(nev, ndim))
    truth = rng.uniform(0.35, 0.65, size=ndim)
    parfile = write_parameter_file(os.path.join(tmpdir, "pars.txt"), ndim)

    emus, exp_blocks = [], []
    for b, nobs in enumerate(nobs_blocks):
        freqs = rng.uniform(*freq_range, size=(ndim, nobs))
        base = 2.0 + np.sin(design @ freqs)
        pkl = write_training_pickle(
            os.path.join(tmpdir, f"train{b}.pkl"),
            design, base, train_err_frac * np.abs(base),
        )
        emus.append(Emulator(pkl, parfile, npc=npc, gp_maxiter=gp_maxiter,
                             device=device, dtype=dtype))
        exp_blocks.append(2.0 + np.sin(truth @ freqs))

    t0 = time.perf_counter()
    train_emulators_jointly(emus, stats=fit_stats)
    if emus and emus[0].device.type == "cuda":
        torch.cuda.synchronize(emus[0].device)
    gp_train_s = time.perf_counter() - t0

    exp_mean = np.concatenate(exp_blocks)
    exp_pkl = write_exp_pickle(
        os.path.join(tmpdir, "exp.pkl"), exp_mean, exp_err_frac * np.abs(exp_mean)
    )
    chain = Chain(
        mcmc_path=os.path.join(tmpdir, "mcmc", "chain.pkl"),
        expdata_path=exp_pkl,
        model_parafile=parfile,
        device=device,
        dtype=dtype,
    )
    chain.loadEmulator(emus)
    return chain, gp_train_s
