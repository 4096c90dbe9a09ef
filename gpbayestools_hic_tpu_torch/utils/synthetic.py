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


def gaussian_evidence_problem(ndim: int = 17, seed: int = 0, sd_range=(0.05, 0.1)):
    """A normalized correlated Gaussian likelihood well inside the unit box,
    whose log evidence under the uniform prior is known: the log of the
    Gaussian's mass inside the box, which the marginal masses outside
    bound (``truth``; -1.2e-5 at the defaults, the means at least 4.3
    standard deviations inside).  Returns a dict of float64 numpy arrays
    ``mu``, ``prec``, ``cov`` and the floats ``const`` (the log
    normalizer) and ``truth``; ``log L(x) = -0.5 (x - mu)^T prec (x - mu)
    + const``."""
    from scipy.stats import norm

    rng = np.random.default_rng(seed)
    sd = rng.uniform(*sd_range, ndim)
    a = rng.normal(size=(ndim, ndim))
    s = a @ a.T + ndim * np.eye(ndim)
    cov = s / np.sqrt(np.outer(np.diag(s), np.diag(s))) * np.outer(sd, sd)
    mu = rng.uniform(0.4, 0.6, ndim)
    return {
        "mu": mu,
        "cov": cov,
        "prec": np.linalg.inv(cov),
        "const": float(-0.5 * np.linalg.slogdet(2 * np.pi * cov)[1]),
        "truth": float(np.sum(np.log1p(-norm.cdf(-mu / sd) - norm.cdf(-(1 - mu) / sd)))),
    }
