"""Timed loop: HMC production over the auto (Woodbury) posterior of PCSK
emulator heads with the Matern-1.5 kernel.

``drivers/hmc.py``'s set-up, window and check, unchanged, with this
configuration's chain (``harness/problem_pcsk.py::build_pcsk_chain``: one
``EmulatorBAND(method="PCSK")`` head per block, the PC counts the
configuration states) and its reference
(``reference/posterior_pcsk.py::PosteriorPCSK``) in place of the sklearn
head's: set-up and check run hmc.py's own with those two names bound to the
PCSK ones for the length of the call.  Set-up first makes one
value-and-gradient call of the posterior at the cell's walker count, the
largest shape the run uses, so that a program that cannot hold it (the
plain predict under autograd keeps about 0.5 GB a GP at 4096 walkers)
fails there, in seconds, and not after the warmup.
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch

from benchmark.drivers import hmc
from benchmark.harness.calls import sub_seed, sync
from benchmark.harness.problem_pcsk import build_pcsk_chain
from benchmark.reference.posterior_pcsk import PosteriorPCSK

MODE = hmc.MODE
window = hmc.window
release = hmc.release
_chunk = hmc._chunk  # one production chunk (benchmark/tools/span_table.py times it)


@contextmanager
def _pcsk(build=build_pcsk_chain):
    saved = hmc.build_chain, hmc.Posterior
    hmc.build_chain, hmc.Posterior = build, PosteriorPCSK
    try:
        yield
    finally:
        hmc.build_chain, hmc.Posterior = saved


def _first_call(chain, walkers: int, seed: int) -> None:
    """One value-and-gradient call of the chain's posterior at ``walkers``
    points drawn in the box."""
    x0 = np.random.default_rng(seed).uniform(chain.min, chain.max, (walkers, chain.ndim))
    log_post, state = chain.posterior_with_state()
    x = torch.as_tensor(x0, dtype=chain._dtype, device=chain.device).requires_grad_(True)
    with torch.enable_grad():
        lp = log_post(state, x)
        torch.autograd.grad(lp.sum(), x)
    sync(chain.device)


def setup(run) -> None:
    walkers = int(run.workload["traffic_params"]["walkers"])

    def build(*args, **kwargs):
        chain = build_pcsk_chain(*args, **kwargs)
        _first_call(chain, walkers, sub_seed(run.seed, 5))
        return chain

    with _pcsk(build):
        hmc.setup(run)


def check(run, control: bool = False) -> dict:
    with _pcsk():
        return hmc.check(run, control=control)
