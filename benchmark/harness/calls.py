"""Wrappers the drivers put around the port's functions to observe them.

:class:`PosteriorCalls` stands between a sampler and the chain's posterior
function: while ``counting`` it counts the calls by (walkers, with a
gradient or not), which the work counts of the per-layer metrics read, and
while ``spans`` it records a ``bench.posterior`` span around each call for
the trace.  :class:`CallSample` keeps a uniform sample, drawn from the
seed, of the results that some function returned while ``active``
(reservoir sampling), holding references and copying nothing on the
device.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness.trace import POSTERIOR_SPAN


class PosteriorCalls:
    def __init__(self, fn):
        self.fn = fn
        self.counting = False
        self.spans = False
        self.counts: dict[tuple[int, bool], int] = {}

    def __call__(self, state, x):
        if self.counting:
            key = (int(x.shape[0]), bool(x.requires_grad and torch.is_grad_enabled()))
            self.counts[key] = self.counts.get(key, 0) + 1
        if self.spans:
            with torch.profiler.record_function(POSTERIOR_SPAN):
                return self.fn(state, x)
        return self.fn(state, x)


class CallSample:
    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng(seed)
        self.active = False
        self.seen = 0
        self.kept: list = []

    def offer(self, item) -> None:
        if not self.active:
            return
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.kept[j] = item
        self.seen += 1


def sub_seed(seed: int, k: int) -> int:
    """A 63-bit seed for stream ``k`` of run seed ``seed``."""
    state = np.random.SeedSequence([int(seed) & ((1 << 64) - 1), k]).generate_state(1, np.uint64)
    return int(state[0]) >> 1


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
