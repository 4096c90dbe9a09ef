"""Timing and tracing helpers (PyTorch port of the JAX package's
``utils/profiling.py``).

Wall-clock timers that wait for the device before the clock stops
(``torch.cuda.synchronize`` where ``block_until_ready`` was), a
``torch.profiler`` trace of host and CUDA activity written as a Chrome
trace, and named spans at the port's layer boundaries.

Spans (:func:`span`) are off by default: a span site then costs one check
of a module flag.  After ``enable_spans(True)`` each span is a
``torch.profiler.record_function``, so a running profiler records it in
the same trace as the CUDA activities, on the same clock, around every
launch made inside it (autograd's device thread included).  A span is its
name, start and end; parentage is containment in time on a thread.  The
names and where they are recorded:

- ``hic.step``: one sampler step (``samplers/hmc.py``, ``samplers/ensemble.py``);
- ``hic.posterior``: one posterior or likelihood call (``samplers/chain.py``);
- ``hic.predict``: an emulator's GP predict, fused or plain (``models/emulator.py``);
- ``hic.predict_bwd``: the predict's hand-written backward
  (``ops/fused_predict.py``, ``models/gp.py``);
- ``hic.woodbury``: the PC-space Woodbury epilogue of every low-rank block
  of a posterior call, once a call (``samplers/chain.py``);
- ``hic.assembly``: the PC-to-observable mean and covariance and their
  stitching (``models/emulator.py``, ``samplers/chain.py``);
- ``hic.mvn``: the dense MVN log-likelihood (``ops/fused_mvn.py``);
- ``hic.grad``: the HMC gradient's ``torch.autograd.grad`` (``samplers/hmc.py``);
- ``hic.readback``: a device-to-host read on the HMC sampler's path.

Spans change no number: a chain drawn with them on equals one drawn with
them off.
"""

from __future__ import annotations

import contextlib
import logging
import time
from pathlib import Path

import torch

logger = logging.getLogger(__name__)

_SPANS = False
_NO_SPAN = contextlib.nullcontext()


def enable_spans(flag: bool = True) -> None:
    """Switch the port's spans on (``record_function`` at every span site)
    or off (a flag check)."""
    global _SPANS
    _SPANS = bool(flag)


def spans_enabled() -> bool:
    return _SPANS


def span(name: str):
    """A context manager around one layer's work: a shared null context
    while spans are off, else ``torch.profiler.record_function(name)``."""
    if not _SPANS:
        return _NO_SPAN
    return torch.profiler.record_function(name)


def _cuda_devices(tree) -> set:
    """The CUDA devices of the tensors in a nested result."""
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.is_cuda else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return set().union(*(_cuda_devices(t) for t in tree))
    return set()


def _wait(tree) -> None:
    for dev in _cuda_devices(tree):
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def timed(label: str):
    """Time a block; set ``t["result"]`` inside it to wait for the device
    work behind a (nested) tensor result before the clock stops::

        with timed("gp predict") as t:
            t["result"] = emulator.predict_device(x)

    ``t["seconds"]`` holds the elapsed wall time after the block."""
    t0 = time.perf_counter()
    out = {}
    try:
        yield out
    finally:
        if out.get("result") is not None:
            _wait(out["result"])
        out["seconds"] = time.perf_counter() - t0
        logger.info("[timer] %s: %.3f s", label, out["seconds"])


def time_fn(fn, *args, iters: int = 10, warmup: int = 1, **kwargs) -> float:
    """Average wall time per call of ``fn``, waiting for the device after
    each call."""
    for _ in range(warmup):
        _wait(fn(*args, **kwargs))
    t0 = time.perf_counter()
    for _ in range(iters):
        _wait(fn(*args, **kwargs))
    return (time.perf_counter() - t0) / iters


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace host and CUDA activity with ``torch.profiler`` and write a
    Chrome trace (``trace.json`` under ``logdir``; open it in Perfetto or
    chrome://tracing).  Yields the profiler, whose ``key_averages()`` give
    the time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = Path(logdir)
    path.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(path / "trace.json"))
    logger.info("profiler trace written to %s", path / "trace.json")
