"""Tiny sizes for the benchmark's CPU tests, and the card fixture."""

from __future__ import annotations

import copy

import pytest
import torch

from benchmark.harness.spec import load_cell

CELLS = ("bes-hmc", "bes-ens-generic", "bes-ens-stitched")
TINY = {"ndim": 3, "n_design": 40, "npc": 2}


def tiny_spec(cell: str) -> dict:
    """The cell's spec (as ``run.py`` loads it) cut to a size a CPU test
    holds: 3 parameters, 40 design points, 2 PCs, blocks of 5 and 3
    observables, 16 walkers."""
    spec = load_cell(cell)
    cfg = dict(copy.deepcopy(spec["config"]), **TINY)
    cfg["blocks"] = [5, 3]
    tp = dict(spec["workload"]["traffic_params"], walkers=16, chunk_steps=3)
    if "warmup_walkers" in tp:
        tp["warmup_walkers"] = 8
        tp["check_calls"] = 2
        tp["check_walkers"] = 8
    else:
        tp["check_samples"] = 24
    spec["config"] = cfg
    spec["workload"] = dict(spec["workload"], traffic_params=tp)
    return spec


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def card():
    """The CUDA device; skips where there is none (these tests run on the
    card: ``python -m pytest benchmark/tests -k card``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
