"""The control on the card: the reference computed in float32 with TF32
products, put in the program's place, must come out not correct at the
cell's own size, while the program comes out correct.  Skips without a
card; on one: ``python -m pytest benchmark/tests/test_bench_control.py``
from the root of a checkout (a few minutes a cell)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark.harness.spec import ROOT, load_json

from .conftest import CELLS


@pytest.mark.parametrize("cell", CELLS)
def test_card_control_fails_where_the_program_passes(card, cell):
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed", "3000000019",
         "--seconds", "5", "--trace", "0", "--control"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    limits = load_json("workloads", cell)["limits"]
    assert out["correct"], out["checks"]
    assert any(v > limits[k] for k, v in out["control"].items()), out["control"]
