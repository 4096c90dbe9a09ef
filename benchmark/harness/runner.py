"""One run of one cell: set-up, the window, the check, the result line.

:func:`run_cell` does the work and returns the result line's object; the
look for a chip is ``run.py``'s, so that the CPU tests can drive a whole
run (at tiny sizes) through the same code.
"""

from __future__ import annotations

import gc
import math
import sys
import tempfile
import time

import torch

from benchmark.harness import check as chk
from benchmark.harness.calls import sub_seed
from benchmark.harness.problem import make_problem
from benchmark.harness.trace import raw_events, summarize

#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "gpbayestools_hic_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    :data:`FORBIDDEN`, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


class Run:
    """The state of one run, handed to the cell's driver."""

    def __init__(self, spec: dict, seed: int, device: torch.device, tmpdir: str):
        self.cfg = spec["config"]
        self.workload = spec["workload"]
        self.seed = int(seed)
        self.device = device
        self.tmpdir = tmpdir
        self.problem = make_problem(self.cfg, sub_seed(seed, 0))


def _power_limit_w() -> float | None:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device: torch.device,
             t_start: float, control: bool = False) -> dict | None:
    """One run; returns the result line's object, or None when a forbidden
    module was loaded (named on standard error)."""
    driver = spec["driver"]
    cuda = device.type == "cuda"
    if cuda:
        from gpbayestools_hic_tpu_torch.ops import _build

        torch.cuda.set_device(device)
        _build.build_all()
    with tempfile.TemporaryDirectory(prefix="bench_") as tmpdir:
        run = Run(spec, seed, device, tmpdir)
        driver.setup(run)
        setup_s = time.perf_counter() - t_start
        result = driver.window(run, seconds, trace)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return None
    summary = None
    if trace:
        summary = summarize(raw_events(result.pop("prof")))
    driver.release(run)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checked = driver.check(run, control=control)
    correct, checks = chk.judge(checked["numbers"], spec["workload"]["limits"])

    metrics = {}
    if trace:
        summary.update(
            steps=result["traced_steps"], calls=result["calls"], walkers=result["walkers"],
            acceptance=result.get("acceptance"), config=spec["config"],
            traffic=spec["workload"]["traffic_params"])
        for m in spec["per_layer"]:
            value = spec["readers"][m["name"]].read(summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(result["e2e"], setup_s=setup_s)
        for m in spec["end_to_end"]:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name() if cuda else "cpu",
        "count": int(spec["entry"]["chips"]),
        "memory_peak_bytes": int(peak),
    }
    if trace:
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
    out = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": dev}
    if trace:
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    out["info"] = {k: v for k, v in result.items() if k not in ("e2e", "calls", "prof")}
    out["info"].update(checked=checked["checked"], setup_s=setup_s,
                       power_limit_w=_power_limit_w() if cuda else None)
    if checked["control"] is not None:
        out["control"] = checked["control"]
    out["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {_fmt(c['value'])} limit {_fmt(c['limit'])}", file=sys.stderr)
    return out


def _fmt(v) -> str:
    if v is None:
        return "none"
    return repr(v) if isinstance(v, float) and not math.isfinite(v) else f"{v!r}"
