"""Find the benchmark's data and code by name.

``BENCHMARK.json`` at the checkout's root names the cells and metrics; a
cell's own file ``benchmark/workloads/<cell>.json`` names its
configuration (``benchmark/configs/<config>.json``), its timed loop
(``benchmark/drivers/<driver>.py``), its traffic parameters and the limits
of its correctness check; a per-layer metric's reader is
``benchmark/metrics/<metric>.py``, or, where there is none, the reader of
its base name (the part before the first dot: ``mfu.ens`` is read by
``mfu.py``).  A new cell, configuration, driver or metric is a new file
here, or none: nothing else changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str, bench_dir: Path = BENCH_DIR) -> dict:
    """``benchmark/<kind>/<name>.json`` (kind: configs, workloads)."""
    path = bench_dir / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_module(kind: str, name: str, bench_dir: Path = BENCH_DIR):
    """The module ``benchmark/<kind>/<name>.py`` (kind: drivers, metrics);
    a name may hold dots, so it is loaded from its file."""
    path = bench_dir / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(metric: str, bench_dir: Path = BENCH_DIR):
    """The reader of per-layer metric ``metric``: ``metrics/<metric>.py``,
    else ``metrics/<base>.py`` for its base name."""
    if not (bench_dir / "metrics" / f"{metric}.py").is_file():
        base = metric.split(".", 1)[0]
        if (bench_dir / "metrics" / f"{base}.py").is_file():
            return load_module("metrics", base, bench_dir)
    return load_module("metrics", metric, bench_dir)


def cell_entry(bench: dict, cell: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"BENCHMARK.json has no workload {cell!r}")


def _listed(metric: dict, cell: str, e2e_names: set[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in e2e_names if "moves" in metric else True


def cell_metrics(bench: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """(end-to-end, per-layer) metric entries that cell ``cell`` reports."""
    e2e = [m for m in bench["end_to_end"] if _listed(m, cell, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _listed(m, cell, names)]
    return e2e, per_layer


def load_cell(cell: str, root: Path = ROOT) -> dict:
    """Everything one run of ``cell`` needs, by name."""
    bench_dir = root / "benchmark"
    bench = load_benchmark(root)
    entry = cell_entry(bench, cell)
    workload = load_json("workloads", cell, bench_dir)
    for key in ("config", "traffic"):
        if workload[key] != entry[key]:
            raise ValueError(
                f"workload file {cell}.json says {key}={workload[key]!r}, "
                f"BENCHMARK.json says {entry[key]!r}")
    e2e, per_layer = cell_metrics(bench, cell)
    return {
        "cell": cell, "entry": entry, "workload": workload,
        "config": load_json("configs", workload["config"], bench_dir),
        "driver": load_module("drivers", workload["driver"], bench_dir),
        "end_to_end": e2e, "per_layer": per_layer,
        "readers": {m["name"]: load_reader(m["name"], bench_dir)
                    for m in per_layer},
    }
