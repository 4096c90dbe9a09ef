"""The benchmark's files load, follow the contract's shapes, and a new
cell, configuration, driver or metric is found by name alone."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from benchmark.harness import spec as spec_mod
from benchmark.harness.spec import BENCH_DIR, ROOT, load_benchmark, load_cell

from .conftest import CELLS

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_follows_the_contract():
    b = load_benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert c["reduced"] == json.loads((ROOT / c["file"]).read_text())["reduced"]
        names.add(c["name"])
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in names and w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert {w["config"] for w in b["workloads"]} == names
    cells = {w["name"] for w in b["workloads"]}
    e2e = {}
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
        e2e[m["name"]] = set(m.get("workloads", cells))
    assert "setup_s" in e2e and e2e["setup_s"] == cells
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m["workloads"]) <= e2e[m["moves"]]
    for cell in cells:
        reported = [n for n, ws in e2e.items() if cell in ws]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in m["workloads"] for m in b["per_layer"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_loads_by_name(cell):
    spec = load_cell(cell)
    assert spec["workload"]["name"] == cell
    assert spec["config"]["name"] == spec["entry"]["config"]
    assert callable(spec["driver"].setup) and callable(spec["driver"].window)
    assert set(spec["readers"]) == {m["name"] for m in spec["per_layer"]}
    assert set(spec["workload"]["limits"]) >= {"lp_gap", "stuck_share"}


def test_the_config_is_at_published_widths():
    cfg = spec_mod.load_json("configs", "auau-bes")
    assert (cfg["ndim"], cfg["n_design"], cfg["npc"]) == (20, 1095, 4)
    assert cfg["blocks"] == [28, 28, 12, 170, 14, 21, 28, 73, 170]
    assert sum(cfg["blocks"]) == 544
    assert cfg["reduced"] == [] and cfg["hyper_ranges"] and cfg["hyper_source"]


def test_new_files_are_found_by_name(tmp_path):
    """A later change adds a configuration, a cell, a driver and a metric as
    new files and one entry each in BENCHMARK.json: nothing else changes."""
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = load_benchmark()
    bench = tmp_path / "benchmark"
    cfg = json.loads((bench / "configs" / "auau-bes.json").read_text())
    cfg["name"] = "auau-bes-copy"
    (bench / "configs" / "auau-bes-copy.json").write_text(json.dumps(cfg))
    (bench / "drivers" / "hmc_copy.py").write_text(
        (bench / "drivers" / "hmc.py").read_text())
    wl = json.loads((bench / "workloads" / "bes-hmc.json").read_text())
    wl.update(name="bes-hmc-1024", config="auau-bes-copy", traffic="hmc-windowed-1024",
              driver="hmc_copy")
    assert not (bench / "metrics" / "device_idle.hmc1024.py").exists()
    wl["traffic_params"]["walkers"] = 1024
    (bench / "workloads" / "bes-hmc-1024.json").write_text(json.dumps(wl))
    (bench / "metrics" / "steps_traced.hmc.py").write_text(
        "def read(summary):\n    return float(summary['steps'])\n")
    b["configs"].append({"name": "auau-bes-copy", "source": "x", "reduced": [], "why": "x",
                         "file": "benchmark/configs/auau-bes-copy.json"})
    b["workloads"].append({"name": "bes-hmc-1024", "config": "auau-bes-copy",
                           "traffic": "hmc-windowed-1024", "chips": 1, "why": "x"})
    for m in b["end_to_end"]:
        if "bes-hmc" in m.get("workloads", []):
            m["workloads"].append("bes-hmc-1024")
    b["per_layer"].append({"name": "steps_traced.hmc", "unit": "steps", "better": "higher",
                           "source": "device_trace", "layer": "HMC sampler",
                           "moves": "hmc_samples_per_s", "workloads": ["bes-hmc-1024"]})
    # a metric whose base name has a reader needs no file of its own
    b["per_layer"].append({"name": "device_idle.hmc1024", "unit": "%", "better": "lower",
                           "source": "device_trace", "layer": "device",
                           "moves": "hmc_samples_per_s", "workloads": ["bes-hmc-1024"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    spec = load_cell("bes-hmc-1024", tmp_path)
    assert spec["config"]["name"] == "auau-bes-copy"
    assert spec["workload"]["traffic_params"]["walkers"] == 1024
    assert spec["driver"].__file__.endswith("hmc_copy.py")
    assert spec["readers"]["steps_traced.hmc"].read({"steps": 3}) == 3.0
    assert spec["readers"]["device_idle.hmc1024"].read({"window_s": 2.0, "busy_s": 0.5}) == 75.0
    assert [m["name"] for m in spec["end_to_end"]] == [
        "hmc_samples_per_s", "hmc_ess_per_s", "setup_s"]
    with pytest.raises(FileNotFoundError):
        spec_mod.load_json("workloads", "no-such-cell", bench)
