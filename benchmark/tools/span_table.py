"""Where a cell's traced chunk spends the card's time, by the port's spans.

Sets a cell up as ``benchmark/run.py`` does, then traces its timed chunk
(the driver's own ``window`` at ``--seconds 0``: one chunk, traced) in
rounds, once with the port's spans off and once on
(``utils/profiling.py::enable_spans``), and reduces each spans-on trace
with ``benchmark/harness/spans.py``: per ``hic.*`` span its count, self
time, the kernels launched inside it and the card's idle time under it;
each layer's idle share (they sum to ``device_idle``); HMC readbacks per
step; the predict's roofline over the kernels launched inside its spans;
and how many kernels link to a launch.  It also times untraced chunks with
spans off and on, in turns, for the cost of the spans without a profiler.
The existing per-layer readers are read from the same traces beside them.

    python3 benchmark/tools/span_table.py --workload bes-hmc --seed 5 \\
        [--rounds 2] [--untraced 2] [--out spans-bes-hmc.json]

from the root of a checkout, on a CUDA machine.  Prints one JSON line per
round and a last line with every round; ``--out`` keeps the last line.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")
sys.path.insert(0, str(ROOT))

#: the fused predict's kernels, which must launch inside the predict's spans
FUSED = r"\b(kstar_kernel|fwd_wgmma_kernel|bwd_wgmma_kernel|bwd_high_kernel)"


def _traced_chunk(run, driver, spans_on: bool) -> tuple[dict, list, list]:
    """One traced chunk through the driver's window: (the window's result,
    ``trace.py``'s raw events, ``spans.py``'s events)."""
    from benchmark.harness import spans
    from benchmark.harness.trace import raw_events
    from gpbayestools_hic_tpu_torch.utils.profiling import enable_spans

    run.calls.counts = {}
    enable_spans(spans_on)
    try:
        result = driver.window(run, 0.0, True)
    finally:
        enable_spans(False)
    prof = result.pop("prof")
    # the device-side copies of the spans are no device work
    raw = [ev for ev in raw_events(prof) if not (ev[1] and ev[0].startswith(spans.PREFIX))]
    events = spans.span_events(prof)
    del prof
    gc.collect()
    return result, raw, events


def _summary(spec, result, raw) -> dict:
    from benchmark.harness.trace import summarize

    s = summarize(raw)
    s.update(steps=result["traced_steps"], calls=result["calls"], walkers=result["walkers"],
             acceptance=result.get("acceptance"), config=spec["config"],
             traffic=spec["workload"]["traffic_params"])
    return s


def layer_numbers(spec, summary: dict, red: dict) -> dict:
    """The new per-layer numbers of one spans-on trace, and its checks."""
    from benchmark.harness import spans

    mode = spec["workload"]["traffic_params"].get("mode", "auto")
    out = {f"idle_{layer}": spans.idle_percent(red, layer) for layer in spans.LAYERS}
    out["device_idle"] = spans.device_idle_percent(red)
    out["card_clock"] = {layer: spans.idle_percent(red, layer, "idle_card_clock_s")
                         for layer in spans.LAYERS}
    out["anchored"] = red["anchored"]
    out["readbacks_per_step"] = spans.per_step(red, "hic.readback")
    out["predict_roofline"] = spans.predict_roofline_percent(red, summary, mode)
    out["linked_share"] = red["linked"] / red["n_kernels"] if red["n_kernels"] else None
    out["launch_after"] = red["launch_after"]
    out["lag_us"] = red["lag_us"]
    out["fused_under"] = spans.kernels_under(red, FUSED)
    return out


def measure(spec: dict, seed: int, device, rounds: int = 1, untraced: int = 0,
            emit=None) -> dict:
    """Set the cell up, then ``rounds`` of (traced chunk with spans off,
    traced chunk with spans on) and ``untraced`` pairs of untraced chunks;
    returns every round's numbers."""
    import torch

    from benchmark.harness import spans
    from benchmark.harness.calls import sync
    from benchmark.harness.runner import Run
    from gpbayestools_hic_tpu_torch.utils.profiling import enable_spans

    driver = spec["driver"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="spans_") as tmpdir:
        run = Run(spec, seed, device, tmpdir)
        driver.setup(run)
        out = {"cell": spec["cell"], "seed": seed, "setup_s": time.perf_counter() - t0,
               "rounds": [], "untraced": []}
        if device.type == "cuda":
            out["device"] = torch.cuda.get_device_name()
        t = spec["workload"]["traffic_params"]
        for k in range(rounds):
            traced = {}
            for on in (k % 2 == 1, k % 2 == 0):     # in turns: off first, then on first
                traced[on] = _traced_chunk(run, driver, on)
            s_off = _summary(spec, *traced[False][:2])
            s_on = _summary(spec, *traced[True][:2])
            red = spans.reduce(traced.pop(True)[2])
            traced.clear()
            rnd = {
                "window_s_off": s_off["window_s"], "window_s_on": s_on["window_s"],
                "busy_s_off": s_off["busy_s"], "busy_s_on": s_on["busy_s"],
                "steps": s_on["steps"], "calls": {f"{m}{'g' if g else ''}": n
                                                  for (m, g), n in s_on["calls"].items()},
                "existing_off": {m["name"]: spec["readers"][m["name"]].read(s_off)
                                 for m in spec["per_layer"]},
                "existing_on": {m["name"]: spec["readers"][m["name"]].read(s_on)
                                for m in spec["per_layer"]},
                "new": layer_numbers(spec, s_on, red),
                "idle_gaps_on": s_on["idle_gaps"],
                "spans": red["spans"],
                "n_kernels": red["n_kernels"], "linked": red["linked"],
            }
            out["rounds"].append(rnd)
            if emit:
                emit({"round": k, **{key: v for key, v in rnd.items() if key != "spans"}})
        for _ in range(untraced):
            pair = {}
            for on in ((False, True) if len(out["untraced"]) % 2 == 0 else (True, False)):
                enable_spans(on)
                try:
                    tc = time.perf_counter()
                    res = driver._chunk(run, t)
                    if hasattr(run, "res"):     # HMC chains its chunks by warm start
                        run.res = res
                    sync(device)
                    pair["on" if on else "off"] = time.perf_counter() - tc
                finally:
                    enable_spans(False)
            out["untraced"].append(pair)
        driver.release(run)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--untraced", type=int, default=2)
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch

    from benchmark.harness.spec import load_cell

    if not torch.cuda.is_available():
        print("span_table: no CUDA device", file=sys.stderr)
        return 2
    from gpbayestools_hic_tpu_torch.ops import _build

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    _build.build_all()
    spec = load_cell(args.workload, ROOT)
    out = measure(spec, args.seed, device, args.rounds, args.untraced,
                  emit=lambda d: print(json.dumps(d), flush=True))
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
