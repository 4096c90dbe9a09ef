"""Run one cell of the port's benchmark and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for (``BENCHMARK.json``).  Builds the port's CUDA kernels into the
checkout at first use (``gpbayestools_hic_tpu_torch/_build/``), draws the
cell's problem from ``--seed``, sets it up and warms it up (``setup_s``:
from this process's start to the first timed step), runs the timed loop
for ``--seconds``, checks what the timed path produced against the plain
reference, and prints one JSON object as the last line of standard output
(with ``--trace 1`` the per-layer metrics of a traced part of the window,
else the end-to-end metrics), and each compared number beside its limit
as the last lines of standard error.  Exits non-zero, printing no result,
without the cards, or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# few host threads: a steady load from one process
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
# kernel caches at fixed paths inside the checkout (the port builds its own
# CUDA kernels into gpbayestools_hic_tpu_torch/_build/)
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / ".bench_cache" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".bench_cache" / "triton")
sys.path.insert(0, str(ROOT))


def parse(argv=None):
    p = argparse.ArgumentParser(description="Run one cell of the port's benchmark.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="also compute the check's numbers with the reference in float32 "
                        "with TF32 products in the program's place (not part of a run)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    import gpbayestools_hic_tpu_torch  # noqa: F401  (the program; first, so that a
    # checkout without it fails here)
    from benchmark.harness.runner import run_cell
    from benchmark.harness.spec import load_cell

    spec = load_cell(args.workload, ROOT)
    chips = int(spec["entry"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), T_START, control=args.control)
    if out is None:
        return 3
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
