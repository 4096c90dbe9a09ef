"""Panel widths of the MVN kernel's shared-memory route on one GPU: variants
of ``gpbayestools_hic_tpu_torch/csrc/fused_mvn.cu`` built side by side and
timed on the flagship's own block covariances.

Run from the repository root on a CUDA machine:

    python3 tools/torch_mvn_variants.py [--parent DIR ...]

Variants of the committed source (the script fails if an edit no longer
applies):

- ``kept``: the source as committed;
- ``panel_8`` / ``panel_16`` / ``panel_32``: ``SMEM_PANEL`` set to that
  width (the one equal to the committed width is left out);
- ``row_load``: the triangle loaded a row per warp at a time, one global
  load in flight per thread (the rank-1 kernel's load);
- ``four_blocks``: the launch bound asks for four blocks per SM (at most
  64 registers), not three;
- ``load_only``, ``no_block_factor``, ``no_trailing_update``: diagnostics
  with wrong results, not checked: no panel at all (what is left is the
  load), no factoring of the panels' diagonal blocks, no trailing update.

``--parent DIR`` adds the ``fused_mvn.cu`` of another checkout (e.g. the
parent commit unpacked with ``git archive``) as the variant ``parent``
(given again: ``parent2``, ...); it must have the same C entry
``fused_mvn_loglike_smem``.

For each block size of the flagship (n = 170, 73, 28, 12; 1024 walkers,
the residuals and covariances the generic path builds, one non-PD matrix
planted) every variant is checked against the plain elimination
(chip_smoke.py's TOL_MVN) and timed by CUDA-graph replay
(``chip_smoke.graph_ms``) twice, in the order variants, then variants
reversed, so that drift shows as a difference between the two passes.  It
prints the ptxas report of each variant's ``mvn_smem_kernel``, its blocks
per SM at n = 170, the card's name and power limit, and one JSON line.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

WIDTH_LINE = re.compile(r"constexpr int SMEM_PANEL = (\d+);")
SIZES = (170, 73, 28, 12)

EDITS = {
    "row_load": [
        ("  load_triangle(a, cov_b, y_b, n);\n",
         "  for (int i = tid >> 5; i <= n; i += nthreads >> 5) {\n"
         "    float* row = a + tri(i);\n"
         "    if (i < n) {\n"
         "      for (int j = lane; j <= i; j += 32) row[j] = cov_b[(size_t)i * n + j];\n"
         "    } else {\n"
         "      for (int j = lane; j < n; j += 32) row[j] = y_b[j];\n"
         "      if (lane == 0) row[n] = 0.f;\n"
         "    }\n"
         "  }\n"),
    ],
    "four_blocks": [("__global__ void __launch_bounds__(256, 3)\nmvn_smem_kernel(",
                     "__global__ void __launch_bounds__(256, 4)\nmvn_smem_kernel(")],
    "load_only": [("  for (int c0 = 0; c0 < n; c0 += P) {", "  for (int c0 = n; c0 < n; c0 += P) {")],
    "no_block_factor": [("    if (warp == 0) {\n      float x[P];", "    if (false) {\n      float x[P];")],
    "no_trailing_update": [("    for (int t = tid >> 6; t < ntile; t += nthreads >> 6) {",
                            "    for (int t = ntile; t < ntile; t += nthreads >> 6) {")],
}
#: variants whose results are wrong by design (timing breakdowns only)
DIAGNOSTIC = ("load_only", "no_block_factor", "no_trailing_update")


def apply_edits(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"edit no longer applies to the source: {old[:70]!r}")
        text = text.replace(old, new)
    return text


def variant_sources(src: str, parents=()) -> dict[str, str]:
    """name -> source text of every variant."""
    found = WIDTH_LINE.findall(src)
    if len(found) != 1:
        raise SystemExit("SMEM_PANEL is no longer one constexpr line of fused_mvn.cu")
    out = {"kept": src}
    for width in (8, 16, 32):
        if width != int(found[0]):
            out[f"panel_{width}"] = WIDTH_LINE.sub(f"constexpr int SMEM_PANEL = {width};", src)
    for name, edits in EDITS.items():
        out[name] = apply_edits(src, edits)
    for i, path in enumerate(parents):
        with open(path) as f:
            out["parent" + (str(i + 1) if i else "")] = f.read()
    return out


def ptxas_report(log: str) -> str:
    """"R registers, S bytes spilled" of the shared-memory route's kernel."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and "mvn_smem_kernel" in line:
            spill = re.search(r"(\d+) bytes spill stores", lines[i + 2])
            regs = re.search(r"Used (\d+) registers", lines[i + 3])
            return f"{regs.group(1)} registers, {spill.group(1)} bytes spilled"
    return "not found"


def build(tmp: str, sources: dict[str, str]):
    """Compile every variant at once (one nvcc each): name -> (CDLL, ptxas)."""
    from gpbayestools_hic_tpu_torch.ops import _build

    procs = {}
    for name, text in sources.items():
        cu, so = os.path.join(tmp, f"{name}.cu"), os.path.join(tmp, f"lib{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    out = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name} does not build:\n{log}")
        lib = ctypes.CDLL(so)
        lib.fused_mvn_loglike_smem.restype = ctypes.c_int
        lib.fused_mvn_loglike_smem.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        lib.fused_mvn_smem_blocks_per_sm.restype = ctypes.c_int
        lib.fused_mvn_smem_blocks_per_sm.argtypes = [ctypes.c_int]
        out[name] = (lib, ptxas_report(log))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_mvn_variants: no CUDA device available", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", action="append", default=[],
                        help="root of another checkout to time beside this one")
    args = parser.parse_args()
    import chip_smoke as cs
    from gpbayestools_hic_tpu_torch.ops import _build
    from gpbayestools_hic_tpu_torch.ops import fused_mvn as fm
    from gpbayestools_hic_tpu_torch.utils.synthetic import build_synthetic_chain

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    rel = os.path.join("gpbayestools_hic_tpu_torch", _build.SOURCES["fused_mvn"])
    with open(os.path.join(ROOT, rel)) as f:
        src = f.read()
    parents = [os.path.join(path, rel) for path in args.parent]
    with tempfile.TemporaryDirectory(prefix="mvn_variants_") as tmp:
        libs = build(tmp, variant_sources(src, parents))
        for name, (lib, ptxas) in libs.items():
            print(f"{name:9s} ptxas mvn_smem_kernel: {ptxas}; "
                  f"{lib.fused_mvn_smem_blocks_per_sm(170)} blocks per SM at n = 170", flush=True)
        chain, _ = build_synthetic_chain(nev=cs.NEV, ndim=cs.NDIM, nobs_blocks=cs.BLOCKS,
                                         npc=cs.NPC, gp_maxiter=0, seed=0, tmpdir=tmp, device=dev)
        block_inputs = cs.mvn_inputs(chain, dev)
        order = list(libs)
        results = {name: {"ptxas": libs[name][1],
                          "blocks_per_sm_170": libs[name][0].fused_mvn_smem_blocks_per_sm(170)}
                   for name in order}
        for n in SIZES:
            y, cov = block_inputs(cs.BLOCKS.index(n), cs.NWALKERS)
            b = y.shape[0]
            cov[b // 2] = -torch.eye(n, device=dev)
            plain = fm.fused_mvn_loglike_plain(y, cov)
            keep = torch.arange(b, device=dev) != b // 2

            def run(lib):
                out = torch.empty((b,), dtype=torch.float32, device=dev)
                err = lib.fused_mvn_loglike_smem(y.data_ptr(), cov.data_ptr(), out.data_ptr(),
                                                 b, n, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise SystemExit(f"CUDA error {err}")
                return out

            for name in order:
                got = run(libs[name][0])
                torch.cuda.synchronize()
                _, rel_err = cs.normwise(got[keep], plain[keep])
                if name not in DIAGNOSTIC and not (got[b // 2] == -torch.inf
                                                   and rel_err <= cs.TOL_MVN):
                    raise SystemExit(f"variant {name} at n = {n} disagrees with the plain "
                                     f"elimination ({rel_err:.3e})")
                results[name][f"err_{n}"] = rel_err
            for names in (order, order[::-1]):
                for name in names:
                    ms = cs.graph_ms(lambda lib=libs[name][0]: run(lib), reps=20)
                    results[name].setdefault(f"ms_{n}", []).append(ms)
            for name in order:
                t = results[name][f"ms_{n}"]
                print(f"n = {n:3d} (b = {b}) {name:9s} {t[0]:.4f} / {t[1]:.4f} ms "
                      f"(two passes, CUDA-graph replay), normwise vs plain "
                      f"{results[name][f'err_{n}']:.2e}", flush=True)
    print(smi)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                      "walkers": cs.NWALKERS, "variants": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
