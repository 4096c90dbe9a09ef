"""Design variants of the MVN kernel on one GPU: edits of
``gpbayestools_hic_tpu_torch/csrc/fused_mvn.cu`` built side by side and
timed on the flagship's own covariances.

Run from the repository root on a CUDA machine:

    python3 tools/torch_mvn_variants.py [--route panel|smem] [--parent DIR ...]
                                        [--variants NAME,...]

``--route panel`` (the default) times the wide route
(``fused_mvn_loglike_panel``) on the stitched-wide chain's own covariances
(chip_smoke.py's fifth path: the flagship's blocks twice, 1088
observables) at (512, 1088), and on their leading blocks at (16, 767) and
at (512, 544), the stitched likelihood of a half-ensemble (512 walkers);
``--route smem`` the shared-memory route on the flagship's blocks (n = 170,
73, 28, 21, 14, 12; a half-ensemble of 512 walkers and 1024; n = 28 and 12
also at b = 16384, past the warps the card holds at once).  Variants of the committed source (the script fails if an
edit no longer applies):

- ``kept``: the source as committed;
- wide route: ``wpanel_32`` / ``wpanel_128`` (``WIDE_PANEL``, the columns
  per trailing pass, not 64; at 128 two CTAs' shared memory no longer fit
  an SM), ``fma_trailing`` (the trailing update in FP32 FMA, not 3xTF32 on
  the tensor cores), ``one_cta_per_sm`` (the kernel built for one CTA per
  SM at every b), ``two_ctas_per_sm`` (for two at every b, at most 128
  registers), ``cluster_max_4`` (clusters of at most four CTAs),
  ``cluster_min_2`` (at least two, also where the batch fills the card),
  ``cluster_16`` (up to 16 CTAs, past the portable size, b C filled up to
  twice the SMs), ``chunk_128`` (128 rows below the panel per chunk, not
  256), ``stages_3`` (the trailing update's cp.async ring three stages
  deep, not two), and the diagnostics ``wide_no_top_steps`` (the panel's
  top rows not factored), ``wide_no_row_steps`` (the rows below loaded
  and stored, not finished), ``wide_no_trailing`` (no trailing update),
  ``wide_loads_only`` (none of the three: the loads, the L rows' writes
  and the barriers) and ``wide_no_products`` (the trailing tiles loaded
  and stored, no products); in every diagnostic a bad pivot does not end
  the matrix, so the garbage runs the whole elimination;
- shared-memory route: ``panel_8`` / ``panel_16`` / ``panel_32``
  (``SMEM_PANEL`` set to that width, the committed one left out); its
  block kernel (n > 32): ``load_then_factor`` (panel 0's diagonal block
  factored after the load, not during it), ``no_lookahead`` (each
  diagonal block factored after the trailing update, not during it: one
  more block barrier per panel), ``threads_256`` / ``threads_128`` (at
  every n, not 128 below n = 128 and 256 from it), ``four_blocks`` (a
  launch bound of four 256-thread blocks per SM), ``phase_clock``
  (kSmemPhaseClock set: thread 0, whose warp factors the diagonal blocks,
  and thread 32, whose warp takes trailing tiles, count the SM cycles of
  each phase; the script prints the split of one call); its warp kernel
  (n <= 32): ``warp_warps_8`` (eight matrices per block, not four),
  ``warp_rows_32`` (32 rows of registers at every n, not 16 up to n = 16);
  ``two_blocks`` (the block kernel built for two 256-thread blocks per SM,
  not three), ``tile_cols_8`` (trailing tiles of 4 x 8 outputs per
  thread, 16 x 64 per warp, not 4 x 4);
  and the diagnostics ``load_only`` (the load and panel 0's block),
  ``no_block_factor``, ``no_trailing_update``.

Diagnostics give wrong results by design and are not checked.  A variant
whose launch the card refuses (a cluster it cannot place) is reported and
left out.

``--variants NAME,...`` builds and times only those variants (``kept``
and the parents always).  ``--parent DIR`` adds the ``fused_mvn.cu`` of another checkout (e.g. the
parent commit unpacked with ``git archive``) as the variant ``parent``
(given again: ``parent2``, ...).  On the wide route's cases a source
without ``fused_mvn_panel_scratch``
(``mvn_panel_kernel``, the route before the wide one) gets the
(b, n + 1, n + 1) scratch it needs, and one with it but without
``fused_mvn_panel_sms`` (an earlier wide route whose shared memory grew
with n) rows of whole float4s.  Scratch is allocated outside the timing.

Every variant is checked against the plain elimination (chip_smoke.py's
TOL_MVN, one non-PD matrix planted) and timed by CUDA-graph replay
(``chip_smoke.graph_ms``) twice, in the order variants, then variants
reversed, so that drift shows as a difference between the two passes.  It
prints each variant's ptxas report for the route's kernels, its occupancy
(the shared-memory route's matrices per SM at each n, or blocks per SM at
n = 170 for a source of one block per matrix; or the wide route's cluster
size, CTAs per SM and clusters placed per case), the card's name and power
limit, and one JSON line.  Imports nothing of JAX.
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
SIZES = (170, 73, 28, 21, 14, 12)
#: the shared-memory route's batches: a half-ensemble of run_mcmc, and 1024
SMEM_BATCHES = (512, 1024)
#: the warp kernel also at a batch past the warps the card holds at once
WARP_LARGE_B = 16384
WARP_LARGE_SIZES = (28, 12)

_NO_STEPS = ("    for (int s = 0; s * S < pw; ++s) {", "    for (int s = pw; s * S < pw; ++s) {")
# a diagnostic's garbage must not stop a matrix at its first bad pivot
_NO_EXIT = ("    failed |= bad_pivot(p);\n    if (lane == j) mine = p;\n"
            "    const float s = x[j] * __frcp_rn(p);\n    if (lane > j && lane < sw)",
            "    if (lane == j) mine = p;\n"
            "    const float s = x[j] * __frcp_rn(p);\n    if (lane > j && lane < sw)")
_NO_WIDE_TRAILING = ("    wide_trailing(ring, a, cov_b, y_b, n, ld, c0, pw, C, r);\n", "")
_NO_TOP_STEPS = ("    for (int s = 0; s < nsteps; ++s) {\n      const int cs = s * S, sw = min(S, pw - cs), cs1",
                 "    for (int s = nsteps; s < nsteps; ++s) {\n      const int cs = s * S, sw = min(S, pw - cs), cs1")
_NO_ROW_STEPS = ("      for (int lr = tid; lr < rows; lr += WIDE_THREADS) {\n        float* row = pan",
                 "      for (int lr = rows; lr < rows; lr += WIDE_THREADS) {\n        float* row = pan")
_CTAS_PER_SM = "  return ((long long)b * c > sms && 2 * (wide_bytes() + 1024) <= SM_SMEM) ? 2 : 1;"
_MAX_CLUSTER = "constexpr int WIDE_MAX_CLUSTER = 8;"
PANEL_EDITS = {
    "wpanel_32": [("constexpr int WIDE_PANEL = 64;", "constexpr int WIDE_PANEL = 32;")],
    "wpanel_128": [("constexpr int WIDE_PANEL = 64;", "constexpr int WIDE_PANEL = 128;")],
    "fma_trailing": [("constexpr bool kWideTensorCores = true;",
                      "constexpr bool kWideTensorCores = false;")],
    "one_cta_per_sm": [(_CTAS_PER_SM, "  return 1;")],
    "two_ctas_per_sm": [(_CTAS_PER_SM, "  return 2 * (wide_bytes() + 1024) <= SM_SMEM ? 2 : 1;")],
    "cluster_max_4": [(_MAX_CLUSTER, "constexpr int WIDE_MAX_CLUSTER = 4;")],
    "cluster_min_2": [("  return max(1, min((sms + b - 1) / b, WIDE_MAX_CLUSTER));",
                       "  return max(2, min((sms + b - 1) / b, WIDE_MAX_CLUSTER));")],
    # up to 16 CTAs, past the portable size, b C filled up to twice the SMs
    "cluster_16": [(_MAX_CLUSTER, "constexpr int WIDE_MAX_CLUSTER = 16;"),
                   ("  return max(1, min((sms + b - 1) / b, WIDE_MAX_CLUSTER));",
                    "  return max(1, min((2 * sms + b - 1) / b, WIDE_MAX_CLUSTER));"),
                   ("                                 wide_bytes());\n",
                    "                                 wide_bytes());\n"
                    "    if (err == cudaSuccess)\n"
                    "      err = cudaFuncSetAttribute(kernel, "
                    "cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n")],
    "chunk_128": [("constexpr int WIDE_CHUNK = 256;", "constexpr int WIDE_CHUNK = 128;")],
    "stages_3": [("constexpr int WIDE_STAGES = 2;", "constexpr int WIDE_STAGES = 3;")],
    "wide_no_top_steps": [_NO_TOP_STEPS, _NO_EXIT],
    "wide_no_row_steps": [_NO_ROW_STEPS, _NO_EXIT],
    "wide_no_trailing": [_NO_WIDE_TRAILING, _NO_EXIT],
    "wide_loads_only": [_NO_TOP_STEPS, _NO_ROW_STEPS, _NO_WIDE_TRAILING, _NO_EXIT],
    "wide_no_products": [("    if (!idle) {\n      if constexpr (kWideTensorCores) {",
                          "    if (false) {\n      if constexpr (kWideTensorCores) {"), _NO_EXIT],
}
#: wide-route variants whose results are wrong by design
PANEL_DIAGNOSTIC = tuple(k for k in PANEL_EDITS if k.startswith("wide_"))
#: the wide route's cases: (b, n)
PANEL_CASES = ((16, 767), (512, 1088), (512, 544))

_SMEM_FIRST = ("  if (warp == 0) smem_factor_block(a, cov_b, y_b, dg, isq, bad, 0, n, logdet_half);\n"
               "  cp_async_wait_all();\n")
_SMEM_THREADS = "constexpr int smem_threads(int n) { return n < 128 ? 128 : 256; }"
EDITS = {
    # block kernel: panel 0's block factored after the load, not during it
    "load_then_factor": [(_SMEM_FIRST,
                          "  cp_async_wait_all();\n"
                          "  __syncthreads();\n"
                          "  if (warp == 0) smem_factor_block(a, cov_b, y_b, dg, isq, bad, 0, n, "
                          "logdet_half);\n")],
    # each diagonal block factored after the trailing update, not during it
    # (one more block barrier per panel)
    "no_lookahead": [
        ("    const bool ahead = k + 1 < npan;", "    const bool ahead = false;"),
        ("    __syncthreads();  // A\n",
         "    __syncthreads();  // A\n"
         "    if (k > 0 && warp == 0)\n"
         "      smem_factor_block(a, cov_b, y_b, dg, isq, bad, c0, n, logdet_half);\n"
         "    __syncthreads();\n")],
    "threads_256": [(_SMEM_THREADS, "constexpr int smem_threads(int) { return 256; }")],
    "threads_128": [(_SMEM_THREADS, "constexpr int smem_threads(int) { return 128; }")],
    "four_blocks": [("__launch_bounds__(kThreads, kThreads == 256 ? 3 : 6)",
                     "__launch_bounds__(kThreads, kThreads == 256 ? 4 : 6)")],
    # warp kernel: eight matrices per block, not four; 32-row registers at
    # every n, not 16 up to n = 16
    "warp_warps_8": [("constexpr int WARP_WARPS = 4;", "constexpr int WARP_WARPS = 8;")],
    "warp_rows_32": [("return n <= 16 ? mvn_warp_kernel<16> : mvn_warp_kernel<32>;",
                      "return mvn_warp_kernel<32>;")],
    # the block kernel built for two 256-thread blocks per SM (no register cap that spills)
    "two_blocks": [("__launch_bounds__(kThreads, kThreads == 256 ? 3 : 6)",
                    "__launch_bounds__(kThreads, kThreads == 256 ? 2 : 6)")],
    # trailing tiles of 4 x 8 outputs per thread (16 x 64 per warp), not 4 x 4
    "tile_cols_8": [("constexpr int SMEM_TILE_COLS = 4;", "constexpr int SMEM_TILE_COLS = 8;")],
    "phase_clock": [("constexpr bool kSmemPhaseClock = false;",
                     "constexpr bool kSmemPhaseClock = true;")],
    # diagnostics: the load (and panel 0's block) only; no diagonal block
    # factored; no trailing update
    "load_only": [("  for (int k = 0; k < npan; ++k) {\n    const int c0 = k * P, pw = min(P, n - c0), "
                   "c1 = c0 + pw;\n    __syncthreads();  // A",
                   "  for (int k = npan; k < npan; ++k) {\n    const int c0 = k * P, pw = min(P, n - c0), "
                   "c1 = c0 + pw;\n    __syncthreads();  // A")],
    "no_block_factor": [("  const int i = c0 + lane;  // this lane's row\n",
                         "  const int i = c0 + lane;  // this lane's row\n"
                         "  if (lane == 0) *bad = 0;\n  if (c0 >= 0) return;\n")],
    # (warp 1 still signals warp 0, which waits for the next diagonal block)
    "no_trailing_update": [("        if (t >= nblk) break;\n",
                            "        if (t >= nblk) break;\n"
                            "        if (ahead && tile == 0) named_bar_arrive(1, 64);\n"
                            "        continue;\n")],
}
#: variants whose results are wrong by design (timing breakdowns only)
DIAGNOSTIC = ("load_only", "no_block_factor", "no_trailing_update")


def apply_edits(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"edit no longer applies to the source: {old[:70]!r}")
        text = text.replace(old, new)
    return text


def variant_sources(src: str, parents=(), route: str = "smem") -> dict[str, str]:
    """name -> source text of every variant of the route."""
    out = {"kept": src}
    if route == "panel":
        for name, edits in PANEL_EDITS.items():
            out[name] = apply_edits(src, edits)
    else:
        found = WIDTH_LINE.findall(src)
        if len(found) != 1:
            raise SystemExit("SMEM_PANEL is no longer one constexpr line of fused_mvn.cu")
        for width in (8, 16, 32):
            if width != int(found[0]):
                out[f"panel_{width}"] = WIDTH_LINE.sub(f"constexpr int SMEM_PANEL = {width};",
                                                       src)
        for name, edits in EDITS.items():
            out[name] = apply_edits(src, edits)
    for i, path in enumerate(parents):
        with open(path) as f:
            out["parent" + (str(i + 1) if i else "")] = f.read()
    return out


def ptxas_report(log: str, kernel="mvn_smem_kernel") -> str:
    """"R registers, S bytes spilled" of the route's kernel (or of each of a
    tuple of kernels), each build of it (a template's instances) in the
    order ptxas reports them."""
    lines = log.splitlines()
    found = []
    for name in (kernel,) if isinstance(kernel, str) else kernel:
        for i, line in enumerate(lines):
            if "Compiling entry" in line and name in line:
                spill = re.search(r"(\d+) bytes spill stores", lines[i + 2])
                regs = re.search(r"Used (\d+) registers", lines[i + 3])
                inst = re.search(name + r"ILi(\d+)E", line)
                found.append(f"{name}" + (f"<{inst.group(1)}> " if inst else " ")
                             + f"{regs.group(1)} registers, {spill.group(1)} bytes spilled")
    return "; ".join(found) or "not found"


def build(tmp: str, sources: dict[str, str], kernel="mvn_smem_kernel"):
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
        _P, _I = ctypes.c_void_p, ctypes.c_int
        for entry, argtypes in (
            ("fused_mvn_loglike_smem", [_P] * 3 + [_I] * 2 + [_P]),
            ("fused_mvn_loglike_panel", [_P] * 4 + [_I] * 2 + [_P]),
            ("fused_mvn_smem_matrices_per_sm", [_I]),
            ("fused_mvn_smem_blocks_per_sm", [_I]),
            ("fused_mvn_smem_phase_cycles", [_P]),
            ("fused_mvn_panel_scratch", [_I]),
            ("fused_mvn_panel_cluster", [_I]),
            ("fused_mvn_panel_ctas_per_sm", [_I]),
            ("fused_mvn_panel_active", [_I]),
        ):
            if hasattr(lib, entry):
                getattr(lib, entry).restype = _I
                getattr(lib, entry).argtypes = argtypes
        if hasattr(lib, "fused_mvn_panel_sms"):  # the wide route's scratch size is 64-bit
            lib.fused_mvn_panel_scratch.restype = ctypes.c_longlong
        if kernel == "mvn_wide_kernel" and not hasattr(lib, "fused_mvn_panel_scratch"):
            out[name] = (lib, ptxas_report(log, "mvn_panel_kernel"))
        else:
            out[name] = (lib, ptxas_report(log, kernel))
    return out


def occupancy(lib, route: str) -> str:
    if route == "smem":
        if not hasattr(lib, "fused_mvn_smem_matrices_per_sm"):  # one block per matrix
            return f"{lib.fused_mvn_smem_blocks_per_sm(170)} blocks per SM at n = 170"
        return ", ".join(f"{lib.fused_mvn_smem_matrices_per_sm(n)} matrices per SM at n = {n}"
                         for n in SIZES)
    if not hasattr(lib, "fused_mvn_panel_scratch"):
        return "one block per matrix (no clusters in this source)"
    if not hasattr(lib, "fused_mvn_panel_sms"):
        return "an earlier wide route (its layout not asked)"
    return "; ".join(f"(b={b}, n={n}): clusters of {lib.fused_mvn_panel_cluster(b)}, "
                     f"{lib.fused_mvn_panel_ctas_per_sm(b)} CTAs per SM, "
                     f"{lib.fused_mvn_panel_active(b)} placed at once"
                     for b, n in PANEL_CASES)


SMEM_PHASES = ("load and panel 0's block", "barrier A", "substitution", "barrier B",
               "trailing update / look-ahead", "exit")


def phase_split(lib, run) -> str:
    """The phase_clock variant's split of one call of the shared-memory
    route's block kernel: SM cycles per phase, summed over the blocks, as
    shares of their sum, for thread 0, whose warp factors the diagonal
    blocks, and thread 32, whose warp takes trailing tiles."""
    import torch

    read = lib.fused_mvn_smem_phase_cycles
    buf = (ctypes.c_ulonglong * (2 * len(SMEM_PHASES) + 1))()
    read(buf)  # clear
    run()
    torch.cuda.synchronize()
    if read(buf):
        raise SystemExit("phase clock readout failed")
    k = len(SMEM_PHASES)
    blocks = max(buf[2 * k], 1)
    parts = []
    for who, off in (("thread 0 (factoring warp)", 0), ("thread 32 (trailing warp)", k)):
        total = sum(buf[off:off + k]) or 1
        parts.append(f"{who}: " + ", ".join(f"{name} {buf[off + i] / total:.3f}"
                                           for i, name in enumerate(SMEM_PHASES))
                     + f"; {total / blocks:.0f} cycles per block")
    return f"phase split ({blocks} blocks, SM cycles): " + " | ".join(parts)


def launcher(lib, route: str, y, cov):
    """A function that launches the variant's route on (y, cov) into a new
    output (the wide route with a scratch allocated once, here)."""
    import torch

    b, n = y.shape
    dev = y.device
    if route == "panel":
        per = (lib.fused_mvn_panel_scratch(n) if hasattr(lib, "fused_mvn_panel_scratch")
               else (n + 1) * (n + 1))
        scratch = torch.empty((b, per), dtype=torch.float32, device=dev)

        def call(out, stream):
            return lib.fused_mvn_loglike_panel(y.data_ptr(), cov.data_ptr(), scratch.data_ptr(),
                                               out.data_ptr(), b, n, stream)
    else:
        entry = getattr(lib, "fused_mvn_loglike_" + route)

        def call(out, stream):
            return entry(y.data_ptr(), cov.data_ptr(), out.data_ptr(), b, n, stream)

    def run():
        out = torch.empty((b,), dtype=torch.float32, device=dev)
        err = call(out, torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"CUDA error {err}")
        return out

    return run


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_mvn_variants: no CUDA device available", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--route", choices=("panel", "smem"), default="panel")
    parser.add_argument("--parent", action="append", default=[],
                        help="root of another checkout to time beside this one")
    parser.add_argument("--variants", help="comma-separated variants to time (default: all)")
    args = parser.parse_args()
    route = args.route
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
    kernel = {"smem": ("mvn_smem_kernel", "mvn_warp_kernel"), "panel": "mvn_wide_kernel"}[route]
    diagnostic = {"smem": DIAGNOSTIC, "panel": PANEL_DIAGNOSTIC}[route]
    with tempfile.TemporaryDirectory(prefix="mvn_variants_") as tmp:
        sources = variant_sources(src, parents, route)
        if args.variants:
            wanted = {"kept", *args.variants.split(",")}
            unknown = wanted - set(sources)
            if unknown:
                raise SystemExit(f"no such variant: {sorted(unknown)}")
            sources = {name: text for name, text in sources.items()
                       if name in wanted or name.startswith("parent")}
        libs = build(tmp, sources, kernel)
        order = list(libs)
        results = {name: {"ptxas": libs[name][1], "occupancy": occupancy(libs[name][0], route)}
                   for name in order}
        for name in order:
            print(f"{name:26s} ptxas: {results[name]['ptxas']}; {results[name]['occupancy']}",
                  flush=True)
        blocks = cs.WIDE_BLOCKS if route == "panel" else cs.BLOCKS
        chain, _ = build_synthetic_chain(nev=cs.NEV, ndim=cs.NDIM, nobs_blocks=blocks,
                                         npc=cs.NPC, gp_maxiter=0, seed=1 if route == "panel" else 0,
                                         tmpdir=tmp, device=dev)
        block_inputs = cs.mvn_inputs(chain, dev, blocks)
        if route == "panel":
            stitched = cs.stitched_inputs(chain, dev, block_inputs, blocks)
            cases = []
            for b, n in PANEL_CASES:
                y, cov = stitched(b)
                cases.append((y[:, :n].contiguous(), cov[:, :n, :n].contiguous()))
                del y, cov
        else:
            cases = [block_inputs(cs.BLOCKS.index(n), b) for b in SMEM_BATCHES for n in SIZES]
            # the warp kernel past the warps the card holds (each warp takes
            # several matrices): the 1024 walkers' matrices repeated
            for n in WARP_LARGE_SIZES:
                y, cov = block_inputs(cs.BLOCKS.index(n), cs.NWALKERS)
                reps = WARP_LARGE_B // cs.NWALKERS
                cases.append((y.repeat(reps, 1).contiguous(), cov.repeat(reps, 1, 1).contiguous()))
        for y, cov in cases:
            b, n = y.shape
            cov[b // 2] = -torch.eye(n, device=dev)
            plain = fm.fused_mvn_loglike_plain(y, cov)
            keep = torch.arange(b, device=dev) != b // 2
            runs = {name: launcher(libs[name][0], route, y, cov) for name in order}
            case_order = list(order)
            for name in list(case_order):
                try:
                    got = runs[name]()
                    torch.cuda.synchronize()
                except SystemExit as err:  # a configuration the card refuses
                    print(f"variant {name} at n = {n}: launch refused ({err}); left out",
                          flush=True)
                    case_order.remove(name)
                    if name in order:
                        order.remove(name)
                    continue
                _, rel_err = cs.normwise(got[keep], plain[keep])
                if name not in diagnostic and not (got[b // 2] == -torch.inf
                                                   and rel_err <= cs.TOL_MVN):
                    if name == "kept":
                        raise SystemExit(f"the committed source at n = {n} disagrees with the "
                                         f"plain elimination ({rel_err:.3e})")
                    print(f"VARIANT {name} at n = {n} DISAGREES with the plain elimination "
                          f"({rel_err:.3e}); left out", flush=True)
                    case_order.remove(name)
                    if name in order:
                        order.remove(name)
                    continue
                results[name][f"err_{b}_{n}"] = rel_err
            reps = {"smem": 20, "panel": 2 if b > 64 else 8}[route]
            for names in (case_order, case_order[::-1]):
                for name in names:
                    ms = cs.graph_ms(runs[name], reps=reps)
                    results[name].setdefault(f"ms_{b}_{n}", []).append(ms)
            if "phase_clock" in libs and n > fm.WARP_MAX_N:
                print(phase_split(libs["phase_clock"][0], runs["phase_clock"]), flush=True)
            for name in case_order:
                t = results[name][f"ms_{b}_{n}"]
                print(f"n = {n:3d} (b = {b}) {name:26s} {t[0]:.4f} / {t[1]:.4f} ms "
                      f"(two passes, CUDA-graph replay), normwise vs plain "
                      f"{results[name][f'err_{b}_{n}']:.2e}", flush=True)
    print(smi)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "route": route,
                      "variants": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
