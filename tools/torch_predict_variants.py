"""Design checks of the fused predict kernels on one GPU: variants of
``gpbayestools_hic_tpu_torch/csrc/fused_predict.cu`` built side by side and
timed at the flagship shape.

Run from the repository root on a CUDA machine:

    python3 tools/torch_predict_variants.py [--parent DIR]

``--parent DIR`` adds the ``fused_predict.cu`` of another checkout (e.g. the
parent commit unpacked with ``git archive``) as the variant ``parent``, so
that the two are timed in one process on one card.

Each variant is the committed source with a few text edits (the script
fails if an edit no longer applies to the source):

- ``kept``: the source as committed (G split into TF32 halves as its
  fragments are read, integer TF32 rounding, each step's products added to
  the accumulator in FP32, the backward's xs rows loaded four at a time);
- ``g_split_in_memory``: G and alpha split into TF32 halves once, in device
  memory (what the TPU package's ``attach_fused_factors`` does for bf16),
  two A tiles per ring stage and no split in the kernel; two ring stages so
  that two blocks still fit on an SM;
- ``cvt_rounding``: TF32 rounding by ``cvt.rna.tf32.f32``;
- ``no_promotion``: the forward's products accumulate straight into the
  accumulator;
- ``high_one_block_per_sm``: the three-pass backward (kernel 3) given one
  block per SM, and so up to 255 registers, on its 16-byte route too;
- ``rows_1_at_a_time`` / ``rows_16_at_a_time``: the backward's xs rows
  loaded one / sixteen per thread at a time;
- ``no_copies`` / ``no_products``: the ring's copies / the tensor-core
  products switched off in both kernels (wrong results; what is left of
  the time is the other part plus the epilogue).

For each it prints the ptxas registers and spills of the tensor-core
kernels, the device time of the forward, the fast backward and the
three-pass backward (CUDA events
around a rotation over the 9 emulators' factors of the flagship chain,
1024 walkers), their normwise errors against the plain forward and
backward in float64 (the backwards are given the plain forward's v), then
the card's name and power limit and one JSON line.  Imports nothing of JAX.
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

_SPLIT_A = """          split_tf32(ar[0], ah[0], al[0]);
          split_tf32(ar[8 * A_FWD_LD], ah[1], al[1]);
          split_tf32(ar[4], ah[2], al[2]);
          split_tf32(ar[8 * A_FWD_LD + 4], ah[3], al[3]);"""

# the forward's ring with two stages (two blocks per SM with doubled A tiles)
_RING2 = """template <int kStage, class Load, class Compute>
__device__ __forceinline__ void run_ring2(float* ring, int ktiles, Load load, Compute compute) {
  if (0 < ktiles) load(ring, 0);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<0>();
    __syncthreads();
    if (kt + 1 < ktiles) load(ring + ((kt + 1) % 2) * kStage, kt + 1);
    cp_async_commit();
    compute(ring + (kt % 2) * kStage, kt);
  }
  cp_async_wait<0>();
  __syncthreads();
}

"""

VARIANTS = {
    "kept": [],
    "g_split_in_memory": [
        ("constexpr int FWD_STAGE = TM * A_FWD_LD + TK * B_LD;",
         "constexpr int FWD_STAGE = 2 * TM * A_FWD_LD + TK * B_LD;"),
        ("constexpr int FWD_SMEM = STAGES * FWD_STAGE * 4;",
         "constexpr int FWD_SMEM = 2 * FWD_STAGE * 4;"),
        ("// Rows [l0, l0 + kRows) of xs_k", _RING2 + "// Rows [l0, l0 + kRows) of xs_k"),
        ("run_ring<FWD_STAGE>(", "run_ring2<FWD_STAGE>("),
        ("      float* Bs = st + TM * A_FWD_LD;", "      float* Bs = st + 2 * TM * A_FWD_LD;"),
        ("      const float* Bs = st + TM * A_FWD_LD;",
         "      const float* Bs = st + 2 * TM * A_FWD_LD;"),
        ("              const float* __restrict__ kst,     // (b, n, mp)",
         "              const float* __restrict__ kst,     // (b, n, mp)\n"
         "              const float* __restrict__ G_lo, const float* __restrict__ alpha_lo,"),
        ("  const float* kst_k = kst + (size_t)k * n * mp;",
         "  const float* kst_k = kst + (size_t)k * n * mp;\n"
         "  const float* gl_k = G_lo + (size_t)k * n * n;\n"
         "  const float* al_k = alpha_lo + (size_t)k * n;"),
        ("          cp_async16(As + row * A_FWD_LD + col, src, ok);",
         "          cp_async16(As + row * A_FWD_LD + col, src, ok);\n"
         "          cp_async16(As + TM * A_FWD_LD + row * A_FWD_LD + col,\n"
         "                     !ok ? gl_k : (i < n ? gl_k + (size_t)i * n + l : al_k + l), ok);"),
        ("          cp_async4(As + row * A_FWD_LD + col, src, ok);",
         "          cp_async4(As + row * A_FWD_LD + col, src, ok);\n"
         "          cp_async4(As + TM * A_FWD_LD + row * A_FWD_LD + col,\n"
         "                    !ok ? gl_k : (i < n ? gl_k + (size_t)i * n + l : al_k + l), ok);"),
        (_SPLIT_A,
         "          const float* arl = ar + TM * A_FWD_LD;\n"
         "          const int o[4] = {0, 8 * A_FWD_LD, 4, 8 * A_FWD_LD + 4};\n"
         "#pragma unroll\n"
         "          for (int q = 0; q < 4; ++q) {\n"
         "            ah[q] = __float_as_uint(ar[o[q]]);\n"
         "            al[q] = __float_as_uint(arl[o[q]]);\n"
         "          }"),
        ("                      float* mean, float* qf, float* v, float* scratch,\n"
         "                      int b, int n, int m, int d, void* stream) {",
         "                      float* mean, float* qf, float* v, float* scratch,\n"
         "                      int b, int n, int m, int d, void* stream,\n"
         "                      const float* G_lo, const float* alpha_lo) {"),
        ("(G, alpha, kst, mean, qf_part, v, n, m, mp,",
         "(G, alpha, kst, G_lo, alpha_lo, mean, qf_part, v, n, m, mp,"),
    ],
    "cvt_rounding": [
        ("  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;",
         "  uint32_t r;\n  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(r) : \"f\"(x));\n  return r;"),
    ],
    "rows_1_at_a_time": [("load_rows<TM, TC_NT, 4>", "load_rows<TM, TC_NT, 1>")],
    "rows_16_at_a_time": [("load_rows<TM, TC_NT, 4>", "load_rows<TM, TC_NT, 16>")],
    "no_copies": [
        ("    if (s < ktiles) load(ring + s * kStage, s);", ""),
        ("    if (nxt < ktiles) load(ring + (nxt % STAGES) * kStage, nxt);", ""),
    ],
    "no_products": [("    compute(ring + (kt % STAGES) * kStage, kt);", "")],
    "high_one_block_per_sm": [
        ("__global__ void __launch_bounds__(TC_NT, kVec ? 2 : 1)\nbwd_tc_kernel(",
         "__global__ void __launch_bounds__(TC_NT, (kVec && kPasses == 1) ? 2 : 1)\n"
         "bwd_tc_kernel("),
    ],
    "no_promotion": [
        ("            float part[4] = {0.f, 0.f, 0.f, 0.f};\n"
         "            mma_tf32(part, al, bh[ni]);   // small terms first\n"
         "            mma_tf32(part, ah, bl[ni]);\n"
         "            mma_tf32(part, ah, bh[ni]);\n"
         "#pragma unroll\n"
         "            for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[e];",
         "            mma_tf32(acc[mi][ni], al, bh[ni]);\n"
         "            mma_tf32(acc[mi][ni], ah, bl[ni]);\n"
         "            mma_tf32(acc[mi][ni], ah, bh[ni]);"),
    ],
}


def variant_source(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"edit no longer applies to the source: {old[:70]!r}")
        text = text.replace(old, new)
    return text


def build(tmp: str, parent: str | None = None) -> dict:
    """Compile every variant at once (one nvcc each); name -> CDLL."""
    from gpbayestools_hic_tpu_torch.ops import _build

    rel = os.path.join("gpbayestools_hic_tpu_torch", _build.SOURCES["fused_predict"])
    src = open(os.path.join(ROOT, rel)).read()
    sources = {name: variant_source(src, edits) for name, edits in VARIANTS.items()}
    if parent is not None:
        sources["parent"] = open(os.path.join(parent, rel)).read()
    procs = {}
    for name, text in sources.items():
        cu, so = os.path.join(tmp, f"{name}.cu"), os.path.join(tmp, f"lib{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs, ptxas = {}, {}
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name} does not build:\n{out}")
        ptxas[name] = ptxas_report(out)
        lib = ctypes.CDLL(so)
        lib.fused_predict_scratch.restype = ctypes.c_longlong
        lib.fused_predict_scratch.argtypes = [ctypes.c_int] * 5
        lib.fused_predict_fwd.restype = ctypes.c_int
        extra = 2 if name == "g_split_in_memory" else 0
        lib.fused_predict_fwd.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                                          + [ctypes.c_void_p] * (1 + extra))
        for entry in ("fused_predict_bwd", "fused_predict_bwd_high"):
            getattr(lib, entry).restype = ctypes.c_int
            getattr(lib, entry).argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        libs[name] = lib
    return libs, ptxas


def ptxas_report(log: str) -> dict:
    """{kernel: "R registers, S bytes spilled"} for the tensor-core kernels
    (the backward's instances by copy route and pass count)."""
    out, lines = {}, log.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"\d(fwd_tc_kernel|bwd_tc_kernel)ILb([01])E(?:Li(\d)E)?", line)
        if "Compiling entry" in line and m:
            spill = re.search(r"(\d+) bytes spill stores", lines[i + 2])
            regs = re.search(r"Used (\d+) registers", lines[i + 3])
            route = "16-byte" if m.group(2) == "1" else "4-byte"
            passes = f", {m.group(3)} pass{'es' if m.group(3) != '1' else ''}" if m.group(3) else ""
            out[f"{m.group(1)} ({route}{passes})"] = (f"{regs.group(1)} registers, "
                                                      f"{spill.group(1)} bytes spilled")
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_predict_variants: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gpbayestools_hic_tpu_torch.ops import fused_predict as fp
    from gpbayestools_hic_tpu_torch.utils.synthetic import build_synthetic_chain

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", help="root of another checkout to time beside this one")
    parent = parser.parse_args().parent
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    with tempfile.TemporaryDirectory(prefix="predict_variants_") as tmp:
        libs, ptxas = build(tmp, parent)
        chain, _ = build_synthetic_chain(nev=cs.NEV, ndim=cs.NDIM, nobs_blocks=cs.BLOCKS,
                                         npc=cs.NPC, gp_maxiter=0, seed=0, tmpdir=tmp, device=dev)
        states = [e._fused for e in chain.emuList]

        def tf32(x):
            return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)

        halves = [(tf32(s.G), tf32(s.alpha)) for s in states]
        lows = [((s.G - gh).contiguous(), (s.alpha - ah).contiguous())
                for s, (gh, ah) in zip(states, halves)]
        b, n, d = states[0].xs.shape
        m = cs.NWALKERS
        xq = torch.tensor(np.random.default_rng(1).uniform(0.0, 1.0, (m, d)),
                          dtype=torch.float32, device=dev)
        rng = np.random.default_rng(2)
        ct_mean = torch.tensor(rng.normal(size=(b, m)), dtype=torch.float32, device=dev)
        ct_qf = torch.tensor(rng.normal(size=(b, m)), dtype=torch.float32, device=dev)
        vs = [fp.fused_fwd_plain(s, xq, save_v=True)[2] for s in states]
        fs64 = fp.FusedState(*(t.double() for t in states[0]))
        mean64, qf64, _ = fp.fused_fwd_plain(fs64, xq.double())
        g64 = fp.fused_bwd_plain(fs64, xq.double(), vs[0].double(), ct_mean.double(),
                                 ct_qf.double())
        stream = torch.cuda.current_stream().cuda_stream
        results = {}
        for name, lib in libs.items():
            split = name == "g_split_in_memory"

            def fwd(i, lib=lib, split=split):
                s = states[i]
                f32 = dict(dtype=torch.float32, device=dev)
                mean, qf = torch.empty((b, m), **f32), torch.empty((b, m), **f32)
                v = torch.empty((b, n, m), **f32)
                scratch = torch.empty(lib.fused_predict_scratch(0, b, n, m, d), **f32)
                g, a = halves[i] if split else (s.G, s.alpha)
                extra = [lows[i][0].data_ptr(), lows[i][1].data_ptr()] if split else []
                err = lib.fused_predict_fwd(
                    s.xs.data_ptr(), xq.data_ptr(), s.inv_ls.data_ptr(), g.data_ptr(),
                    a.data_ptr(), s.amp.data_ptr(), mean.data_ptr(), qf.data_ptr(),
                    v.data_ptr(), scratch.data_ptr(), b, n, m, d, stream, *extra)
                if err:
                    raise SystemExit(f"variant {name}: CUDA error {err}")
                return mean, qf

            def bwd(i, lib=lib, entry="fused_predict_bwd"):
                s = states[i]
                f32 = dict(dtype=torch.float32, device=dev)
                part = torch.empty(lib.fused_predict_scratch(1 if entry == "fused_predict_bwd"
                                                             else 2, b, n, m, d), **f32)
                ct_q = torch.empty((b, m, d), **f32)
                err = getattr(lib, entry)(
                    s.xs.data_ptr(), xq.data_ptr(), s.inv_ls.data_ptr(), s.G.data_ptr(),
                    s.alpha.data_ptr(), s.amp.data_ptr(), vs[i].data_ptr(), ct_mean.data_ptr(),
                    ct_qf.data_ptr(), part.data_ptr(), ct_q.data_ptr(), b, n, m, d, stream)
                if err:
                    raise SystemExit(f"variant {name}: CUDA error {err}")
                return ct_q

            mean, qf = fwd(0)
            g = bwd(0)
            g_high = bwd(0, entry="fused_predict_bwd_high")
            torch.cuda.synchronize()
            rot = range(len(states))
            ms = cs.cuda_ms(lambda: [fwd(i) for i in rot]) / len(states)
            ms_bwd = cs.cuda_ms(lambda: [bwd(i) for i in rot]) / len(states)
            ms_high = cs.cuda_ms(lambda: [bwd(i, entry="fused_predict_bwd_high")
                                          for i in rot]) / len(states)
            err_mean, err_qf = cs.normwise(mean, mean64)[1], cs.normwise(qf, qf64)[1]
            err_g, err_high = cs.normwise(g, g64)[1], cs.normwise(g_high, g64)[1]
            results[name] = dict(ms=ms, mean_vs_f64=err_mean, qf_vs_f64=err_qf,
                                 bwd_ms=ms_bwd, bwd_vs_f64=err_g, bwd_high_ms=ms_high,
                                 bwd_high_vs_f64=err_high, ptxas=ptxas[name])
            print(f"{name:21s} forward {ms:.4f} ms (mean {err_mean:.3e}, qf {err_qf:.3e} "
                  f"normwise vs float64); fast backward {ms_bwd:.4f} ms ({err_g:.3e}); "
                  f"three-pass backward {ms_high:.4f} ms ({err_high:.3e}); "
                  f"ptxas {ptxas[name]}", flush=True)
    print(smi)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                      "shape": dict(b=b, n=n, d=d, m=m), "variants": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
