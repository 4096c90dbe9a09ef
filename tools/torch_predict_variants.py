"""Design checks of the fused predict kernels on one GPU: variants of
``gpbayestools_hic_tpu_torch/csrc/fused_predict.cu`` built side by side and
timed at the flagship's shapes.

Run from the repository root on a CUDA machine:

    python3 tools/torch_predict_variants.py [--parent DIR] [--walkers 1024,256]
                                            [--variants NAME,...]

``--variants NAME,...`` builds and times only those variants (``kept``
and the parent always).  ``--parent DIR`` adds the ``fused_predict.cu`` of another checkout (e.g. the
parent commit unpacked with ``git archive``) as the variant ``parent``, so
that the two are timed in one process on one card.  The parent may be of
the sm_80 design (``mma.sync``, v saved as (b, n, m), no kernel factor) or
of this one; the script calls each library by the interface it exports.

Each variant is the committed source with a few text edits of its design
knobs (the script fails if an edit no longer applies to the source):

- ``kept``: the source as committed;
- ``fwd_stages_3`` / ``bwd_stages_3``: the forward's / the fast backward's
  ring one stage shallower;
- ``promote_2`` / ``promote_4``: the forward's products promoted to the
  FP32 sum every two / four ring stages (64 / 128 contraction steps; a
  stage's products then stay in flight while the next stage is split),
  instead of every stage (each stage waits for its products);
- ``promote_never``: one sum over the whole contraction, promoted once
  (what the accuracy without promotion is);
- ``split_in_memory``: k* split into its TF32 halves by ``kstar_kernel``,
  two planes in device memory (instead of written raw, one plane, and
  split in shared memory by the warpgroup that reads the stage), with the
  3-stage ring its larger stages leave room for;
- ``tn_64``: tiles of 64 rows (``wgmma`` m64n64k8) instead of 128;
- ``kstar_128x64`` / ``kstar_64x128`` / ``kstar_32x64``: the k* pre-pass's
  tile (training rows x walkers per block; 64 x 64 kept);
- ``one_consumer`` / ``two_consumers``: every block with one (64 walkers) /
  two (128) consumer warpgroups, whatever the grid;
- ``high_stages_3``: the three-pass backward's ring three stages deep, not
  two;
- diagnostics, wrong results: ``fwd_no_products`` / ``bwd_no_products`` /
  ``high_no_products`` (the ring's copies without the products),
  ``bwd_no_round`` (v^T not rounded: the tensor cores drop its low bits),
  ``high_no_split`` (v^T not split: its lo half left as it was),
  ``bwd_no_contraction`` (no query contraction, the FP32 part of the
  epilogue of both backwards).

For each it prints the ptxas registers and spills of the kernels, the
device time of the forward, the fast backward and the three-pass backward
(a CUDA graph of two rotations over the 9 emulators' factors of the
flagship chain, replayed between CUDA events, so the host's enqueue stays
out of the time) at each walker count and at b = 36 (the nine emulators'
GPs in one call), in two rounds (the variants in order, then in reverse:
the parent and the committed source are timed in turns), their normwise
errors against the plain forward and
backward in float64 (the backwards given that library's own v), then the
card's name and power limit and one JSON line.  Imports nothing of JAX.
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


def _knob(name: str, old: str, new: str):
    return (f"constexpr {name} = {old};", f"constexpr {name} = {new};")


_KSTAR_2_BLOCKS = ("__launch_bounds__(256, 4)\nkstar_kernel(",
                   "__launch_bounds__(256, 2)\nkstar_kernel(")
_CONSUMERS = "bool one_consumer(long long blocks128) { return 2 * blocks128 <= sm_count(); }"

VARIANTS = {
    "kept": [],
    "fwd_stages_3": [_knob("int FWD_STAGES", "4", "3")],
    "bwd_stages_3": [_knob("int BWD_STAGES", "4", "3")],
    "promote_2": [_knob("int PROMOTE", "1", "2")],
    "promote_4": [_knob("int PROMOTE", "1", "4")],
    "promote_never": [_knob("int PROMOTE", "1", "1 << 20")],
    "split_in_memory": [_knob("bool SPLIT_IN_SMEM", "true", "false"),
                        _knob("int FWD_STAGES", "4", "3")],
    "tn_64": [_knob("int TN", "128", "64")],
    "kstar_128x64": [_knob("int KS_L", "64, KS_J = 64", "128, KS_J = 64"), _KSTAR_2_BLOCKS],
    "kstar_64x128": [_knob("int KS_L", "64, KS_J = 64", "64, KS_J = 128"), _KSTAR_2_BLOCKS],
    "kstar_32x64": [_knob("int KS_L", "64, KS_J = 64", "32, KS_J = 64")],
    "one_consumer": [(_CONSUMERS, "bool one_consumer(long long) { return true; }")],
    "two_consumers": [(_CONSUMERS, "bool one_consumer(long long) { return false; }")],
    # diagnostics (wrong results): what is left of the time without a part
    "fwd_no_products": [
        ("        wgmma_tile(part, dal + 2 * kk, dbh + 2 * kk, (fresh && kk == 0) ? 0 : 1);\n"
         "        wgmma_tile(part, dah + 2 * kk, dbl + 2 * kk, 1);\n"
         "        wgmma_tile(part, dah + 2 * kk, dbh + 2 * kk, 1);\n", "")],
    "bwd_no_products": [
        ("for (int kk = 0; kk < BK / 8; ++kk) wgmma_tile(acc, da + 2 * kk, db + 2 * kk, 1);", "")],
    "bwd_no_round": [
        ("      for (int q = 0; q < 4; ++q) round4(reinterpret_cast<float4*>(a) + wtid + 128 * q);\n",
         "")],
    "bwd_no_contraction": [("    for (int d0 = 0; d0 < d; d0 += 4) {",
                            "    for (int d0 = 0; d0 < 0; d0 += 4) {")],
    "high_stages_3": [_knob("int HIGH_STAGES", "2", "3")],
    "high_no_products": [
        ("          wgmma_tile(part, dal + 2 * kk, db + 2 * kk, kk == 0 ? 0 : 1);\n"
         "          wgmma_tile(part, dah + 2 * kk, dbl + 2 * kk, 1);\n"
         "          wgmma_tile(part, dah + 2 * kk, db + 2 * kk, 1);\n", "")],
    "high_no_split": [
        ("        for (int q = 0; q < 4; ++q)\n"
         "          split4(reinterpret_cast<float4*>(a) + wtid + 128 * q,\n"
         "                 reinterpret_cast<float4*>(alo) + wtid + 128 * q);\n", "")],
}


def variant_source(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"edit no longer applies to the source: {old[:70]!r}")
        text = text.replace(old, new)
    return text


def build(tmp: str, parent: str | None = None, only=None):
    """Compile every variant (or the ``kept`` one and those named in
    ``only``) at once (one nvcc each); name -> CDLL, ptxas."""
    from gpbayestools_hic_tpu_torch.ops import _build

    rel = os.path.join("gpbayestools_hic_tpu_torch", _build.SOURCES["fused_predict"])
    src = open(os.path.join(ROOT, rel)).read()
    if only is not None and set(only) - set(VARIANTS):
        raise SystemExit(f"no such variant: {sorted(set(only) - set(VARIANTS))}")
    sources = {name: variant_source(src, edits) for name, edits in VARIANTS.items()
               if only is None or name == "kept" or name in only}
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
        libs[name] = Library(ctypes.CDLL(so))
    return libs, ptxas


def ptxas_report(log: str) -> dict:
    """{kernel: "R registers, S bytes spilled"} for the product kernels, and
    ptxas's notes where it serialized wgmma."""
    out, lines = {}, log.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"\d+(fwd_wgmma_kernel|bwd_wgmma_kernel|bwd_high_kernel|fwd_tc_kernel|"
                      r"bwd_tc_kernel)I(L[ib]\d+E)+", line)
        if "Compiling entry" in line and m:
            spill = re.search(r"(\d+) bytes spill stores", lines[i + 2])
            regs = re.search(r"Used (\d+) registers", lines[i + 3])
            out[m.group(0)[len(re.match(r"\d+", m.group(0)).group(0)):]] = (
                f"{regs.group(1)} registers, {spill.group(1)} bytes spilled")
    # ptxas says where it serialized wgmma (waits of its own around the products)
    serial = [line.strip() for line in lines if "serializ" in line]
    if serial:
        out["wgmma serialized"] = serial
    return out


class Library:
    """One build of the source, called by the interface it exports: this
    design's (kernel factor and its descriptor, v^T; a three-pass backward
    of the earlier Hopper design reads G itself and recomputes k*, and its
    kernel factor has three planes) or the sm_80 one's."""

    def __init__(self, lib):
        P, I = ctypes.c_void_p, ctypes.c_int
        self.lib = lib
        self.hopper = hasattr(lib, "fused_predict_encode_factor")
        lib.fused_predict_scratch.restype = ctypes.c_longlong
        lib.fused_predict_scratch.argtypes = [I] * 5
        lib.fused_predict_fwd.restype = I
        lib.fused_predict_fwd.argtypes = [P] * (9 if self.hopper else 10) + [I] * 4 + [P]
        for entry in ("fused_predict_bwd", "fused_predict_bwd_high"):
            getattr(lib, entry).restype = I
            getattr(lib, entry).argtypes = [P] * 11 + [I] * 4 + [P]
        if self.hopper:
            lib.fused_predict_encode_factor.restype = I
            lib.fused_predict_encode_factor.argtypes = [P, I, I, P]
            lib.fused_predict_kst_planes.restype = I
            lib.fused_predict_kst_planes.argtypes = []
            self.planes = lib.fused_predict_kst_planes()
            lib.fused_predict_fwd.argtypes = [P] * 10 + [I] * 4 + [P]
        # planes of the kernel factor this build reads (three before the
        # three-pass backward read G^T's lo half from it)
        self.factor_planes = 0
        if self.hopper:
            self.factor_planes = 3
            if hasattr(lib, "fused_predict_factor_planes"):
                lib.fused_predict_factor_planes.restype = I
                lib.fused_predict_factor_planes.argtypes = []
                self.factor_planes = lib.fused_predict_factor_planes()
        self.descs = {}

    def desc(self, s):
        key = s.kf.data_ptr()
        if key not in self.descs:
            b, n = s.alpha.shape
            kf = s.kf[:, :self.factor_planes].contiguous()  # its planes' layout is the same
            buf = ctypes.create_string_buffer(128)
            if self.lib.fused_predict_encode_factor(kf.data_ptr(), b, n, buf):
                raise SystemExit("factor descriptor")
            self.descs[key] = (buf, kf)
        return self.descs[key][0]

    def fwd(self, s, xq):
        import torch

        from gpbayestools_hic_tpu_torch.ops import fused_predict as fp

        b, n, d = s.xs.shape
        m = xq.shape[0]
        f32 = dict(dtype=torch.float32, device=xq.device)
        mean, qf = torch.empty((b, m), **f32), torch.empty((b, m), **f32)
        scratch = torch.empty(self.lib.fused_predict_scratch(0, b, n, m, d), **f32)
        stream = torch.cuda.current_stream().cuda_stream
        if self.hopper:
            # v^T and the call's k*^T side by side, as the wrapper saves them
            buf = torch.empty((1 + self.planes, b, m, fp.factor_ld(n)), **f32)
            err = self.lib.fused_predict_fwd(
                s.xs.data_ptr(), xq.data_ptr(), s.inv_ls.data_ptr(), self.desc(s),
                s.amp.data_ptr(), mean.data_ptr(), qf.data_ptr(), buf[0].data_ptr(),
                buf[1].data_ptr(), scratch.data_ptr(), b, n, m, d, stream)
            v = buf[0, :, :, :n].transpose(1, 2)
        else:
            v = torch.empty((b, n, m), **f32)
            err = self.lib.fused_predict_fwd(
                s.xs.data_ptr(), xq.data_ptr(), s.inv_ls.data_ptr(), s.G.data_ptr(),
                s.alpha.data_ptr(), s.amp.data_ptr(), mean.data_ptr(), qf.data_ptr(),
                v.data_ptr(), scratch.data_ptr(), b, n, m, d, stream)
        if err:
            raise SystemExit(f"forward: CUDA error {err}")
        return mean, qf, v

    def bwd(self, s, xq, v, ct_mean, ct_qf, entry="fused_predict_bwd"):
        import torch

        b, n, d = s.xs.shape
        m = xq.shape[0]
        f32 = dict(dtype=torch.float32, device=xq.device)
        part = torch.empty(self.lib.fused_predict_scratch(
            1 if entry == "fused_predict_bwd" else 2, b, n, m, d), **f32)
        ct_q = torch.empty((b, m, d), **f32)
        if self.hopper and (entry == "fused_predict_bwd" or self.factor_planes == 4):
            from gpbayestools_hic_tpu_torch.ops import fused_predict as fp

            operands = (self.desc(s), s.alpha.data_ptr(), v.data_ptr(),
                        v.data_ptr() + 4 * b * m * fp.factor_ld(n))
        else:
            operands = (s.G.data_ptr(), s.alpha.data_ptr(), s.amp.data_ptr(), v.data_ptr())
        err = getattr(self.lib, entry)(
            s.xs.data_ptr(), xq.data_ptr(), s.inv_ls.data_ptr(), *operands, ct_mean.data_ptr(),
            ct_qf.data_ptr(), part.data_ptr(), ct_q.data_ptr(), b, n, m, d,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"{entry}: CUDA error {err}")
        return ct_q


def profile(lib, group, xq, ct_mean, ct_qf) -> dict:
    """Device time per call of each kernel of the forward and both
    backwards (torch.profiler over two rotations of each)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    vs = [lib.fwd(s, xq)[2] for s in group]
    torch.cuda.synchronize()
    out = {}
    for what, fn in (("forward", lambda: [lib.fwd(s, xq) for s in group]),
                     ("fast backward", lambda: [lib.bwd(s, xq, v, ct_mean, ct_qf)
                                                for s, v in zip(group, vs)]),
                     ("three-pass backward", lambda: [
                         lib.bwd(s, xq, v, ct_mean, ct_qf, "fused_predict_bwd_high")
                         for s, v in zip(group, vs)])):
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                fn()
            torch.cuda.synchronize()
        calls = 2 * len(group)
        for ev in prof.key_averages():
            dev_us = getattr(ev, "device_time_total", 0.0) or getattr(ev, "cuda_time_total", 0.0)
            kernels = ("kstar_kernel", "fwd_wgmma_kernel", "bwd_wgmma_kernel", "bwd_high_kernel",
                       "rowsum_kernel")
            if any(k in ev.key for k in kernels) and dev_us > 0 and ev.count >= calls:
                name = f"{what}: {ev.key[:60]}"
                out[name] = dev_us / 1e3 / calls
                print(f"profile {name}: {out[name]:.4f} ms per call ({ev.count} launches)",
                      flush=True)
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
    parser.add_argument("--walkers", default="1024,256", help="walker counts to time")
    parser.add_argument("--variants", help="comma-separated variants to time (default: all)")
    args = parser.parse_args()
    walkers = [int(w) for w in args.walkers.split(",")]
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    with tempfile.TemporaryDirectory(prefix="predict_variants_") as tmp:
        libs, ptxas = build(tmp, args.parent,
                            args.variants.split(",") if args.variants else None)
        chain, _ = build_synthetic_chain(nev=cs.NEV, ndim=cs.NDIM, nobs_blocks=cs.BLOCKS,
                                         npc=cs.NPC, gp_maxiter=0, seed=0, tmpdir=tmp, device=dev)
        states = [e._fused for e in chain.emuList]
        # the nine emulators' GPs as one batch (b = 36)
        merged = [fp.FusedState(*(torch.cat([getattr(s, f) for s in states]).contiguous()
                                  for f in fp.FusedState._fields))]
        b, n, d = states[0].xs.shape
        fs64 = fp.FusedState(*(t.double() for t in states[0]))
        cases = [(f"b{b} m{m}", states, m) for m in walkers] + [
            (f"b{merged[0].xs.shape[0]} m{walkers[0]}", merged, walkers[0])]
        results = {name: {"ptxas": ptxas[name]} for name in libs}
        for label, group, m in cases:
            rng = np.random.default_rng(1)
            bb = group[0].xs.shape[0]
            xq = torch.tensor(rng.uniform(0.0, 1.0, (m, d)), dtype=torch.float32, device=dev)
            ct_mean = torch.tensor(rng.normal(size=(bb, m)), dtype=torch.float32, device=dev)
            ct_qf = torch.tensor(rng.normal(size=(bb, m)), dtype=torch.float32, device=dev)
            check = group is states
            if check:
                mean64, qf64, v64 = fp.fused_fwd_plain(fs64, xq.double(), save_v=True)
            # warm the card up before the first timed call
            lib0 = libs["kept"]
            for _ in range(40):
                for s in group:
                    lib0.fwd(s, xq)
            torch.cuda.synchronize()
            order = list(libs)
            for rnd, names in enumerate((order, order[::-1])):  # in turns: a b .. b a
                for name in names:
                    lib = libs[name]
                    vs = [lib.fwd(s, xq)[2] for s in group]
                    rot = range(len(group))
                    ms = cs.graph_ms(lambda: [lib.fwd(group[i], xq) for i in rot],
                                     reps=2) / len(group)
                    ms_bwd = cs.graph_ms(lambda: [lib.bwd(group[i], xq, vs[i], ct_mean, ct_qf)
                                                  for i in rot], reps=2) / len(group)
                    ms_high = cs.graph_ms(lambda: [lib.bwd(group[i], xq, vs[i], ct_mean, ct_qf,
                                                           "fused_predict_bwd_high")
                                                   for i in rot], reps=2) / len(group)
                    row = results[name].setdefault(label, dict(fwd_ms=[], bwd_ms=[],
                                                               bwd_high_ms=[]))
                    row["fwd_ms"].append(ms)
                    row["bwd_ms"].append(ms_bwd)
                    row["bwd_high_ms"].append(ms_high)
                    errs = ""
                    if check and rnd == 0:
                        mean, qf, v = lib.fwd(states[0], xq)
                        g = lib.bwd(states[0], xq, v, ct_mean, ct_qf)
                        g_high = lib.bwd(states[0], xq, v, ct_mean, ct_qf,
                                         "fused_predict_bwd_high")
                        g64 = fp.fused_bwd_plain(fs64, xq.double(), v.double(),
                                                 ct_mean.double(), ct_qf.double())
                        row.update(mean_vs_f64=cs.normwise(mean, mean64)[1],
                                   qf_vs_f64=cs.normwise(qf, qf64)[1],
                                   v_vs_f64=cs.normwise(v, v64)[1],
                                   bwd_vs_f64=cs.normwise(g, g64)[1],
                                   bwd_high_vs_f64=cs.normwise(g_high, g64)[1])
                        errs = (f"; vs float64: mean {row['mean_vs_f64']:.3e}, qf "
                                f"{row['qf_vs_f64']:.3e}, fast backward {row['bwd_vs_f64']:.3e}, "
                                f"three-pass {row['bwd_high_vs_f64']:.3e}")
                    print(f"{label:11s} {name:14s} forward {ms:.4f} ms, fast backward "
                          f"{ms_bwd:.4f} ms, three-pass backward {ms_high:.4f} ms{errs}",
                          flush=True)
            if label.startswith(f"b{b} "):
                results["kept"][label]["kernels_ms"] = profile(libs["kept"], group, xq, ct_mean,
                                                                ct_qf)
        for name in libs:
            print(f"ptxas {name}: {ptxas[name]}")
    print(smi)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                      "shape": dict(b=b, n=n, d=d, walkers=walkers), "variants": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
