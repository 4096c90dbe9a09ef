"""Smoke run of the PyTorch/CUDA port on one GPU, at the flagship width.

Run from the repository root on a machine with an NVIDIA H100 (no
arguments):

    python3 chip_smoke.py

It imports nothing of JAX or the JAX package.  In order it

1. builds every CUDA kernel of the port from ``gpbayestools_hic_tpu_torch/csrc``;
2. builds the flagship calibration problem with the port itself (17
   parameters, 9 emulators x 4 PCs = 36 RBF GPs on 1000 design points,
   544 observables; ``gp_maxiter=0`` hyperparameters, factors on the card);
3. checks each kernel against its plain PyTorch version at the main
   path's shapes (one emulator: b = 4, n = 1000, d = 17, m = 1024) and
   times kernel, plain version, a library yardstick and the bound;
4. drives the main path with every launch count set to 0: the f32
   log-posterior on 1024 walkers, held within 0.5 log-units of the f64
   numpy oracle at 64 points, then ``Chain.run_MCMC_HMC`` with 1024
   walkers, and reads the counts back (each kernel must have run);
5. prints the kernel table as one JSON line, the card's name and power
   limit, and as its last line ``{"ok": true, "device": {...}}``.

Any failed phase raises, so the script exits non-zero without the last
line.  Without CUDA, or outside the repository, it exits non-zero at once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# flagship shape (the JAX package's bench.py)
BLOCKS = (28, 28, 12, 170, 14, 21, 28, 73, 170)
NDIM = 17
NEV = 1000
NPC = 4
NWALKERS = 1024
HMC_BURN = 32
HMC_STEPS = 64
N_ORACLE = 64

# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# kernel-vs-plain tolerances, normwise (max |kernel - plain| / max |plain|):
# both sides are float32 and differ only in summation order over the
# n = 1000 contraction (and over the GP batch); the plain float32 path
# itself sits at 2.5e-5 (values) / 4e-6 (gradient) of a float64
# evaluation at this shape, so 20x / 250x that leaves room for the other
# order while any tiling or masking fault shows up as O(1e-2) or worse.
TOL_VALUES = 5e-4
TOL_GRAD = 1e-3


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int = 9) -> float:
    """Mean device time of ``fn`` in ms (CUDA events, after one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def normwise(a, b) -> tuple[float, float]:
    """(max abs error, max abs error / max |b|) of a against b."""
    err = float((a.double() - b.double()).abs().max())
    return err, err / max(float(b.double().abs().max()), 1e-30)


def fwd_work(b, n, m, d, save_v):
    """(flops, bytes) the forward needs on these inputs: the lower
    triangle of G against k*, the mean and qf reductions, the k* build;
    each input read once, each output written once (float32)."""
    flops = b * (n * (n + 1) * m + 4 * n * m + n * m * (3 * d + 2))
    nbytes = 4 * (b * n * n + b * n * d + m * d + b * d + b * n + b
                  + 2 * b * m + (b * n * m if save_v else 0))
    return flops, nbytes


def bwd_work(b, n, m, d):
    """(flops, bytes) of the backward: G^T against ct_v (lower triangle),
    ct_v, the k* recompute and ct_z, the query cotangent."""
    flops = b * (n * (n + 1) * m + 2 * n * m + n * m * (3 * d + 4) + 3 * n * m * d)
    nbytes = 4 * (b * n * n + b * n * d + m * d + b * d + b * n + b
                  + b * n * m + 2 * b * m + b * m * d)
    return flops, nbytes


def bound_ms(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def kernel_phase(chain, device):
    """Each kernel against its plain version at one emulator's shape, and
    timings rotated over the 9 emulators' states (144 MB of G, beyond the
    50 MB L2, as the main path sees them)."""
    import torch
    from gpbayestools_hic_tpu_torch.ops import fused_predict as fp

    rng = np.random.default_rng(1)
    states = [e._fused for e in chain.emuList]
    fs = states[0]
    b, n, d = fs.xs.shape
    m = NWALKERS
    xq = torch.tensor(rng.uniform(0.0, 1.0, (m, d)), dtype=torch.float32, device=device)
    ct_mean = torch.tensor(rng.normal(size=(b, m)), dtype=torch.float32, device=device)
    ct_qf = torch.tensor(rng.normal(size=(b, m)), dtype=torch.float32, device=device)

    mean_k, qf_k, v_k = fp.fused_fwd(fs, xq, save_v=True)
    mean_p, qf_p, v_p = fp.fused_fwd_plain(fs, xq, save_v=True)
    torch.cuda.synchronize()
    e_mean, r_mean = normwise(mean_k, mean_p)
    e_qf, r_qf = normwise(qf_k, qf_p)
    e_v, r_v = normwise(v_k, v_p)
    log(f"kernel fused_predict_fwd vs plain (b={b}, n={n}, d={d}, m={m}): "
        f"mean max abs {e_mean:.3e} (normwise {r_mean:.3e}), qf max abs "
        f"{e_qf:.3e} (normwise {r_qf:.3e}), v normwise {r_v:.3e}; tolerance "
        f"{TOL_VALUES:g} normwise -- float32 on both sides, different "
        f"summation order over n = {n}")
    if not max(r_mean, r_qf, r_v) <= TOL_VALUES:
        raise SystemExit("fused_predict_fwd disagrees with its plain version")

    # kernel 2 against autograd through the plain forward
    xq_a = xq.clone().requires_grad_(True)
    mp, qp, _ = fp.fused_fwd_plain(fs, xq_a)
    (g_plain,) = torch.autograd.grad((mp * ct_mean).sum() + (qp * ct_qf).sum(), xq_a)
    g_kern = fp.fused_bwd(fs, xq, v_k, ct_mean, ct_qf).sum(0)
    torch.cuda.synchronize()
    e_g, r_g = normwise(g_kern, g_plain)
    log(f"kernel fused_predict_bwd vs autograd of the plain forward: max abs "
        f"{e_g:.3e} (normwise {r_g:.3e}); tolerance {TOL_GRAD:g} normwise -- "
        f"float32, different summation order over n = {n} and over the "
        f"{b} GPs")
    if not r_g <= TOL_GRAD:
        raise SystemExit("fused_predict_bwd disagrees with autograd of the plain version")

    # timings, rotating over the emulators' states
    vs = [fp.fused_fwd(s, xq, save_v=True)[2] for s in states]
    kst = [fp._kstar_plain(s, xq)[2] for s in states]
    cts = [2.0 * v * ct_qf[:, None, :] for v in vs]

    def rot(f):
        def run():
            for i, s in enumerate(states):
                f(i, s)
        return lambda: run()

    per = len(states)
    t_fwd = cuda_ms(rot(lambda i, s: fp.fused_fwd(s, xq, save_v=True))) / per
    t_fwd_plain = cuda_ms(rot(lambda i, s: fp.fused_fwd_plain(s, xq, save_v=True))) / per
    t_fwd_lib = cuda_ms(rot(lambda i, s: torch.bmm(s.G, kst[i]))) / per
    t_bwd = cuda_ms(rot(lambda i, s: fp.fused_bwd(s, xq, vs[i], ct_mean, ct_qf))) / per
    t_bwd_plain = cuda_ms(rot(lambda i, s: fp.fused_bwd_plain(s, xq, vs[i], ct_mean, ct_qf))) / per
    t_bwd_lib = cuda_ms(rot(lambda i, s: torch.bmm(s.G.transpose(1, 2), cts[i]))) / per
    fl_f, by_f = fwd_work(b, n, m, d, save_v=True)
    fl_b, by_b = bwd_work(b, n, m, d)
    bd_f, why_f = bound_ms(fl_f, by_f)
    bd_b, why_b = bound_ms(fl_b, by_b)
    for name, t, tp, tl, bd, why, fl in (
        ("fused_predict_fwd", t_fwd, t_fwd_plain, t_fwd_lib, bd_f, why_f, fl_f),
        ("fused_predict_bwd", t_bwd, t_bwd_plain, t_bwd_lib, bd_b, why_b, fl_b),
    ):
        log(f"timing {name}: kernel {t:.4f} ms ({fl / t / 1e9:.1f} TFLOP/s), "
            f"plain {tp:.4f} ms, library yardstick (torch.bmm of the dominant "
            f"product) {tl:.4f} ms, bound {bd:.4f} ms ({why})")
    return {
        "fused_predict_fwd": dict(max_abs_err=max(e_mean, e_qf), ms=t_fwd,
                                  plain_ms=t_fwd_plain, bound_ms=bd_f,
                                  bound_by=why_f, library_ms=t_fwd_lib),
        "fused_predict_bwd": dict(max_abs_err=e_g, ms=t_bwd,
                                  plain_ms=t_bwd_plain, bound_ms=bd_b,
                                  bound_by=why_b, library_ms=t_bwd_lib),
    }


def main_path(chain, device):
    """log_posterior on 1024 walkers + precision gate, then HMC."""
    import torch
    from gpbayestools_hic_tpu_torch.utils.validation import (
        PRECISION_GATE, f64_log_posterior,
    )

    x = chain.random_pos(NWALKERS, seed=2)
    t0 = time.perf_counter()
    lp = chain.log_posterior(x)
    torch.cuda.synchronize()
    log(f"log_posterior on {NWALKERS} walkers: {time.perf_counter() - t0:.3f} s "
        f"(first call), finite fraction {np.isfinite(lp).mean():.4f}")
    if lp.shape != (NWALKERS,) or not np.isfinite(lp).all():
        raise SystemExit("log_posterior returned non-finite values")
    lp64 = f64_log_posterior(chain, x[:N_ORACLE])
    gap = float(np.abs(lp[:N_ORACLE] - lp64).max())
    log(f"precision gate: max |lp_f32 - lp_f64| over {N_ORACLE} points = "
        f"{gap:.4f} log-units (gate {PRECISION_GATE})")
    if not gap < PRECISION_GATE:
        raise SystemExit("f32 posterior outside the precision gate")

    t0 = time.perf_counter()
    res = chain.run_MCMC_HMC(nwalkers=NWALKERS, nburnsteps=HMC_BURN, nsteps=HMC_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    finite = float(np.isfinite(res.log_prob).mean())
    log(f"HMC: {NWALKERS} walkers, warmup {HMC_BURN}/phase, {HMC_STEPS} "
        f"production steps: wall {wall:.2f} s, scheme {res.scheme} (persist "
        f"{res.persist}), step size {res.step_size:.4f}, n_leapfrog "
        f"{res.n_leapfrog}, mean acceptance {float(np.mean(res.acceptance)):.3f}, "
        f"finite log-prob fraction {finite:.4f}")
    if res.chain.shape != (NWALKERS, HMC_STEPS, NDIM) or finite != 1.0:
        raise SystemExit("HMC produced a malformed chain or non-finite log-probs")
    rep = chain.convergence_report()
    log(f"HMC convergence: max rhat {float(np.max(rep['rhat'])):.4f}, "
        f"max tau {float(np.nanmax(rep['tau'])):.2f}, ESS {rep['ess']:.0f}")
    return wall


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from gpbayestools_hic_tpu_torch.ops import _build
    from gpbayestools_hic_tpu_torch.ops import fused_predict as fp
    from gpbayestools_hic_tpu_torch.utils.synthetic import build_synthetic_chain

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"kernel build: {secs} ({time.perf_counter() - t0:.1f} s wall)")
    for name, text in _build.BUILD_LOGS.items():
        log(f"--- nvcc {name} ---\n{text.strip()}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        chain, train_s = build_synthetic_chain(
            nev=NEV, ndim=NDIM, nobs_blocks=BLOCKS, npc=NPC, gp_maxiter=0,
            seed=0, tmpdir=tmp, device=device,
        )
        log(f"flagship chain: {len(chain.emuList)} emulators x {NPC} GPs, nev "
            f"{NEV}, {chain.nobs} observables; emulator set-up {train_s:.2f} s "
            f"(total {time.perf_counter() - t0:.2f} s)")

        stats = kernel_phase(chain, device)

        fp.reset_launch_counts()
        main_path(chain, device)
        launches = dict(fp.LAUNCH_COUNTS)
    log(f"kernel launches on the main path: {launches}")
    missing = [k for k, c in launches.items() if c == 0]
    if missing:
        raise SystemExit(f"main path never launched {missing}")

    kernels = []
    for name, (source, replaces) in fp.KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name], **stats[name],
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
