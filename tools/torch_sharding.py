"""Walker sharding on the flagship chain: two ways of issuing the shards,
timed, then path j of ``chip_smoke.py`` on the machine's cards.

The port's ``parallel/mesh.py`` issues a sharded posterior call's shards
one after another from the calling thread.  This tool times that against
issuing each shard from a host thread of its own (persistent worker
threads, one per shard, in the manner of ``torch.nn.parallel.
parallel_apply``), both over the same replicas, with the unsharded call
beside them, in turns:

- the ``"auto"`` value and gradient at 1024 walkers;
- the ``"generic"`` value at 512 walkers.

It runs on 4 logical shards of cuda:0 and, where the machine has two or
more cards, on ``make_mesh`` over up to 4 of them.  Then it drives
``chip_smoke.sharded_path`` (path j, every check of it) on the meshes
``chip_smoke.shard_meshes`` picks: real cards where there are two or
more, so that the replicas on other cards (emulator copies) are held
against the unsharded runs.  The flagship chain is built and fitted as
``chip_smoke.py`` builds it (36 GPs, ``gp_maxiter=30``, seed 0).  Run from
the repository root on a machine with an NVIDIA GPU (on four cards for
the real mesh):

    python3 tools/torch_sharding.py [--reps 8]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def threaded(mesh, fns):
    """``x -> outputs`` like ``mesh.shard_map``, shard k >= 1 issued from
    worker thread k (kept for the function's life), shard 0 from the
    caller; grad mode carried into the workers."""
    import torch

    from gpbayestools_hic_tpu_torch.parallel.mesh import shard_batch

    pools = [ThreadPoolExecutor(max_workers=1) for _ in range(mesh.size - 1)]

    def run(k, fn, chunk, grad):
        guard = torch.cuda.device(chunk.device)
        with torch.set_grad_enabled(grad), guard:
            return fn(chunk)

    def call(x):
        chunks = shard_batch(mesh, x)
        grad = torch.is_grad_enabled()
        futs = [p.submit(run, k + 1, fns[k + 1], chunks[k + 1], grad)
                for k, p in enumerate(pools)]
        outs = [run(0, fns[0], chunks[0], grad)] + [f.result() for f in futs]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat([o[i].to(x.device) for o in outs])
                         for i in range(len(outs[0])))
        return torch.cat([o.to(x.device) for o in outs])

    return call


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_sharding: no CUDA device available", file=sys.stderr)
        return 2
    os.environ.setdefault("LOGLEVEL", "warning")
    import chip_smoke as cs
    from gpbayestools_hic_tpu_torch.ops import _build
    from gpbayestools_hic_tpu_torch.parallel import WalkerMesh, make_mesh, sharded_log_prob
    from gpbayestools_hic_tpu_torch.parallel.mesh import replicas
    from gpbayestools_hic_tpu_torch.utils.tensors import value_and_grad
    from gpbayestools_hic_tpu_torch.utils.synthetic import build_synthetic_chain

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    _build.build_all()
    n_cards = torch.cuda.device_count()
    meshes = [("4 logical shards of cuda:0", WalkerMesh(["cuda:0"] * 4))]
    if n_cards >= 2:
        meshes.append((f"{min(4, n_cards)} cards", make_mesh(min(4, n_cards))))
    with tempfile.TemporaryDirectory() as tmp:
        chain, _ = build_synthetic_chain(nev=cs.NEV, ndim=cs.NDIM, nobs_blocks=cs.BLOCKS,
                                         npc=cs.NPC, gp_maxiter=cs.FIT_MAXITER, seed=0,
                                         tmpdir=tmp, device=torch.device("cuda", 0))
        x = torch.as_tensor(chain.random_pos(1024, seed=11), dtype=torch.float32,
                            device="cuda:0")
        for mode, m in (("auto", 1024), ("generic", 512)):
            chain.likelihood_mode = mode
            fn, state = chain.posterior_with_state()
            xm = x[:m]
            calls = {"unsharded": value_and_grad(lambda q: fn(state, q))
                     if mode == "auto" else (lambda q: fn(state, q))}
            for name, mesh in meshes:
                serial = sharded_log_prob(fn, mesh, state)
                bound = [lambda q, f=f, s=s: f(s, q) for f, s in replicas(fn, mesh, state)]
                if mode == "auto":
                    calls[f"{name}, serial"] = serial.value_and_grad
                    calls[f"{name}, a thread per shard"] = threaded(
                        mesh, [value_and_grad(b) for b in bound])
                else:
                    calls[f"{name}, serial"] = serial
                    calls[f"{name}, a thread per shard"] = threaded(mesh, bound)
            walls = {k: [] for k in calls}
            with torch.set_grad_enabled(mode == "auto"):
                for _ in range(args.reps + 1):          # the first round warms up
                    for k, f in calls.items():
                        for d in range(n_cards):
                            torch.cuda.synchronize(d)
                        t0 = time.perf_counter()
                        f(xm)
                        for d in range(n_cards):
                            torch.cuda.synchronize(d)
                        walls[k].append(1e3 * (time.perf_counter() - t0))
            for k, w in walls.items():
                w = w[1:]
                print(f"{mode} {'value+gradient' if mode == 'auto' else 'value'}, {m} walkers, "
                      f"{k}: median {np.median(w):.2f} ms (min {min(w):.2f}, max {max(w):.2f}, "
                      f"{len(w)} calls in turns)", flush=True)
        chain.likelihood_mode = "auto"
        mesh, pt_mesh, kind = cs.shard_meshes()
        print(f"path j: mesh {mesh} ({kind}), PTLMC mesh {pt_mesh}", flush=True)
        t0 = time.perf_counter()
        launches = cs.sharded_path(chain, tmp, mesh, pt_mesh)
        print(f"path j: {time.perf_counter() - t0:.1f} s, kernel launches {launches}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
