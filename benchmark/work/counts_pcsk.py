"""Operations and bytes of the posterior over PCSK Matern-1.5 heads.

``counts.py``'s rules (the algorithm counted once, whatever the
implementation; the predict products valued at the 16-bit tensor-core
peak, every other operation at TF32's, bytes at the HBM rate), with two
changes: each block's GP batch is its own PC count (the configuration's
``npc_blocks``; a configuration without it gives every block ``npc``), so
the predict and the Woodbury epilogue are counted at b = k_b and rank k_b;
and the k* build is Matern's, ``amp (1 + s) e^-s`` with ``s = sqrt(3 r2)``:
per element 3 d for the squared distance, then the scale by 3, the square
root, the negation and exp, 1 + s and two products (6), and in a call with
a gradient the weight ``3 amp e^-s`` of the query derivative (2 more).

:func:`kstar_work` counts the k* pre-pass alone as the one pass that
builds k* must: its operations, the inputs read, and k* (and, with a
gradient, the weight) written once (n m floats a GP each), which the
predict as a whole does not count (an intermediate there).
"""

from __future__ import annotations

from benchmark.work.counts import F32, Work, bwd_work, fwd_work, woodbury_work

#: operations per k* element beyond the squared distance's 3 d: Matern's
#: 6 against RBF's 2 (counts.fwd_work), and the weight's 2 with a gradient
MATERN_KSTAR = 6
MATERN_WEIGHT = 2


def block_npcs(cfg: dict) -> list[int]:
    """Each block's PC count: ``npc_blocks``, else ``npc`` for every block."""
    ks = cfg.get("npc_blocks")
    return [int(k) for k in ks] if ks else [int(cfg["npc"])] * len(cfg["blocks"])


def kstar_ops(b: int, n: int, m: int, grad: bool) -> float:
    """The Matern k* build's operations beyond RBF's (counts.fwd_work's k*
    term counts RBF's 3 d + 2 a element)."""
    return b * n * m * (MATERN_KSTAR - 2 + (MATERN_WEIGHT if grad else 0))


def predict_work(b: int, n: int, m: int, d: int, grad: bool) -> Work:
    """One Matern GP batch's predict at m queries: forward and, with
    ``grad``, backward."""
    w = fwd_work(b, n, m, d) + Work(0.0, kstar_ops(b, n, m, grad), 0.0)
    return w + bwd_work(b, n, m, d) if grad else w


def kstar_work(b: int, n: int, m: int, d: int, grad: bool) -> Work:
    """The k* pre-pass of one Matern GP batch: its operations, the scaled
    training inputs, the queries, the inverse length scales and the
    amplitudes read, k* (and, with ``grad``, the weight) written."""
    planes = 2 if grad else 1
    ops = b * n * m * (3 * d + MATERN_KSTAR + (MATERN_WEIGHT if grad else 0))
    nbytes = F32 * (b * n * d + m * d + b * d + b + planes * b * n * m)
    return Work(0.0, ops, nbytes)


def posterior_work(cfg: dict, m: int, grad: bool) -> dict[str, Work]:
    """One auto (Woodbury) posterior call at m walkers, by layer:
    ``predict``, ``kstar`` (the pre-pass alone, inside ``predict``'s
    count) and ``other`` (the Woodbury epilogue at each block's rank)."""
    n, d = int(cfg["n_design"]), int(cfg["ndim"])
    predict, kstar, other = Work(), Work(), Work()
    for k in block_npcs(cfg):
        predict = predict + predict_work(k, n, m, d, grad)
        kstar = kstar + kstar_work(k, n, m, d, grad)
        other = other + woodbury_work(m, k)
    return {"predict": predict, "kstar": kstar, "other": other}


def window_work(summary: dict, layers=("predict", "other")) -> Work:
    """The work of every posterior call in the traced window, summed over
    ``layers``."""
    total = Work()
    for (m, grad), count in summary["calls"].items():
        parts = posterior_work(summary["config"], m, grad)
        for layer in layers:
            total = total + parts[layer].scaled(count)
    return total
