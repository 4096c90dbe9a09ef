"""The numbers that decide ``correct``, each compared with its limit.

- ``lp_gap``: the largest absolute gap, in log-units, between the log
  posterior the timed path produced and the float64 reference's at the
  same positions; a position that one side finds finite and the other not
  makes it infinite.
- ``grad_gap``: the largest gap between the gradient the timed path's
  leapfrog used and the reference's, as ``|g - g_ref|`` over the larger of
  ``|g_ref|`` and the median ``|g_ref|`` of the positions checked (a
  gradient near zero does not make it blow up).
- ``stuck_share``: the share of walkers that did not move over the
  window: no coordinate moved by more than ``1e-5`` of the box's width (a
  sampler that restarts from stored positions rounds them, so equality
  is no test).

A limit is the largest value that still passes.
"""

from __future__ import annotations

import numpy as np


def lp_gap(port, ref) -> float:
    port = np.asarray(port, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    fp, fr = np.isfinite(port), np.isfinite(ref)
    if np.any(fp != fr):
        return float("inf")
    if not fr.any():
        return 0.0
    return float(np.max(np.abs(port[fr] - ref[fr])))


def grad_gap(port, ref) -> float:
    port = np.asarray(port, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    if not np.all(np.isfinite(port)):
        return float("inf")
    norm = np.linalg.norm(ref, axis=1)
    scale = np.maximum(norm, np.median(norm))
    scale = np.where(scale > 0, scale, 1.0)
    return float(np.max(np.linalg.norm(port - ref, axis=1) / scale))


def stuck_share(x_start, x_end, width=1.0) -> float:
    moved = np.abs(np.asarray(x_end, np.float64) - np.asarray(x_start, np.float64))
    return float(np.mean(np.all(moved <= 1e-5 * np.asarray(width), axis=1)))


def judge(values: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number without a limit, or NaN, fails."""
    out, ok = {}, True
    for name, value in values.items():
        limit = limits.get(name)
        out[name] = {"value": value, "limit": limit}
        if limit is None or not (value <= limit):
            ok = False
    return ok, out
