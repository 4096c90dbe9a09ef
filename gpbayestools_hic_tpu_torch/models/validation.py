"""Emulator validation harness (PyTorch port of the JAX package's
``models/validation.py``).

Train several emulator variants side by side, hold out test points, and
score the RMS relative error E and uncertainty honesty H per observable,
optionally scanning over training-set sizes; built on the emulators'
holdout validator ``testEmulatorErrors``, which retrains and predicts on
each emulator's device.
"""

from __future__ import annotations

import logging
from typing import Callable, Mapping, Sequence

import numpy as np

from ..utils.metrics import honesty, mean_log_honesty, rms_relative_error

logger = logging.getLogger(__name__)


def validate_emulator(emulator, n_test_points: int, **kwargs) -> dict:
    """Holdout-validate one emulator; returns metric dict.

    Keys: ``E`` (nobs,), ``H`` (nobs,), ``mean_E``, ``mean_log_H``, and the
    raw ``(pred, pred_err, truth, truth_err)`` arrays.
    """
    pred, pred_err, truth, truth_err = emulator.testEmulatorErrors(
        n_test_points, **kwargs
    )
    e = rms_relative_error(pred, truth)
    h = honesty(pred, pred_err, truth)
    return {
        "E": e,
        "H": h,
        "mean_E": float(np.mean(e)),
        "mean_log_H": mean_log_honesty(pred, pred_err, truth),
        "pred": pred,
        "pred_err": pred_err,
        "truth": truth,
        "truth_err": truth_err,
    }


def validate_multiple_emulators(
    factories: Mapping[str, Callable[[], object]],
    n_test_points: int,
) -> dict:
    """Train + validate several emulator variants side by side.

    ``factories`` maps a name to a zero-argument callable building a fresh
    (untrained) emulator.
    Returns {name: metric dict}.
    """
    results = {}
    for name, factory in factories.items():
        logger.info("validating emulator variant %r ...", name)
        emu = factory()
        results[name] = validate_emulator(emu, n_test_points)
        logger.info(
            "%s: mean E = %.4f, <log H> = %.3f",
            name, results[name]["mean_E"], results[name]["mean_log_H"],
        )
    return results


def holdout_scan(
    factory: Callable[[], object],
    test_sizes: Sequence[int],
) -> dict:
    """Scan validation metrics over holdout sizes.

    For each ``k`` in ``test_sizes`` the emulator trains on ``nev - k``
    points and predicts the held-out ``k``.  Returns arrays keyed by
    ``test_sizes``, ``mean_E``, ``mean_log_H``.
    """
    mean_e, mean_log_h = [], []
    for k in test_sizes:
        emu = factory()
        res = validate_emulator(emu, k)
        mean_e.append(res["mean_E"])
        mean_log_h.append(res["mean_log_H"])
        logger.info(
            "holdout %d: mean E = %.4f, <log H> = %.3f",
            k, res["mean_E"], res["mean_log_H"],
        )
    return {
        "test_sizes": np.asarray(list(test_sizes)),
        "mean_E": np.asarray(mean_e),
        "mean_log_H": np.asarray(mean_log_h),
    }


def save_metrics_csv(path, results: Mapping[str, dict]) -> None:
    """Write per-observable E/H metrics to CSV, one block per variant."""
    import csv

    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["variant", "observable", "E", "H"])
        for name, res in results.items():
            for j, (e, h) in enumerate(zip(res["E"], res["H"])):
                writer.writerow([name, j, float(e), float(h)])
    logger.info("wrote validation metrics to %s", path)
