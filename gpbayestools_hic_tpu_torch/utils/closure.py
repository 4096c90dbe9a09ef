"""Closure-test / posterior-predictive-check utilities (the port's own
copy of the JAX package's ``utils/closure.py``).

Extract percentile parameters from a chain (weighted or not), resample a
weighted posterior, and propagate random posterior samples through the
emulator ensemble (each emulator's ``predict`` on its own device) to
overlay on (pseudo-)data.
"""

from __future__ import annotations

import numpy as np


def validate_linear_weights(weights) -> np.ndarray:
    """Check importance weights are LINEAR (finite, nonnegative, sum > 0).

    The single weight-sanity check for every weighted-CDF/resampling
    consumer: negative/NaN weights (e.g. LOG-weights passed by mistake)
    would make a cumsum CDF non-monotone and silently produce garbage
    percentiles/resamples.  Returns the flattened float64 weights.
    """
    w = np.asarray(weights, dtype=np.float64).reshape(-1)
    if not np.all(np.isfinite(w)) or np.any(w < 0) or w.sum() <= 0:
        raise ValueError(
            "weights must be finite, nonnegative, and sum to > 0 "
            "(log-weights? exponentiate first)"
        )
    return w


def weighted_quantile(x, weights, qs) -> np.ndarray:
    """Quantiles of 1-D samples ``x`` under LINEAR importance weights.

    ``qs`` in [0, 1].  The single weighted-empirical-CDF implementation
    (validates the weights); percentile_params and the plotting axis
    limits both call this so a CDF fix propagates everywhere.
    """
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    w = validate_linear_weights(weights)
    if w.shape[0] != x.shape[0]:
        raise ValueError(f"weights length {w.shape[0]} != {x.shape[0]} samples")
    order = np.argsort(x)
    ws = w[order]
    # midpoint CDF: each sample sits at the CENTER of its probability mass,
    # (cumsum(w) - w/2) / total.  The raw right-edge cumsum places sample i
    # at the TOP of its mass, biasing every quantile low (with uniform
    # weights the median of [0, 1] would read 0.0 instead of 0.5).
    cdf = (np.cumsum(ws) - 0.5 * ws) / np.sum(ws)
    return np.interp(np.asarray(qs, dtype=np.float64), cdf, x[order])


def percentile_params(
    chain: np.ndarray, qs=(16, 50, 84), weights: np.ndarray | None = None
) -> np.ndarray:
    """Per-parameter percentiles of a chain.

    ``chain``: (..., ndim); returns (len(qs), ndim).  ``weights``: optional
    per-sample importance weights (the SMC sampler's persistent-sampling
    posterior is weighted) -- percentiles are then read off the weighted
    empirical CDF.
    """
    flat = np.asarray(chain).reshape(-1, np.asarray(chain).shape[-1])
    if weights is None:
        return np.percentile(flat, qs, axis=0)
    out = np.empty((len(qs), flat.shape[1]))
    for d in range(flat.shape[1]):
        out[:, d] = weighted_quantile(
            flat[:, d], weights, np.asarray(qs) / 100.0
        )
    return out


def systematic_resample_indices(
    rng: np.random.Generator, weights: np.ndarray, n: int
) -> np.ndarray:
    """Indices of a systematic resample proportional to linear ``weights``.

    The single implementation of the algorithm (the SMC sampler converts
    its log-weights and calls this too).  Validates the weights: silent
    corruption from negative/NaN/zero-sum weights (e.g. LOG-weights passed
    by mistake) becomes a ValueError.
    """
    w = validate_linear_weights(weights)
    w = w / w.sum()
    positions = (rng.random() + np.arange(n)) / n
    return np.searchsorted(np.cumsum(w), positions).clip(0, len(w) - 1)


def resample_weighted(
    chain: np.ndarray,
    weights: np.ndarray,
    n: int | None = None,
    seed: int = 0,
) -> np.ndarray:
    """Unweighted equal-weight resample of a weighted (SMC) posterior.

    Systematic resampling (lower variance than multinomial) of ``n``
    samples (default: the weight ESS, rounded) proportional to ``weights``.
    Use when a downstream tool expects an unweighted chain; expectations
    should still prefer ``np.average(..., weights=...)`` on the full
    weighted chain.
    """
    flat = np.asarray(chain).reshape(-1, np.asarray(chain).shape[-1])
    w = np.asarray(weights, dtype=np.float64).reshape(-1)
    if w.shape[0] != flat.shape[0]:
        raise ValueError(
            f"weights length {w.shape[0]} != {flat.shape[0]} samples"
        )
    if n is None:
        s = validate_linear_weights(w)
        s = s / s.sum()
        n = max(int(round(1.0 / np.sum(s**2))), 1)
    idx = systematic_resample_indices(np.random.default_rng(seed), w, n)
    return flat[idx]


def posterior_predictive(
    chain: np.ndarray,
    emulators,
    n_draws: int = 15,
    seed: int = 0,
    weights: np.ndarray | None = None,
) -> np.ndarray:
    """Propagate random posterior samples through the emulators.

    Returns predictions (n_draws, nobs_total) concatenated across emulators
    in order; each emulator predicts on its own device.
    ``emulators`` may be a list of emulator objects or a Chain (its loaded
    ensemble is used).  ``weights``: per-sample importance weights -- pass
    the SMC sampler's weights, or its persistent-sampling history (which
    contains near-zero-weight prior-born particles) would be sampled
    uniformly and yield a PRIOR predictive.
    """
    if hasattr(emulators, "emuList"):
        emulators = emulators.emuList
    flat = np.asarray(chain).reshape(-1, np.asarray(chain).shape[-1])
    rng = np.random.default_rng(seed)
    if weights is not None:
        w = validate_linear_weights(weights)
        if w.shape[0] != flat.shape[0]:
            raise ValueError(
                f"weights length {w.shape[0]} != {flat.shape[0]} samples"
            )
        idx = rng.choice(flat.shape[0], size=n_draws, replace=True,
                         p=w / w.sum())
    else:
        # short chains: fall back to with-replacement instead of crashing
        idx = rng.choice(flat.shape[0], size=n_draws,
                         replace=flat.shape[0] < n_draws)
    thetas = flat[idx]
    preds = [e.predict(thetas, return_cov=False) for e in emulators]
    return np.concatenate(preds, axis=1)
