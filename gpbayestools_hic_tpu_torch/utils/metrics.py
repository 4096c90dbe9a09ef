"""Validation metrics and MCMC convergence diagnostics (the port's own
copy of the JAX package's ``utils/metrics.py``; pure numpy/scipy).

Validation and closure:

- :func:`rms_relative_error` -- "E": RMS relative prediction error per
  observable;
- :func:`honesty` -- "H": RMS of (prediction error / claimed sigma), the
  calibration of the emulator's claimed uncertainty (H ~ 1 is honest);
- :func:`delta_d` -- closure-test metric
  ``Delta_d = E[sum((theta - theta_truth)^2 / width^2)] / ndim``;
- :func:`coverage` -- fraction of truths inside the central credible
  interval of each claimed Gaussian.

Convergence:

- :func:`integrated_autocorr_time` / :func:`effective_sample_size` --
  emcee-style windowed-FFT tau and the derived ESS;
- :func:`split_rhat` -- rank-normalized + folded split-R-hat
  (Vehtari et al. 2021);
- :func:`convergence_diagnostics` -- one-call report;
- :func:`summary` -- posterior table (mean/sd/CI/R-hat/tau).
"""

from __future__ import annotations

import numpy as np


def rms_relative_error(pred: np.ndarray, truth: np.ndarray, axis=0) -> np.ndarray:
    """E: RMS of (pred - truth)/truth over samples (per observable).

    NaN truth entries are excluded (validation arrays mark imputed, never
    observed, entries as NaN; see ``Emulator._validation_arrays``)."""
    rel = (np.asarray(pred) - np.asarray(truth)) / np.asarray(truth)
    return np.sqrt(np.nanmean(rel**2, axis=axis))


def honesty(pred: np.ndarray, pred_err: np.ndarray, truth: np.ndarray, axis=0) -> np.ndarray:
    """H: RMS of (pred - truth)/sigma_pred.  H >> 1: overconfident;
    H << 1: underconfident; H ~ 1: honest uncertainties.  NaN truth
    entries (imputed, not observed) are excluded."""
    z = (np.asarray(pred) - np.asarray(truth)) / np.asarray(pred_err)
    return np.sqrt(np.nanmean(z**2, axis=axis))


def mean_log_honesty(pred, pred_err, truth) -> float:
    """<log H> averaged over observables."""
    h = honesty(pred, pred_err, truth)
    return float(np.nanmean(np.log(h)))


def delta_d(chain: np.ndarray, truth: np.ndarray, prior_min: np.ndarray,
            prior_max: np.ndarray, weights: np.ndarray | None = None) -> float:
    """Closure metric Delta_d.

    ``chain``: posterior samples (..., ndim) (any leading shape).
    ``weights``: optional per-sample importance weights (the SMC sampler's
    persistent-sampling posterior is weighted).
    Returns ``E_samples[ sum_d ((theta_d - truth_d)/width_d)^2 ] / ndim``.
    """
    samples = np.asarray(chain).reshape(-1, len(truth))
    width = np.asarray(prior_max) - np.asarray(prior_min)
    z2 = ((samples - np.asarray(truth)) / width) ** 2
    if weights is not None:
        weights = np.asarray(weights).reshape(-1)
    return float(np.average(np.sum(z2, axis=1), weights=weights) / len(truth))


def coverage(pred, pred_err, truth, n_sigma: float = 1.0) -> float:
    """Fraction of truths within +- n_sigma of the claimed Gaussian.

    NaN truth entries (imputed, never observed) are excluded as in the
    other validation metrics."""
    z = np.abs((np.asarray(pred) - np.asarray(truth)) / np.asarray(pred_err))
    z = z[~np.isnan(z)]
    return float(np.mean(z < n_sigma))


def integrated_autocorr_time(
    chain_1d_batch: np.ndarray, reliable_factor: float = 50.0,
    return_converged: bool = False,
):
    """emcee-style integrated autocorrelation time for one parameter.

    ``chain_1d_batch`` (nwalkers, nsteps): FFT autocorrelation averaged over
    walkers with Sokal's adaptive window (c = 5).  Fully stuck walkers are
    excluded.  Returns tau >= 1.

    The windowed estimator is biased LOW when the chain is short: it can
    only see correlations up to the window, so tau keeps growing as you
    feed it longer chains until ``nsteps >> tau``.  Following emcee's
    convention the estimate is
    flagged unreliable when ``nsteps < reliable_factor * tau``.  With
    ``return_converged=True`` returns ``(tau, converged)``; otherwise an
    unreliable estimate emits a ``RuntimeWarning`` (treat the tau as a
    lower bound and any derived ESS as an upper bound).
    """
    import warnings

    x = np.asarray(chain_1d_batch, dtype=np.float64)
    x = x - x.mean(axis=1, keepdims=True)
    alive = x.var(axis=1) > 0
    if not alive.any():
        # EVERY walker frozen: the sampler never moved, so tau is infinite
        # (returning the tau >= 1 floor here would report maximal ESS for
        # a completely stuck chain -- the exact failure this diagnostic
        # exists to catch)
        warnings.warn(
            "all walkers have zero variance (fully stuck chain): tau is "
            "infinite and the ESS is zero",
            RuntimeWarning, stacklevel=2,
        )
        return (np.inf, False) if return_converged else np.inf
    x = x[alive]
    n = x.shape[1]
    nfft = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(x, n=nfft, axis=1)
    acf = np.fft.irfft(f * np.conj(f), n=nfft, axis=1)[:, :n].real
    acf /= np.maximum(acf[:, :1], 1e-30)
    rho = acf.mean(axis=0)
    taus = 2.0 * np.cumsum(rho) - 1.0
    window = np.arange(len(taus)) < 5.0 * taus
    idx = np.argmin(window) if not window.all() else len(taus) - 1
    tau = float(max(taus[min(idx, len(taus) - 1)], 1.0))
    converged = n >= reliable_factor * tau
    if return_converged:
        return tau, converged
    if not converged:
        warnings.warn(
            f"tau estimate {tau:.1f} from only {n} steps "
            f"(< {reliable_factor:g} tau): treat it as a lower bound",
            RuntimeWarning, stacklevel=2,
        )
    return tau


def effective_sample_size(chain: np.ndarray) -> float:
    """ESS of a (nwalkers, nsteps, ndim) chain: n_alive*nsteps / max_d tau_d.

    Frozen (zero-variance) walkers are excluded from BOTH tau and the
    sample count: tau is averaged over moving walkers only, so crediting
    stuck walkers' draws as independent would overreport ESS for exactly
    the pathological ensembles this diagnostic exists to flag."""
    chain = np.asarray(chain)
    # a CONSTANT dimension (pinned/degenerate parameter, identical across
    # walkers and time) has no autocorrelation structure to diagnose: its
    # inf tau would collapse the whole-chain ESS to 0 and flag healthy
    # runs as stuck.  Diagnose over the varying dims; only a chain with NO
    # varying dim keeps the stuck-chain signal (ESS 0).
    # ptp, not var: a pinned dim holds LITERALLY identical values, but
    # np.var of 3200 copies of 0.77 accumulates to ~1e-32, not exactly 0
    varying = np.where(
        chain.max(axis=(0, 1)) > chain.min(axis=(0, 1))
    )[0]
    dims = varying if varying.size else range(chain.shape[-1])
    taus = [integrated_autocorr_time(chain[:, :, d]) for d in dims]
    alive = int((np.var(chain, axis=1).max(axis=-1) > 0).sum())
    return alive * chain.shape[1] / max(taus)


def _rank_normalize(x: np.ndarray) -> np.ndarray:
    """Fractional ranks over ALL draws -> normal scores (Blom offsets
    ``(r - 3/8)/(S + 1/4)``), shape-preserving.

    Ties get AVERAGE (fractional) ranks per Vehtari et al. 2021 -- ordinal
    ranks would assign tied draws sequential ranks in walker-major order,
    correlating rank with walker index (and making constant chains look
    maximally unconverged instead of hitting the ``within == 0`` branch of
    :func:`_split_rhat_raw`)."""
    from scipy.stats import norm, rankdata

    ranks = rankdata(x, method="average", axis=None)
    return norm.ppf((ranks - 0.375) / (x.size + 0.25)).reshape(x.shape)


def _split_rhat_raw(x: np.ndarray) -> float:
    """Classic split-R-hat of one parameter, ``x`` (nchains, nsteps)."""
    n = x.shape[1] // 2
    if n < 2:
        raise ValueError("split_rhat needs at least 4 steps per walker")
    halves = np.concatenate([x[:, :n], x[:, n: 2 * n]], axis=0)
    within = halves.var(axis=1, ddof=1).mean()
    between = n * halves.mean(axis=1).var(ddof=1)
    if within == 0.0:
        # every split-half is constant: identical constants across chains
        # are converged by definition; different constants are stuck chains
        return 1.0 if between == 0.0 else np.inf
    return float(np.sqrt((n - 1) / n + between / (n * within)))


def split_rhat(chain: np.ndarray) -> np.ndarray:
    """Rank-normalized split-R-hat per parameter (Vehtari et al. 2021).

    ``chain`` (nwalkers, nsteps, ndim): each walker is split in half
    (catching trending chains a whole-walker comparison misses), draws are
    rank-normalized (robust to heavy tails / infinite variance), and the
    reported value is the max of the bulk statistic and the tail-sensitive
    folded statistic (ranks of ``|x - median|``).  Values <= 1.01 indicate
    convergence.  Beyond-reference diagnostic: the reference's notebooks
    judge convergence by eye from trace plots (PlotMCMC.ipynb cell 6).
    """
    x = np.asarray(chain, dtype=np.float64)
    if x.ndim != 3:
        raise ValueError(f"expected (nwalkers, nsteps, ndim), got {x.shape}")
    out = np.empty(x.shape[-1])
    for d in range(x.shape[-1]):
        xd = x[:, :, d]
        bulk = _split_rhat_raw(_rank_normalize(xd))
        folded = _split_rhat_raw(_rank_normalize(np.abs(xd - np.median(xd))))
        out[d] = max(bulk, folded)
    return out


def convergence_diagnostics(chain: np.ndarray, rhat_threshold: float = 1.01) -> dict:
    """One-call convergence report for a (nwalkers, nsteps, ndim) chain.

    Returns ``{"rhat": (ndim,), "tau": (ndim,), "tau_converged": (ndim,) bool,
    "ess": float, "converged": bool}`` -- ``converged`` requires every
    rank-normalized split-R-hat <= ``rhat_threshold`` AND every windowed
    tau estimate to be reliable (nsteps >= 50 tau)."""
    import warnings

    x = np.asarray(chain, dtype=np.float64)
    rhat = split_rhat(x)
    # constant dims (pinned parameters) carry tau = NaN / converged = True:
    # they have nothing to diagnose, and their inf tau would otherwise
    # zero the ESS and mark healthy runs unconverged (see
    # effective_sample_size).  A chain where NO dim varies keeps the
    # stuck-chain behavior.
    varying = x.max(axis=(0, 1)) > x.min(axis=(0, 1))  # ptp: see
    # effective_sample_size on why var > 0 is the wrong test here
    if not varying.any():
        varying = np.ones(x.shape[-1], dtype=bool)
    taus = np.full(x.shape[-1], np.nan)
    convs = np.ones(x.shape[-1], dtype=bool)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for d in np.where(varying)[0]:
            t, c = integrated_autocorr_time(x[:, :, d], return_converged=True)
            taus[d] = t
            convs[d] = c
    # frozen walkers don't contribute independent draws (tau is computed
    # over moving walkers only; see effective_sample_size)
    n_alive = int((np.var(x, axis=1).max(axis=-1) > 0).sum())
    ess = n_alive * x.shape[1] / np.nanmax(taus)
    return {
        "rhat": rhat,
        "tau": taus,
        "tau_converged": convs,
        "ess": float(ess),
        "converged": bool((rhat <= rhat_threshold).all() and convs.all()),
    }


def summary(
    chain: np.ndarray,
    names: list[str] | None = None,
    ci: float = 0.9,
) -> str:
    """Plain-text posterior summary table for a (nwalkers, nsteps, ndim)
    chain: mean, sd, median, central ``ci`` interval, rank-normalized
    split-R-hat, and integrated autocorrelation time per parameter."""
    x = np.asarray(chain, dtype=np.float64)
    if x.ndim != 3:
        raise ValueError(f"expected (nwalkers, nsteps, ndim), got {x.shape}")
    ndim = x.shape[-1]
    if names is None:
        names = [f"p{d}" for d in range(ndim)]
    if len(names) != ndim:
        raise ValueError(f"{len(names)} names for {ndim} parameters")
    rep = convergence_diagnostics(x)
    rhat, taus = rep["rhat"], rep["tau"]
    lo_q, hi_q = 100 * (1 - ci) / 2, 100 * (1 + ci) / 2
    flat = x.reshape(-1, ndim)
    w = max(len("param"), *(len(n) for n in names))
    head = (f"{'param':<{w}}  {'mean':>10}  {'sd':>10}  {'median':>10}  "
            f"{f'{lo_q:g}%':>10}  {f'{hi_q:g}%':>10}  {'rhat':>6}  {'tau':>7}")
    lines = [head, "-" * len(head)]
    for d in range(ndim):
        col = flat[:, d]
        lines.append(
            f"{names[d]:<{w}}  {col.mean():>10.4g}  {col.std():>10.4g}  "
            f"{np.median(col):>10.4g}  {np.percentile(col, lo_q):>10.4g}  "
            f"{np.percentile(col, hi_q):>10.4g}  {rhat[d]:>6.3f}  {taus[d]:>7.1f}"
        )
    return "\n".join(lines)
