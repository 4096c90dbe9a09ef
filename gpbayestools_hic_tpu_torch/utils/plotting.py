"""Posterior plotting utilities (PyTorch port of the JAX package's
``utils/plotting.py``).

- :func:`trace_plot` -- per-parameter marginal histograms;
- :func:`corner_plot` -- pairwise posterior densities + 1D marginals, with
  multi-chain overlay and truth markers;
- :func:`posterior_band_plot` -- 68/95/99.7% credible bands of a parametric
  curve (e.g. the viscosity parametrizations of
  :mod:`..models.param_pca`, which take tensors) over a grid;
- :func:`observables_plot` -- posterior-predictive draws overlaid on
  (pseudo-)experimental data.

Design rules: a fixed-order colorblind-validated categorical palette
(adjacent-pair CVD separation checked computationally: Okabe-Ito subset in
the order blue, amber, green, vermillion, pink), single-hue sequential fills
for magnitude, one axis per panel, recessive grids, legends whenever more
than one chain is shown.

matplotlib is imported lazily (Agg backend), so the package imports where
it is not installed.
"""

from __future__ import annotations

import numpy as np

#: Fixed categorical order; CVD-validated (adjacent-pair OKLab dE:
#: normal 16.4, protan 11.4, deutan 11.0, tritan 10.7 -- all above floor).
CATEGORICAL = ("#0072B2", "#E69F00", "#009E73", "#D55E00", "#CC79A7")
#: Single-hue sequential fills (light -> dark blue) for band/magnitude.
SEQUENTIAL_FILLS = ("#d4e6f4", "#9ec8e4", "#5b9ad0")
_TEXT = "#333333"
_GRID = dict(color="#dddddd", linewidth=0.6, zorder=0)


def _mpl():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _flat(chain):
    chain = np.asarray(chain)
    return chain.reshape(-1, chain.shape[-1])


def _axis_limits(flats, wts, d):
    """Per-dimension plot limits.  Weighted chains use weighted 0.1/99.9
    percentiles: an SMC persistent-sampling history contains prior-born
    particles with ~zero weight spanning the whole prior box, and raw
    min/max limits would collapse a tight posterior into a few bins."""
    from .closure import weighted_quantile

    lo, hi = np.inf, -np.inf
    for f, w in zip(flats, wts):
        x = f[:, d]
        if w is None:
            lo, hi = min(lo, x.min()), max(hi, x.max())
            continue
        q_lo, q_hi = weighted_quantile(x, w, (0.001, 0.999))
        lo = min(lo, q_lo)
        hi = max(hi, q_hi)
    return lo, hi


def trace_plot(chain, labels=None, bins=50, fig_path=None, weights=None):
    """Per-parameter marginal histograms.

    ``weights``: optional per-sample importance weights (use for the SMC
    sampler's weighted persistent-sampling posterior)."""
    plt = _mpl()
    flat = _flat(chain)
    if weights is not None:
        weights = np.asarray(weights).reshape(-1)
    ndim = flat.shape[1]
    ncols = min(ndim, 5)
    nrows = -(-ndim // ncols)
    fig, axes = plt.subplots(
        nrows, ncols, figsize=(2.6 * ncols, 2.2 * nrows), squeeze=False
    )
    for d in range(ndim):
        ax = axes[d // ncols][d % ncols]
        rng_d = _axis_limits([flat], [weights], d)
        ax.hist(flat[:, d], bins=bins, range=rng_d, color=CATEGORICAL[0],
                histtype="stepfilled", alpha=0.85, zorder=2, weights=weights)
        ax.set_xlabel(labels[d] if labels else f"p{d}", color=_TEXT)
        ax.set_yticks([])
        ax.grid(True, **_GRID)
    for d in range(ndim, nrows * ncols):
        axes[d // ncols][d % ncols].set_axis_off()
    fig.tight_layout()
    if fig_path:
        fig.savefig(fig_path, dpi=150)
        plt.close(fig)
    return fig


def corner_plot(
    chains,
    labels=None,
    chain_names=None,
    truths=None,
    bins=40,
    levels=(0.68, 0.95),
    fig_path=None,
    weights=None,
):
    """Corner plot: 1D marginals on the diagonal, 2D contours below.

    ``chains``: one chain or a list of chains (each (..., ndim)); multiple
    chains are overlaid in the fixed categorical order with a legend.
    ``truths`` draws reference markers.
    ``weights``: per-sample importance weights -- one array, or a list
    aligned with ``chains`` (None entries allowed) -- for weighted (SMC)
    posteriors.
    """
    plt = _mpl()
    if not isinstance(chains, (list, tuple)):
        chains = [chains]
    if weights is None:
        weights = [None] * len(chains)
    elif not isinstance(weights, (list, tuple)):
        # a bare weights array applies to a single chain; with multiple
        # chains it is ambiguous (which chain?) -- require an aligned list
        if len(chains) != 1:
            raise ValueError(
                "pass weights as a list aligned with chains (None entries "
                "allowed) when plotting multiple chains"
            )
        weights = [weights]
    elif len(weights) != len(chains):
        raise ValueError(
            f"weights list has {len(weights)} entries for {len(chains)} chains"
        )
    flats = [_flat(c) for c in chains]
    wts = [None if w is None else np.asarray(w).reshape(-1) for w in weights]
    ndim = flats[0].shape[1]
    fig, axes = plt.subplots(
        ndim, ndim, figsize=(1.9 * ndim, 1.9 * ndim), squeeze=False
    )
    lims = [_axis_limits(flats, wts, d) for d in range(ndim)]
    for i in range(ndim):
        for j in range(ndim):
            ax = axes[i][j]
            if j > i:
                ax.set_axis_off()
                continue
            ax.grid(True, **_GRID)
            if i == j:
                for c_idx, f in enumerate(flats):
                    ax.hist(
                        f[:, i], bins=bins, range=lims[i], density=True,
                        histtype="step", linewidth=1.6, weights=wts[c_idx],
                        color=CATEGORICAL[c_idx % len(CATEGORICAL)], zorder=2,
                    )
                if truths is not None:
                    ax.axvline(truths[i], color=_TEXT, linestyle="--",
                               linewidth=1.0, zorder=3)
                ax.set_yticks([])
            else:
                for c_idx, f in enumerate(flats):
                    h, xe, ye = np.histogram2d(
                        f[:, j], f[:, i], bins=bins,
                        range=[lims[j], lims[i]], weights=wts[c_idx],
                    )
                    h = h.T / h.sum()
                    order = np.sort(h.ravel())[::-1]
                    csum = np.cumsum(order)
                    cls = [
                        order[min(np.searchsorted(csum, lv), len(order) - 1)]
                        for lv in sorted(levels, reverse=True)
                    ]
                    xc = 0.5 * (xe[:-1] + xe[1:])
                    yc = 0.5 * (ye[:-1] + ye[1:])
                    ax.contour(
                        xc, yc, h, levels=sorted(set(cls)),
                        colors=CATEGORICAL[c_idx % len(CATEGORICAL)],
                        linewidths=1.2, zorder=2,
                    )
                if truths is not None:
                    ax.plot(truths[j], truths[i], marker="s", ms=5,
                            color=_TEXT, zorder=3)
            if i == ndim - 1:
                ax.set_xlabel(labels[j] if labels else f"p{j}", color=_TEXT)
            else:
                ax.set_xticklabels([])
            if j == 0 and i > 0:
                ax.set_ylabel(labels[i] if labels else f"p{i}", color=_TEXT)
            elif j > 0:
                ax.set_yticklabels([])
    if chain_names and len(chains) > 1:
        handles = [
            plt.Line2D([], [], color=CATEGORICAL[k % len(CATEGORICAL)],
                       label=name)
            for k, name in enumerate(chain_names)
        ]
        fig.legend(handles=handles, loc="upper right", frameon=False)
    fig.tight_layout()
    if fig_path:
        fig.savefig(fig_path, dpi=150)
        plt.close(fig)
    return fig


def posterior_band_plot(
    curve_fn,
    chain,
    grid,
    param_indices,
    cls=(68.0, 95.0, 99.7),
    n_samples=2000,
    seed=0,
    xlabel="x",
    ylabel="f(x)",
    truth_params=None,
    fig_path=None,
    weights=None,
):
    """Credible bands of a parametric curve over ``grid``.

    ``curve_fn(params (m, k), grid (g,)) -> (m, g)`` takes float64 tensors
    (the vectorized viscosity parametrizations in :mod:`..models.param_pca`
    fit directly); ``param_indices`` selects the curve's parameter columns
    from the chain.  ``weights``: optional per-sample
    importance weights (weighted SMC posterior) -- the subsample is drawn
    proportionally to them.
    """
    plt = _mpl()
    import torch

    from .closure import validate_linear_weights

    def curves_at(params):
        out = curve_fn(torch.as_tensor(np.asarray(params, dtype=np.float64)),
                       torch.as_tensor(np.asarray(grid, dtype=np.float64)))
        return np.asarray(out.detach().cpu().numpy() if hasattr(out, "detach") else out)

    flat = _flat(chain)
    rng = np.random.default_rng(seed)
    if weights is not None:
        p = validate_linear_weights(weights)
        idx = rng.choice(flat.shape[0], size=min(n_samples, flat.shape[0]),
                         replace=True, p=p / p.sum())
    else:
        idx = rng.choice(flat.shape[0], size=min(n_samples, flat.shape[0]),
                         replace=False)
    curves = curves_at(flat[idx][:, param_indices])

    fig, ax = plt.subplots(figsize=(5, 3.4))
    ax.grid(True, **_GRID)
    for ci, cl in enumerate(sorted(cls, reverse=True)):
        lo = np.percentile(curves, 50 - cl / 2, axis=0)
        hi = np.percentile(curves, 50 + cl / 2, axis=0)
        ax.fill_between(
            grid, lo, hi, color=SEQUENTIAL_FILLS[ci % len(SEQUENTIAL_FILLS)],
            label=f"{cl:g}% CL", zorder=1 + ci, linewidth=0,
        )
    median = np.percentile(curves, 50, axis=0)
    ax.plot(grid, median, color=CATEGORICAL[0], linewidth=2.0,
            label="median", zorder=5)
    if truth_params is not None:
        truth_curve = curves_at(np.asarray(truth_params)[None, :])[0]
        ax.plot(grid, truth_curve, color=_TEXT, linestyle="--",
                linewidth=1.4, label="truth", zorder=6)
    ax.set_xlabel(xlabel, color=_TEXT)
    ax.set_ylabel(ylabel, color=_TEXT)
    ax.legend(frameon=False, fontsize=8)
    fig.tight_layout()
    if fig_path:
        fig.savefig(fig_path, dpi=150)
        plt.close(fig)
    return fig


def observables_plot(
    pred_draws,
    exp_mean,
    exp_err,
    obs_labels=None,
    fig_path=None,
):
    """Posterior-predictive draws over experimental data.

    ``pred_draws`` (n_draws, nobs); data as error bars, draws as thin lines.
    """
    plt = _mpl()
    pred_draws = np.asarray(pred_draws)
    x = np.arange(pred_draws.shape[1])
    fig, ax = plt.subplots(figsize=(max(5, 0.25 * len(x)), 3.4))
    ax.grid(True, **_GRID)
    for draw in pred_draws:
        ax.plot(x, draw, color=CATEGORICAL[0], alpha=0.25, linewidth=1.0,
                zorder=2)
    ax.errorbar(
        x, np.asarray(exp_mean).flatten(), yerr=np.asarray(exp_err).flatten(),
        fmt="o", ms=3.5, color=_TEXT, ecolor=_TEXT, elinewidth=1.0,
        label="data", zorder=4,
    )
    ax.plot([], [], color=CATEGORICAL[0], alpha=0.6,
            label="posterior draws")
    ax.set_xlabel("observable index" if obs_labels is None else "",
                  color=_TEXT)
    if obs_labels is not None:
        ax.set_xticks(x)
        ax.set_xticklabels(obs_labels, rotation=90, fontsize=7)
    ax.legend(frameon=False, fontsize=8)
    fig.tight_layout()
    if fig_path:
        fig.savefig(fig_path, dpi=150)
        plt.close(fig)
    return fig
