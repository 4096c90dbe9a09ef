"""Posterior plots and closure metrics for the saved chains.

Trace histograms, corner plots with truth markers, the multi-sampler
overlay, 16/50/84 percentiles, the closure metric Delta_d and 68/95/99.7%
posterior bands of a viscosity-style curve (evaluated on ``device``,
default CUDA).  Reads whichever chains ``run_bayesian_analysis.py`` wrote;
the SMC chain's importance weights enter every plot and metric.

    python plot_mcmc.py [device]
"""

import pickle
import sys
from pathlib import Path

import numpy as np

from gpbayestools_hic_tpu_torch import parse_model_parameter_file
from gpbayestools_hic_tpu_torch.config import resolve_device
from gpbayestools_hic_tpu_torch.models.param_pca import eta_over_s_vs_mu_B
from gpbayestools_hic_tpu_torch.utils import delta_d, percentile_params
from gpbayestools_hic_tpu_torch.utils.metrics import summary
from gpbayestools_hic_tpu_torch.utils.plotting import corner_plot, posterior_band_plot, trace_plot

DATA = Path("synthetic_data")
CHAIN_FILES = {  # sampler name -> pickle written by run_bayesian_analysis.py
    "SMC": "chain_smc.pkl",
    "ensemble": "chain_ensemble.pkl",
    "PTLMC": "chain_ptlmc.pkl",
    "HMC": "chain_hmc.pkl",
}


def load_chains():
    """Every chain pickle that exists: {name: (flat, weights)}; walker
    chains also get a summary table printed."""
    chains = {}
    for name, fname in CHAIN_FILES.items():
        path = DATA / "mcmc" / fname
        if not path.exists():
            continue
        with open(path, "rb") as f:
            data = pickle.load(f)
        arr = np.asarray(data["chain"])
        if data.get("weights") is None and arr.ndim == 3 and arr.shape[1] >= 4:
            print(f"[{name}] posterior summary:\n{summary(arr)}")
        chains[name] = (arr.reshape(-1, arr.shape[-1]), data.get("weights"))
    if not chains:
        raise SystemExit("no chains found -- run run_bayesian_analysis.py first")
    return chains


def main(device=None):
    dev = resolve_device(device)
    truth = np.loadtxt(DATA / "truth_parameters.txt")
    labels = [f"$p_{d}$" for d in range(truth.size)]
    pars = parse_model_parameter_file(DATA / "model_params.txt")
    lo = np.array([v[1] for v in pars.values()])
    hi = np.array([v[2] for v in pars.values()])
    chains = load_chains()

    for name, (flat, w) in chains.items():
        print(f"[{name}] 16/50/84 percentiles:\n{np.round(percentile_params(flat, weights=w), 3)}")
        print(f"[{name}] closure metric Delta_d = {delta_d(flat, truth, lo, hi, weights=w):.4f} "
              "(small is good)")

    first = next(iter(chains))
    flat, w = chains[first]
    trace_plot(flat, labels=labels, weights=w, fig_path=DATA / "plot_trace.png")
    corner_plot([c for c, _ in chains.values()], labels=labels, chain_names=list(chains),
                truths=truth, weights=[w for _, w in chains.values()],
                fig_path=DATA / "plot_corner.png")

    # the synthetic parameter space has no viscosity block: map the first
    # three parameters through eta/s(mu_B) to show the band workflow (with a
    # real chain, pass the shear indices).  The grid starts above 0, where
    # the parametrization's strict-bound branch returns eta_4 exactly.
    grid = np.linspace(1e-3, 0.6, 100)
    posterior_band_plot(
        lambda p, g: eta_over_s_vs_mu_B(p.to(dev), g.to(dev)),
        flat, grid, param_indices=[0, 1, 2], weights=w,
        xlabel=r"$\mu_B$ [GeV]", ylabel=r"$\eta/s$", truth_params=truth[:3],
        fig_path=DATA / "plot_eta_band.png",
    )
    print(f"plots written to {DATA}/ (trace, corner, eta/s band)")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
