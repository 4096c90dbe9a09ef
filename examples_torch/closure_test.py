"""Closure test: does the posterior contain the known truth?

Percentiles and the closure metric Delta_d of the weighted SMC posterior,
its posterior predictive through the emulators on ``device`` (default
CUDA), and trace / corner / predictive plots.  Run the pipeline up to
``run_bayesian_analysis.py pocoMC`` first.

    python closure_test.py [device]
"""

import pickle
import sys
from pathlib import Path

import numpy as np

from gpbayestools_hic_tpu_torch import parse_model_parameter_file
from gpbayestools_hic_tpu_torch.models import Emulator
from gpbayestools_hic_tpu_torch.utils import delta_d, percentile_params, posterior_predictive
from gpbayestools_hic_tpu_torch.utils.plotting import corner_plot, observables_plot, trace_plot

DATA = Path("synthetic_data")
GROUPS = ("dNdy", "meanpT", "vn")


def main(device=None):
    truth = np.loadtxt(DATA / "truth_parameters.txt")
    with open(DATA / "mcmc" / "chain_smc.pkl", "rb") as f:
        chain_data = pickle.load(f)
    chain = chain_data["chain"]
    # the SMC chain is the weighted persistent-sampling history: every
    # metric and plot takes the weights, or it summarizes a prior mixture
    weights = chain_data.get("weights")

    pct = percentile_params(chain, weights=weights)
    print("16/50/84 percentiles:\n", np.round(pct, 3))
    pars = parse_model_parameter_file(DATA / "model_params.txt")
    lo = np.array([v[1] for v in pars.values()])
    hi = np.array([v[2] for v in pars.values()])
    dd = delta_d(chain, truth, lo, hi, weights=weights)
    print(f"closure metric Delta_d = {dd:.4f} (small is good)")

    emus = [Emulator.load(DATA / f"emulator_sklearn_{g}.sav", device=device) for g in GROUPS]
    preds = posterior_predictive(chain, emus, n_draws=15, weights=weights)
    with open(DATA / "exp_data.pkl", "rb") as f:
        exp = pickle.load(f)["0"]["obs"]
    observables_plot(preds, exp[0], exp[1], fig_path=DATA / "closure_ppc.png")
    trace_plot(chain, weights=weights, fig_path=DATA / "trace.png")
    corner_plot(chain, truths=truth, weights=weights, fig_path=DATA / "corner.png")
    print(f"plots written to {DATA}/")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
