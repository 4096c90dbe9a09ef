"""IO contracts, metrics, clustering, sensitivity, closure, priors,
synthetic problems and the f64 posterior oracle."""

from .io import load_training_pickle, load_exp_data_pickle, save_pytree, load_pytree  # noqa: F401
from .metrics import rms_relative_error, honesty, mean_log_honesty, delta_d, coverage, integrated_autocorr_time, effective_sample_size, split_rhat, convergence_diagnostics, summary  # noqa: F401
from .cluster import kmeans, sort_chain_likelihood, generate_posterior_clusters  # noqa: F401
from .sensitivity import sensitivity_matrix, sensitivity_matrix_fd  # noqa: F401
from .closure import (  # noqa: F401
    percentile_params,
    posterior_predictive,
    resample_weighted,
)
from .priors import ScipyPrior  # noqa: F401
