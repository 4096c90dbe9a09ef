"""Sort an SMC chain by likelihood and extract posterior k-means clusters.

k-means runs on ``device`` (default CUDA); the cluster centers are then
propagated through the emulators.  Run the pipeline up to
``run_bayesian_analysis.py pocoMC`` first.

    python generate_posterior_clusters.py [device]
"""

import sys
from pathlib import Path

import numpy as np

from gpbayestools_hic_tpu_torch.models import Emulator
from gpbayestools_hic_tpu_torch.utils import generate_posterior_clusters

DATA = Path("synthetic_data")
GROUPS = ("dNdy", "meanpT", "vn")


def main(chain_name: str = "chain_smc.pkl", n_clusters: int = 3,
         n_top_samples: int = 1000, device=None):
    centers, _ = generate_posterior_clusters(
        DATA / "mcmc" / chain_name, n_clusters=n_clusters,
        n_top_samples=n_top_samples, output_dir=DATA, device=device,
    )
    print("cluster centers (one per row):\n", centers.round(4))
    print(f"centers written to {DATA / 'cluster_centers.txt'} (one cluster per column)")

    # the cluster parameters through the emulators, to observables
    emus = [Emulator.load(DATA / f"emulator_sklearn_{g}.sav", device=device) for g in GROUPS]
    preds = np.concatenate([e.predict(centers, return_cov=False) for e in emus], axis=1)
    np.savetxt(DATA / "cluster_observables.txt", preds.T)
    print(f"cluster-center observables written to {DATA / 'cluster_observables.txt'} "
          "(one cluster per column)")


if __name__ == "__main__":
    main(device=sys.argv[1] if len(sys.argv) > 1 else None)
