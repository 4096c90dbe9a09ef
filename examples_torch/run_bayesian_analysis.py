"""Full-pipeline Bayesian calibration.

Loads the per-group emulators, builds the Chain on ``device`` (default
CUDA) and runs flow-preconditioned SMC (pocoMC semantics), the ensemble
sampler, PTLMC or HMC.  Run ``make_synthetic_dataset.py`` and
``emulator_training.py`` first.

    python run_bayesian_analysis.py [pocoMC|emcee|PTLMC|HMC] [devices] [device]

``devices=N`` shards the walkers (chains, particles) over the first N
GPUs (``-1``: all of them); asking for more than the machine has raises
before anything is loaded.  A ``mesh=`` keyword (a
``gpbayestools_hic_tpu_torch.parallel.WalkerMesh``) takes its place.
"""

import sys
from pathlib import Path

from gpbayestools_hic_tpu_torch.parallel import resolve_mesh
from gpbayestools_hic_tpu_torch.samplers import Chain

DATA = Path("synthetic_data")
GROUPS = ("dNdy", "meanpT", "vn")


def build_chain(mcmc_name: str, device=None) -> Chain:
    chain = Chain(
        mcmc_path=str(DATA / "mcmc" / mcmc_name),
        expdata_path=str(DATA / "exp_data.pkl"),
        model_parafile=str(DATA / "model_params.txt"),
        device=device,
    )
    chain.loadEmulator([str(DATA / f"emulator_sklearn_{g}.sav") for g in GROUPS])
    return chain


def main(sampler: str = "pocoMC", devices: int | None = None, device=None, **overrides):
    # keyword overrides go to the sampler call (e.g. smaller sizes for a
    # smoke run); the mesh is resolved first, so a bad device count
    # raises before any loading
    overrides["mesh"] = resolve_mesh(devices, overrides.get("mesh"))
    if sampler == "pocoMC":  # recommended
        chain = build_chain("chain_smc.pkl", device)
        kwargs = dict(n_effective=1000, n_active=500, n_prior=2000, sample="tpcn",
                      n_max_steps=50, n_total=8000, n_evidence=2000)
        chain.run_pocoMC(**{**kwargs, **overrides})
    elif sampler == "emcee":
        chain = build_chain("chain_ensemble.pkl", device)
        kwargs = dict(nsteps=1000, nburnsteps=1000, nwalkers=100, nthin=2)
        chain.run_mcmc(**{**kwargs, **overrides})
    elif sampler == "PTLMC":
        chain = build_chain("chain_ptlmc.pkl", device)
        kwargs = dict(nsteps=1000, nwalkers=16, ntemps=30, maxtemp=100)
        chain.run_MCMC_PTLMC(**{**kwargs, **overrides})
    elif sampler == "HMC":
        chain = build_chain("chain_hmc.pkl", device)
        # n_leapfrog="auto" calibrates the trajectory length per posterior;
        # windowed trajectory sampling with partial momentum refresh
        kwargs = dict(nsteps=500, nwalkers=64, nburnsteps=128, n_leapfrog="auto",
                      scheme="windowed", persist=0.7)
        chain.run_MCMC_HMC(**{**kwargs, **overrides})
    else:
        raise SystemExit(f"unknown sampler {sampler}")
    if sampler != "pocoMC":  # weighted SMC posteriors have no walker-time axis
        chain.convergence_report()
    print(f"{sampler} chain written under {DATA / 'mcmc'}")


if __name__ == "__main__":
    main(
        sys.argv[1] if len(sys.argv) > 1 else "pocoMC",
        int(sys.argv[2]) if len(sys.argv) > 2 else None,
        sys.argv[3] if len(sys.argv) > 3 else None,
    )
