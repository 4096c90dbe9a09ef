"""Device kernels in the traced window per sampler step (host dispatch:
samplers/hmc.py or samplers/ensemble.py, and samplers/chain.py); serves
every ``kernels_per_step.<cells>`` metric."""


def read(summary: dict) -> float | None:
    return summary["n_kernels"] / summary["steps"] if summary["steps"] else None
