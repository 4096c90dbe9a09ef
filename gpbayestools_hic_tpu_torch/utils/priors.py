"""Priors for the SMC sampler from frozen scipy distributions.

PyTorch port of the JAX package's ``utils/priors.py``.  The reference
builds its pocoMC prior from a list of frozen scipy distributions; the
sampler needs the prior density inside its device loop, so
:class:`ScipyPrior` turns each marginal into a torch log-density and
exposes ``log_prior_torch(x) -> (m,)``, ``logpdf``, ``rvs`` and ``dim`` /
``bounds``, the interface :func:`..samplers.smc.run_smc` expects.

Supported marginals: ``uniform``, ``norm``, ``truncnorm``, ``loguniform``
(``reciprocal``); anything else raises and points to ``log_prior_torch``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_LOG_2PI = math.log(2 * math.pi)


def _logpdf_factory(dist):
    name = dist.dist.name
    args, kwds = dist.args, dist.kwds

    # shape/loc/scale may be positional or keyword in a frozen distribution
    def get(i, key, default):
        if key in kwds:
            return float(kwds[key])
        if len(args) > i:
            return float(args[i])
        return default

    if name == "uniform":
        loc, scale = get(0, "loc", 0.0), get(1, "scale", 1.0)

        def logpdf(x):
            inside = (x >= loc) & (x <= loc + scale)
            return torch.where(inside, torch.full_like(x, -math.log(scale)),
                               torch.full_like(x, -math.inf))

        return logpdf
    if name == "norm":
        loc, scale = get(0, "loc", 0.0), get(1, "scale", 1.0)

        def logpdf(x):
            z = (x - loc) / scale
            return -0.5 * z**2 - math.log(scale) - 0.5 * _LOG_2PI

        return logpdf
    if name == "truncnorm":
        a, b = get(0, "a", None), get(1, "b", None)
        loc, scale = get(2, "loc", 0.0), get(3, "scale", 1.0)
        from scipy.stats import norm as _norm

        log_norm_const = float(np.log(_norm.cdf(b) - _norm.cdf(a)))

        def logpdf(x):
            z = (x - loc) / scale
            lp = -0.5 * z**2 - math.log(scale) - 0.5 * _LOG_2PI - log_norm_const
            return torch.where((z >= a) & (z <= b), lp, torch.full_like(lp, -math.inf))

        return logpdf
    if name in ("loguniform", "reciprocal"):
        a, b = get(0, "a", None), get(1, "b", None)
        loc, scale = get(2, "loc", 0.0), get(3, "scale", 1.0)
        log_range = float(np.log(np.log(b) - np.log(a)))

        def logpdf(x):
            # X = loc + scale * base, base ~ loguniform(a, b)
            z = (x - loc) / scale
            # the clamp keeps log() finite outside the support
            lp = -torch.log(torch.clamp(z, min=a)) - log_range - math.log(scale)
            return torch.where((z >= a) & (z <= b), lp, torch.full_like(lp, -math.inf))

        return logpdf
    raise ValueError(
        f"unsupported scipy distribution {name!r}; provide an object with a "
        "torch log_prior_torch(x) instead"
    )


class ScipyPrior:
    """Independent per-dimension prior from frozen scipy distributions (the
    ``pocomc.Prior(list_of_dists)`` construction of the reference)."""

    def __init__(self, dists):
        self.dists = list(dists)
        self.dim = len(self.dists)
        self._logpdfs = [_logpdf_factory(d) for d in self.dists]
        self.bounds = np.array([d.support() for d in self.dists])

    def log_prior_torch(self, x: torch.Tensor) -> torch.Tensor:
        """(m, dim) -> (m,) total log prior density."""
        total = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for d, fn in enumerate(self._logpdfs):
            total = total + fn(x[:, d])
        return total

    def logpdf(self, x) -> np.ndarray:
        """numpy convenience (pocoMC-compatible), in float64."""
        x = torch.as_tensor(np.atleast_2d(np.asarray(x, dtype=np.float64)))
        return self.log_prior_torch(x).numpy()

    def rvs(self, size: int, random_state=None) -> np.ndarray:
        """``size`` draws; ``random_state`` (a numpy Generator) makes them
        seed-deterministic."""
        return np.stack(
            [d.rvs(size=size, random_state=random_state) for d in self.dists], axis=1
        )
