"""Maximin / MaxPro Latin-hypercube designs on the device (PyTorch port of
the JAX package's ``design/lhd.py``).

A simulated-annealing coordinate exchange over the LHS permutation
structure:

- start from a random Latin hypercube (stratified per dimension);
- propose swapping one dimension's values between two random points (this
  keeps the Latin property exactly);
- improve the **MaxPro** criterion (minimize ``log sum_{i<j} 1 / prod_d
  (x_id - x_jd)^2``) or the **maximin** criterion (a softmin of the
  pairwise squared distances);
- anneal the Metropolis temperature from 0.5 down by e^-8.

The annealer keeps the (n, n) matrix of pairwise terms and recomputes only
the rows and columns of the two points a proposal moves, where the JAX
scan recomputes the whole O(n^2 d) energy every step; the energy is the
log-sum-exp over the whole matrix either way.  Every step's indices and
uniforms are drawn in one call up front from an explicit
``torch.Generator``, and the accept decision is a ``torch.where``: the loop
makes no host read.  The generator's stream is not ``jax.random``'s, so a
design at a given seed is not the JAX package's; designs are cached under
the JAX package's file names (``cache/lhs/npoints{}_ndim{}_seed{}.npy``), so
either package loads a design the other made.
"""

from __future__ import annotations

import logging
import math
from pathlib import Path

import numpy as np
import torch

from ..config import new_generator, resolve_device, resolve_dtype
from ..runtime import cachedir, parse_model_parameter_file

logger = logging.getLogger(__name__)

#: Fixed default seeds of the main and the validation design.
DEFAULT_SEED_MAIN = 450829120
DEFAULT_SEED_VALIDATION = 751783496

#: (x_i - x_j)^2 floor inside the MaxPro logarithm
_EPS = 1e-20


def _random_lhs(gen: torch.Generator, npoints: int, ndim: int, *,
                dtype=torch.float64) -> torch.Tensor:
    """Random Latin hypercube on [0, 1]^d: one stratum per point per dim.
    The offset inside a stratum stays a few rounding units away from its
    edges, so that the point is inside its stratum in ``dtype`` too."""
    device = gen.device
    perms = torch.argsort(torch.rand((ndim, npoints), generator=gen, device=device), dim=1).T
    u = torch.rand((npoints, ndim), generator=gen, dtype=torch.float64, device=device)
    margin = min(0.25, 8.0 * npoints * torch.finfo(dtype).eps)
    x = (perms.to(torch.float64) + margin + (1.0 - 2.0 * margin) * u) / npoints
    return x.to(dtype)


def _pair_terms(a: torch.Tensor, x: torch.Tensor, criterion: str) -> torch.Tensor:
    """Pairwise energy terms between the rows of ``a`` (k, d) and ``x`` (n,
    d): (k, n), ``-sum_d log((a - x)^2 + eps)`` for MaxPro and ``-beta
    |a - x|^2`` (beta = 4 n) for maximin."""
    diff2 = (a[:, None, :] - x[None, :, :]) ** 2
    if criterion == "maxpro":
        return -torch.log(diff2 + _EPS).sum(-1)
    return -4.0 * x.shape[0] * diff2.sum(-1)


def _pairwise_logsq(x: torch.Tensor) -> torch.Tensor:
    """log((x_i - x_j)^2 + eps) summed over dims -> (n, n)."""
    return -_pair_terms(x, x, "maxpro")


def _upper(m: torch.Tensor) -> torch.Tensor:
    n = m.shape[0]
    iu = torch.triu_indices(n, n, offset=1, device=m.device)
    return m[iu[0], iu[1]]


def _maxpro_energy(x: torch.Tensor) -> torch.Tensor:
    """log of the MaxPro criterion sum_{i<j} prod_d (x_id - x_jd)^-2."""
    return torch.logsumexp(-_upper(_pairwise_logsq(x)), 0)


def _maximin_energy(x: torch.Tensor) -> torch.Tensor:
    """Softmin surrogate of the minimum pairwise distance (to minimize):
    logsumexp(-beta d^2) over the pairs, beta = 4 n."""
    return torch.logsumexp(_upper(_pair_terms(x, x, "maximin")), 0)


def _anneal(gen: torch.Generator, x0: torch.Tensor, *, niters: int, criterion: str):
    """Simulated annealing from ``x0`` (n, d); returns the best design met
    and its energy (a 0-d tensor)."""
    n, d = x0.shape
    dev, dt = x0.device, x0.dtype
    if niters <= 0 or n < 2:
        energy = _maxpro_energy(x0) if criterion == "maxpro" else _maximin_energy(x0)
        return x0, energy
    # every step's draws up front: point i, a different point j, a dim, a uniform
    i_all = torch.randint(0, n, (niters,), generator=gen, device=dev)
    j_all = torch.remainder(
        i_all + 1 + torch.randint(0, n - 1, (niters,), generator=gen, device=dev), n)
    dim_all = torch.randint(0, d, (niters,), generator=gen, device=dev)
    u_all = torch.rand(niters, generator=gen, dtype=dt, device=dev)
    temps = 0.5 * torch.exp(torch.linspace(0.0, -8.0, niters, dtype=dt, device=dev))
    log2 = math.log(2.0)
    two = torch.arange(2, device=dev)

    # the symmetric matrix of pairwise terms with -inf on the diagonal: the
    # energy is its log-sum-exp less log 2 (each pair appears twice)
    pairs = _pair_terms(x0, x0, criterion)
    pairs.diagonal().fill_(-math.inf)
    x, e = x0.clone(), torch.logsumexp(pairs.flatten(), 0) - log2
    best_x, best_e = x.clone(), e.clone()
    for t in range(niters):
        idx = torch.stack([i_all[t], j_all[t]])
        col = dim_all[t].expand(2)
        x_new = x.index_put((idx, col), x[idx.flip(0), col])
        rows = _pair_terms(x_new.index_select(0, idx), x_new, criterion)   # (2, n)
        rows = rows.index_put((two, idx), torch.full((), -math.inf, dtype=dt, device=dev))
        pairs_new = pairs.index_copy(0, idx, rows).index_copy_(1, idx, rows.T)
        e_new = torch.logsumexp(pairs_new.flatten(), 0) - log2
        accept = (e_new < e) | (u_all[t] < torch.exp((e - e_new) / temps[t]))
        x = torch.where(accept, x_new, x)
        pairs = torch.where(accept, pairs_new, pairs)
        e = torch.where(accept, e_new, e)
        better = e < best_e
        best_x = torch.where(better, x, best_x)
        best_e = torch.where(better, e, best_e)
    return best_x, best_e


def generate_lhs(
    npoints: int,
    ndim: int,
    seed: int,
    *,
    method: str = "maxpro",
    niters: int | None = None,
    cache: bool = True,
    device=None,
    dtype=None,
) -> np.ndarray:
    """An optimized LHS on [0, 1]^d as float64 numpy, annealed on
    ``device`` (default CUDA) in ``dtype`` (default float32).

    ``method``: "maxpro" or "maximin".  ``niters`` defaults to min(20000,
    200 npoints).  The design is cached as
    ``cache/lhs/npoints{}_ndim{}_seed{}.npy`` under the working directory,
    with the method and a non-default ``niters`` appended to the name.
    """
    if method not in ("maxpro", "maximin"):
        # an unknown string would otherwise optimize maximin and cache the
        # design under the typo's name
        raise ValueError(f"unknown LHS method {method!r}: use 'maxpro' or 'maximin'")
    default_niters = int(min(20000, 200 * npoints))
    suffix = "" if method == "maxpro" else f"_{method}"
    if niters is not None and niters != default_niters:
        suffix += f"_niters{niters}"
    cachefile = Path(str(cachedir)) / "lhs" / f"npoints{npoints}_ndim{ndim}_seed{seed}{suffix}.npy"
    if cache and cachefile.exists():
        logger.debug("loading from cache")
        return np.load(cachefile)

    dev = resolve_device(device)
    gen = new_generator(dev, seed)
    x0 = _random_lhs(gen, npoints, ndim, dtype=resolve_dtype(dtype))
    x, energy = _anneal(gen, x0, niters=default_niters if niters is None else niters,
                        criterion=method)
    x = x.cpu().numpy().astype(np.float64)
    # the annealer minimizes a smooth surrogate; the exact min distance
    # costs an (n, n, d) temporary, so only for a debug line
    if logger.isEnabledFor(logging.DEBUG):
        logger.debug("annealed %s surrogate energy: %.4f (exact min pairwise distance %.5f)",
                     method, float(energy), min_pairwise_distance(x))
    if cache:
        cachefile.parent.mkdir(parents=True, exist_ok=True)
        np.save(cachefile, x)
    return x


def min_pairwise_distance(x: np.ndarray) -> float:
    d2 = np.sum((x[:, None, :] - x[None, :, :]) ** 2, axis=-1)
    np.fill_diagonal(d2, np.inf)
    return float(np.sqrt(d2.min()))


class Design:
    """Latin-hypercube model design.

    Attributes: ``type`` ('main'/'validation'), ``pardict``, ``min`` /
    ``max``, ``ndim``, ``points`` (padded names), ``array``; converts to a
    numpy array.  The default seed is fixed per design type.  ``device``
    and ``dtype`` are the annealer's (:func:`generate_lhs`).
    """

    def __init__(
        self,
        parfile,
        npoints: int = 500,
        validation: bool = False,
        seed: int | None = None,
        method: str = "maxpro",
        device=None,
        dtype=None,
    ):
        self.pardict = parse_model_parameter_file(parfile)
        self.type = "validation" if validation else "main"
        self.ndim = len(self.pardict)

        fmt = "parameter_{:0" + str(len(str(npoints - 1))) + "d}"
        self.points = [fmt.format(i) for i in range(npoints)]

        if seed is None:
            seed = DEFAULT_SEED_VALIDATION if validation else DEFAULT_SEED_MAIN
            logger.info("using default %s design seed = %d", self.type, seed)
        self.seed = seed

        self.min = np.array([v[1] for v in self.pardict.values()])
        self.max = np.array([v[2] for v in self.pardict.values()])

        unit = generate_lhs(npoints, self.ndim, seed, method=method, device=device, dtype=dtype)
        self.array = self.min + (self.max - self.min) * unit

    def __array__(self, dtype=None, copy=None):
        out = np.asarray(self.array, dtype=dtype)
        if copy:
            return out.copy()
        if copy is False and out is not self.array:
            # NumPy 2 protocol: copy=False must alias or raise
            raise ValueError(
                "Design.__array__ cannot satisfy copy=False with a dtype conversion"
            )
        return out

    def write_files(self, basedir):
        """Write one ``key value`` input file per design point under
        ``basedir/<type>/``."""
        outdir = Path(basedir) / self.type
        outdir.mkdir(parents=True, exist_ok=True)
        for point, row in zip(self.points, self.array):
            filepath = outdir / point
            with filepath.open("w") as f:
                for key, value in zip(self.pardict.keys(), row):
                    f.write(f"{key} {value}\n")
            logger.debug("wrote %s", filepath)
