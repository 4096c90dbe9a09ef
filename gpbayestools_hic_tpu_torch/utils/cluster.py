"""Posterior cluster sampling: chain sorting and k-means (PyTorch port of
the JAX package's ``utils/cluster.py``).

- :func:`sort_chain_likelihood` -- sort a chain pickle by log-likelihood,
  descending, and write ``*_sorted.pkl``;
- :func:`kmeans_pp_init` -- k-means++ seeding on the host from an explicit
  ``torch.Generator``;
- :func:`kmeans` -- Lloyd's algorithm, ``n_init`` starts as one batch on
  the data's device, the lowest inertia winning;
- :func:`generate_posterior_clusters` -- standardize the top-N samples,
  cluster, and write ``cluster_centers.txt`` with one cluster per column.

The seeding runs on the host in float64 from the generator, so a run on
the card and one on the CPU start from the same centers; its stream is not
``jax.random``'s.  Lloyd's iterations stop per start as the JAX
``lax.while_loop`` does (at ``max_iter``, or once no center moved by more
than ``tol`` in squared distance), with one host read per iteration.
"""

from __future__ import annotations

import logging
import pickle
from pathlib import Path

import numpy as np
import torch

from ..config import resolve_device, resolve_dtype

logger = logging.getLogger(__name__)


def kmeans_pp_init(x, k: int, n_init: int, generator: torch.Generator) -> np.ndarray:
    """k-means++ seeding of ``n_init`` starts: (n_init, k, d) float64 numpy
    rows of ``x`` (n, d), drawn on the host from ``generator`` (a CPU
    generator)."""
    xh = torch.as_tensor(np.asarray(x, dtype=np.float64))
    n = xh.shape[0]
    out = torch.empty((n_init, k, xh.shape[1]), dtype=torch.float64)
    for r in range(n_init):
        out[r, 0] = xh[torch.randint(0, n, (), generator=generator)]
        d2 = ((xh - out[r, 0]) ** 2).sum(-1)
        for i in range(1, k):
            # all-duplicate inputs give d2 == 0 everywhere: draw uniformly
            total = d2.sum()
            probs = d2 / total if total > 0 else torch.full((n,), 1.0 / n, dtype=torch.float64)
            out[r, i] = xh[torch.multinomial(probs, 1, generator=generator)[0]]
            d2 = torch.minimum(d2, ((xh - out[r, i]) ** 2).sum(-1))
    return out.numpy()


def kmeans(
    x: torch.Tensor,
    k: int,
    *,
    generator: torch.Generator | None = None,
    n_init: int = 10,
    max_iter: int = 300,
    tol: float = 1e-6,
    init=None,
):
    """K-means clustering of ``x`` (n, d) on its device; returns (centers
    (k, d), labels (n,), inertia ()) as tensors.

    ``init`` (n_init, k, d) gives the starting centers; otherwise they come
    from :func:`kmeans_pp_init` with ``generator`` (a CPU generator; one
    seeded with 0 when None).
    """
    n, d = x.shape
    if n < k:
        raise ValueError(f"n_samples={n} should be >= n_clusters={k}")
    if init is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init = kmeans_pp_init(x.detach().cpu().numpy(), k, n_init, generator)
    centers = torch.as_tensor(np.asarray(init), dtype=x.dtype, device=x.device)

    def step(c):
        d2 = ((x[None, :, None, :] - c[:, None, :, :]) ** 2).sum(-1)   # (r, n, k)
        onehot = torch.nn.functional.one_hot(d2.argmin(-1), k).to(x.dtype)
        counts = onehot.sum(1)                                          # (r, k)
        sums = onehot.transpose(1, 2) @ x                               # (r, k, d)
        new = torch.where(counts[..., None] > 0,
                          sums / torch.clamp(counts[..., None], min=1), c)
        return new, ((new - c) ** 2).sum(-1).amax(-1)

    # the JAX loop: one step always, then while it < max_iter and shift > tol
    centers, shift = step(centers)
    it = 1
    active = shift > tol
    while it < max_iter and bool(active.any()):
        new, shift_new = step(centers)
        centers = torch.where(active[:, None, None], new, centers)
        active = active & (shift_new > tol)
        it += 1
    d2 = ((x[None, :, None, :] - centers[:, None, :, :]) ** 2).sum(-1)
    labels = d2.argmin(-1)
    inertia = d2.amin(-1).sum(-1)
    best = int(torch.argmin(inertia))
    return centers[best], labels[best], inertia[best]


def sort_chain_likelihood(chain_path, output_path=None):
    """Sort a chain pickle (flat ``chain`` (nsamples, ndim) with ``logl``)
    by log-likelihood descending; write ``*_sorted.pkl``."""
    chain_path = Path(chain_path)
    with open(chain_path, "rb") as f:
        data = pickle.load(f)
    order = np.argsort(-np.asarray(data["logl"]))
    sorted_data = dict(data)
    for key in ("chain", "weights", "logl", "logp"):
        if key in sorted_data:
            sorted_data[key] = np.asarray(sorted_data[key])[order]
    if output_path is None:
        output_path = chain_path.with_name(chain_path.stem + "_sorted.pkl")
    with open(output_path, "wb") as f:
        pickle.dump(sorted_data, f)
    logger.info("wrote sorted chain to %s", output_path)
    return sorted_data


def generate_posterior_clusters(
    chain_path,
    n_clusters: int,
    n_top_samples: int = 1000,
    output_dir=None,
    random_state: int = 42,
    n_init: int = 10,
    device=None,
    dtype=None,
    stats: dict | None = None,
):
    """Cluster the top-likelihood posterior samples; write the centers.

    Sorts by ``logl``, takes the top ``n_top_samples``, standardizes them,
    runs :func:`kmeans` on ``device`` (default CUDA) in ``dtype`` (default
    float32) with k-means++ starts drawn from a CPU generator seeded with
    ``random_state``, un-standardizes the centers and writes
    ``cluster_centers.txt`` with one cluster per column.  Returns (centers
    (n_clusters, ndim), labels) as float64 / int numpy; ``stats``, when
    given, receives the inertia.
    """
    sorted_data = sort_chain_likelihood(chain_path)
    top = np.asarray(sorted_data["chain"], dtype=np.float64)[:n_top_samples]
    mean = top.mean(axis=0)
    scale = top.std(axis=0)
    scale[scale == 0] = 1.0
    z = torch.as_tensor((top - mean) / scale, dtype=resolve_dtype(dtype),
                        device=resolve_device(device))
    centers_std, labels, inertia = kmeans(
        z, n_clusters, generator=torch.Generator().manual_seed(int(random_state)),
        n_init=n_init)
    centers = centers_std.cpu().numpy().astype(np.float64) * scale + mean
    labels = labels.cpu().numpy()
    logger.info("k-means inertia: %.4f", float(inertia))
    if stats is not None:
        stats["inertia"] = float(inertia)
    used = np.unique(labels).size
    if used < n_clusters:
        # heavily duplicated top samples can leave clusters empty; their
        # centers are then duplicates
        logger.warning(
            "only %d of %d clusters are populated (top samples contain many "
            "duplicates); cluster_centers.txt has duplicate rows", used, n_clusters)
    outdir = Path(output_dir) if output_dir else Path(chain_path).parent
    outdir.mkdir(parents=True, exist_ok=True)
    np.savetxt(outdir / "cluster_centers.txt", centers.T)
    return centers, labels
