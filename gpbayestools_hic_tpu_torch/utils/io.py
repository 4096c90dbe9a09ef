"""Host-side IO honoring the reference's on-disk data contracts.

1. Training pickle: ``{event_id(str-int): {"parameter": (ndim,),
   "obs": (2, nobs)}}`` with row 0 = mean, row 1 = stat error.
2. Chain pickle: ``{"chain": (nwalkers, nsteps, ndim)}``.
3. Serialized emulator: a pickled ``{"tree": ..., "meta": ...}`` payload
   of numpy arrays, the format the JAX package's ``Emulator.save`` writes.
   Its state tuples are pickled by class from the JAX package's
   ``ops.scalers`` module; :func:`load_pytree` maps those classes onto the
   port's own copies, so reading a save file never imports JAX.
"""

from __future__ import annotations

import importlib
import logging
import pickle
from typing import NamedTuple

import numpy as np

logger = logging.getLogger(__name__)

_JAX_PACKAGE = "gpbayestools_hic_tpu"
_PORT_PACKAGE = "gpbayestools_hic_tpu_torch"


class TrainingData(NamedTuple):
    design_points: np.ndarray      # (nev, ndim) possibly-transformed copy
    design_points_org: np.ndarray  # (nev, ndim) original parameters
    model_data: np.ndarray         # (nev, nobs) observables (log if logTrafo)
    model_data_err: np.ndarray     # (nev, nobs) stat errors (relative if logTrafo)
    discarded: int                 # number of high-noise points dropped


def load_training_pickle(
    path,
    *,
    max_rel_uncertainty: float = 0.1,
    log_trafo: bool = False,
) -> TrainingData:
    """Load a training pickle with the reference's filter/transform semantics.

    - events sorted by integer id;
    - events whose max relative stat error exceeds ``max_rel_uncertainty``
      are discarded;
    - with ``log_trafo``: data -> ``log(|y| + 1e-30)`` and errors ->
      relative errors ``|err / (y + 1e-30)|``;
    - errors pass through ``nan_to_num(abs(.))``.
    """
    logger.info("loading training data from %s ...", path)
    with open(path, "rb") as fp:
        data_dict = pickle.load(fp)

    sorted_ids = sorted(data_dict.keys(), key=lambda x: int(x))
    design, data, err = [], [], []
    discarded = 0
    for event_id in sorted_ids:
        obs = np.asarray(data_dict[event_id]["obs"]).transpose()  # (nobs, 2)
        stat_err_max = np.abs(obs[:, 1] / (obs[:, 0] + 1e-16)).max()
        if stat_err_max > max_rel_uncertainty:
            logger.info(
                "Discard Parameter %s, stat err = %.2f", event_id, stat_err_max
            )
            discarded += 1
            continue
        design.append(np.asarray(data_dict[event_id]["parameter"], dtype=float))
        if log_trafo:
            data.append(np.log(np.abs(obs[:, 0]) + 1e-30))
            err.append(np.abs(obs[:, 1] / (obs[:, 0] + 1e-30)))
        else:
            data.append(obs[:, 0])
            err.append(obs[:, 1])
    design = np.array(design)
    data = np.array(data)
    err = np.nan_to_num(np.abs(np.array(err)))
    logger.info(
        "Training dataset size: %d, discarded points: %d", len(data), discarded
    )
    if len(data) == 0:
        raise ValueError(
            f"all {discarded} training points were discarded by the "
            f"max_rel_uncertainty={max_rel_uncertainty} noise filter; "
            "raise the threshold or check the error columns"
        )
    return TrainingData(
        design_points=design,
        design_points_org=design.copy(),
        model_data=data,
        model_data_err=err,
        discarded=discarded,
    )


def load_exp_data_pickle(path) -> tuple[np.ndarray, np.ndarray]:
    """Load experimental data: returns (mean (1, nobs), diagonal cov (nobs, nobs)).

    The covariance is diagonal, built from the squared stat errors.  Only
    one event entry is supported (several would silently truncate the
    errors and break the (1, nobs) contract).
    """
    with open(path, "rb") as fp:
        data_dict = pickle.load(fp)
    if len(data_dict) != 1:
        raise ValueError(
            f"experimental-data pickle {path} has {len(data_dict)} event "
            "entries; exactly one is supported (concatenate observables "
            "into a single event's 'obs' array instead)"
        )
    means, errs = [], []
    for event_id in data_dict.keys():
        obs = np.asarray(data_dict[event_id]["obs"]).transpose()
        means.append(obs[:, 0])
        errs.append(obs[:, 1])
    means = np.array(means)
    errs = np.nan_to_num(np.abs(np.array(errs))).flatten()
    nobs = means.shape[1]
    cov = np.zeros((nobs, nobs))
    np.fill_diagonal(cov, errs**2)
    return means, cov


def _to_numpy_tree(tree):
    """Tensors -> numpy arrays through dicts, lists, tuples and NamedTuples."""
    if hasattr(tree, "detach") and hasattr(tree, "cpu"):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_numpy_tree(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy_tree(v) for v in tree)
    if isinstance(tree, (bool, type(None))):
        return tree
    return np.asarray(tree)


def save_pytree(path, tree, meta: dict | None = None) -> None:
    """Serialize a tree of arrays (+ static metadata) to a pickle file."""
    payload = {"tree": _to_numpy_tree(tree), "meta": meta or {}}
    with open(path, "wb") as f:
        pickle.dump(payload, f)


class _PortUnpickler(pickle.Unpickler):
    """Resolve the JAX package's pickled classes to the port's copies."""

    def find_class(self, module, name):
        if module == _JAX_PACKAGE or module.startswith(_JAX_PACKAGE + "."):
            port_module = _PORT_PACKAGE + module[len(_JAX_PACKAGE):]
            try:
                return getattr(importlib.import_module(port_module), name)
            except (ImportError, AttributeError):
                raise NotImplementedError(
                    f"{module}.{name} has no counterpart in the PyTorch port "
                    "yet (see ROADMAP.md, 'Modules to port')"
                ) from None
        return super().find_class(module, name)


def load_pytree(path):
    """Load a tree saved by :func:`save_pytree` or by the JAX package's
    ``save_pytree``; returns (tree, meta)."""
    with open(path, "rb") as f:
        payload = _PortUnpickler(f).load()
    return payload["tree"], payload["meta"]
