"""Import trained reference emulators (dill-serialized sklearn objects);
PyTorch port of the JAX package's ``models/migrate.py``.

The reference persists whole Python ``Emulator`` objects with dill.  The
fitted kernel hyperparameters, PCA basis and scalers of such a file are
imported exactly (no retraining), so the converted emulator reproduces the
reference's predictions to float tolerance, on the port's device.

Supported sources: the reference's sklearn-backed ``Emulator`` with kernel
``Const * (RBF | Matern) + White`` per PC (with ``logTrafo``,
``exp_and_cov_diagonal``, ``perform_no_PCA`` and ``parameterTrafoPCA``),
and its surmise-backed ``EmulatorBAND``, rebuilt by a retrain on its stored
training state (:func:`band_from_reference`).

``dill`` is imported only to read a file; the sklearn objects are read by
attribute, so converting a live object needs neither.
"""

from __future__ import annotations

import logging

import numpy as np

from ..config import resolve_device, resolve_dtype
from ..ops.kernels import KernelConfig
from ..ops.scalers import PCAState, StandardScalerState
from .emulator import Emulator
from .gp import GPConfig, finalize_gp_state
from .param_pca import ParamPCAState, default_groups

logger = logging.getLogger(__name__)


def _scaler_state(sk_scaler) -> StandardScalerState:
    return StandardScalerState(
        mean=np.asarray(sk_scaler.mean_, dtype=np.float64),
        scale=np.asarray(sk_scaler.scale_, dtype=np.float64),
        var=np.asarray(sk_scaler.var_, dtype=np.float64),
    )


def _pca_state(sk_pca, whiten) -> PCAState:
    return PCAState(
        mean=np.asarray(sk_pca.mean_, dtype=np.float64),
        components=np.asarray(sk_pca.components_, dtype=np.float64),
        explained_variance=np.asarray(sk_pca.explained_variance_, dtype=np.float64),
        explained_variance_ratio=np.asarray(sk_pca.explained_variance_ratio_, dtype=np.float64),
        whiten=whiten,
    )


def _kernel_params_from_sklearn(gp):
    """({log_amp, log_ls, log_noise} float64 numpy, kind, alpha) of a fitted
    reference GPR with kernel ``Const * (RBF | Matern) + White``."""
    k = gp.kernel_
    prod, white = k.k1, k.k2
    const, base = prod.k1, prod.k2
    kind = type(base).__name__  # "RBF" or "Matern"
    if kind == "Matern" and not np.isclose(base.nu, 1.5):
        raise ValueError(f"unsupported Matern nu={base.nu}; only 1.5")
    return (
        {
            "log_amp": np.log(const.constant_value),
            "log_ls": np.log(np.atleast_1d(base.length_scale)),
            "log_noise": np.log(white.noise_level),
        },
        kind,
        float(gp.alpha),
    )


def _load_dill(source):
    """Load a reference dill file, or pass a live object through.

    A file that embeds an object of a module that is not installed (the
    reference's EmulatorBAND dumps its live surmise emulator) gets a
    targeted error that names the retrain path."""
    if not (isinstance(source, (str, bytes)) or hasattr(source, "__fspath__")):
        return source
    import dill

    try:
        with open(source, "rb") as f:
            return dill.load(f)
    except ModuleNotFoundError as e:
        raise ValueError(
            f"cannot unpickle {source!r}: it references the module "
            f"{e.name!r}, which is not installed (reference EmulatorBAND "
            "files embed a live surmise emulator).  Either install "
            f"{e.name!r} to unpickle and re-run this conversion, or retrain "
            "natively from the original training pickle: "
            "EmulatorBAND(training_set_path=..., parameter_file=..., "
            "method=...).trainEmulatorAutoMask()"
        ) from e


def _convert_param_pca(self, ref):
    """Import the reference's fitted parameter-space PCA (scalers + PCAs of
    the bulk, shear and yloss groups); the groups' grids and curves are the
    port's ``default_groups``, their column indices the reference's."""
    ref_indices = {
        "bulk": tuple(ref.indices_zeta_s_parameters),
        "shear": tuple(ref.indices_eta_s_parameters),
        "yloss": tuple(ref.indices_yloss_parameters),
    }
    self.param_pca_groups = [g._replace(indices=ref_indices[g.name]) for g in default_groups()]
    scalers, pcas, npcs = [], [], []
    for sc, pc in [
        (ref.paramTrafoScaler_bulk, ref.paramTrafoPCA_bulk),
        (ref.paramTrafoScaler_shear, ref.paramTrafoPCA_shear),
        (ref.paramTrafoScaler_yloss, ref.paramTrafoPCA_yloss),
    ]:
        scalers.append(_scaler_state(sc))
        pcas.append(_pca_state(pc, whiten=False))
        npcs.append(int(pc.n_components_))
    self.param_pca_state = ParamPCAState(scalers=tuple(scalers), pcas=tuple(pcas), npcs=tuple(npcs))
    self.PCA_new_design_points = np.asarray(ref.PCA_new_design_points)


def _common_fields(self, ref, device, dtype) -> None:
    self.device = resolve_device(device)
    self._dtype = resolve_dtype(dtype)
    self.logTrafo_ = bool(getattr(ref, "logTrafo_", False))
    self.parameterTrafoPCA_ = bool(getattr(ref, "parameterTrafoPCA_", False))
    self.exp_and_cov_diagonal_ = bool(getattr(ref, "exp_and_cov_diagonal_", False))
    self.nrestarts = 0
    self.gp_grad_precision = "default"
    self.gp_map_prior_strength = 0.0
    self.pardict = dict(getattr(ref, "pardict", {}))
    self.design_min = np.asarray(ref.design_min, dtype=float)
    self.design_max = np.asarray(ref.design_max, dtype=float)
    self.param_pca_groups = default_groups()
    self.param_pca_state = None


def from_reference(source, *, device=None, dtype=None) -> Emulator:
    """Convert a reference sklearn-backed emulator to a port emulator on
    ``device`` (default CUDA) in ``dtype`` (default float32).

    ``source``: a path to the reference's dill ``.sav`` file, or the live
    reference ``Emulator`` object.  Reference ``EmulatorBAND`` objects
    (a ``method_`` attribute and no ``gps``) go to
    :func:`band_from_reference`.
    """
    ref = _load_dill(source)
    if not hasattr(ref, "gps"):
        if hasattr(ref, "method_") and hasattr(ref, "model_data"):
            return band_from_reference(ref, device=device, dtype=dtype)
        raise ValueError(
            "source has no fitted sklearn GPs and no BAND method tag; only "
            "the reference's Emulator / EmulatorBAND objects are convertible"
        )

    self = Emulator.__new__(Emulator)
    _common_fields(self, ref, device, dtype)
    self.perform_no_PCA_ = bool(getattr(ref, "perform_no_PCA_", False))
    self.npc = int(ref.npc)
    self.nobs = int(ref.nobs)
    self.nev = int(ref.nev)
    self.seed = 0
    self.gp_maxiter = 200  # retraining (testEmulatorErrors) must optimize
    self.model_data = np.asarray(ref.model_data)
    self.model_data_err = np.asarray(ref.model_data_err)
    self.design_points = np.asarray(ref.design_points)
    self.design_points_org_ = np.asarray(getattr(ref, "design_points_org_", ref.design_points))

    # the GP batch from the fitted sklearn regressors
    params_list, kinds, alphas = [], set(), set()
    for gp in ref.gps:
        p, kind, alpha = _kernel_params_from_sklearn(gp)
        params_list.append(p)
        kinds.add(kind)
        alphas.add(alpha)
    if len(kinds) != 1 or len(alphas) != 1:
        raise ValueError("mixed kernel types/alphas across PCs are unsupported")
    kind, alpha = kinds.pop(), alphas.pop()
    self.gp_alpha = alpha
    self.gp_config = GPConfig(kernel=KernelConfig(kind), alpha=alpha)
    t = self._tensor
    x_train = t(ref.gps[0].X_train_)
    y_batch = t(np.stack([np.asarray(gp.y_train_) for gp in ref.gps]))
    params = {name: t(np.stack([p[name] for p in params_list])) for name in params_list[0]}
    # the same finalization (with the jitter-rescue Cholesky) as gp_fit
    self.gp_state = finalize_gp_state(params, x_train, y_batch, self.gp_config)
    logger.info("imported %d reference GPs (LML %s)", len(ref.gps),
                self.gp_state.lml.cpu().numpy())

    self.scaler = _scaler_state(ref.scaler)
    if self.perform_no_PCA_:
        self.pca = None
        self._npc_used = self.nobs
    else:
        self.pca = _pca_state(ref.pca, whiten=True)
        self._npc_used = min(self.npc, int(ref.pca.components_.shape[0]))
    if self.parameterTrafoPCA_:
        _convert_param_pca(self, ref)
    self._npc_used = min(self._npc_used, len(ref.gps))
    self._finalize_training(self.gp_state)
    return self


def band_from_reference(source, *, gp_maxiter: int = 200, seed: int = 0,
                        device=None, dtype=None):
    """Convert a reference dill ``EmulatorBAND`` into a port one.

    The reference BAND wrapper delegates its numerics to a live surmise
    emulator, whose hyperparameters belong to its own kernel family and do
    not transplant; but the wrapper carries its complete training state
    (the filtered, optionally log-transformed ``model_data`` /
    ``model_data_err``, the design, the method tag and every transform
    flag).  The conversion rebuilds the port's head on exactly that data: a
    deterministic retrain on ``device`` in ``dtype``.
    """
    from .emulator_band import _METHODS, EmulatorBAND, _impute_iterative_svd

    ref = _load_dill(source)
    if not hasattr(ref, "method_") or not hasattr(ref, "model_data"):
        raise ValueError(
            "source does not look like a reference EmulatorBAND (no "
            "method_/model_data attributes)"
        )
    method = str(ref.method_)
    # the reference constructor never validates method_; an unknown one
    # would otherwise train as a plain PCGP with the wrong noise model
    if method not in _METHODS:
        raise ValueError(
            f"reference emulator has unknown method_ {method!r} "
            f"(expected one of {sorted(_METHODS)}); refusing to convert "
            "it as a plain PCGP"
        )
    self = EmulatorBAND.__new__(EmulatorBAND)
    _common_fields(self, ref, device, dtype)
    self.method_ = method
    self.kernel_kind_ = "Matern"
    self.pc_target_variance = 0.99  # surmise's PC-retention default
    self.max_rel_uncertainty_data_ = float(getattr(ref, "max_rel_uncertainty_data_", 0.1))
    self.perform_no_PCA_ = False
    self.npc = 10**9  # resolved by the variance threshold at train time
    self.seed = seed
    self.gp_maxiter = gp_maxiter
    self.gp_alpha = 1e-6
    self.model_data = np.asarray(ref.model_data, dtype=np.float64)
    self.model_data_err = np.asarray(ref.model_data_err, dtype=np.float64)
    self.design_points = np.asarray(ref.design_points, dtype=np.float64)
    self.design_points_org_ = np.asarray(
        getattr(ref, "design_points_org_", ref.design_points), dtype=np.float64)
    self.nev, self.nobs = self.model_data.shape
    if self.parameterTrafoPCA_:
        self.targetVariance = float(getattr(ref, "targetVariance", 0.99))
        # ref.design_min/max are already the PC ranges
        _convert_param_pca(self, ref)
    self.nparameters = (
        self.PCA_new_design_points.shape[1] if self.parameterTrafoPCA_
        else self.design_points.shape[1]
    )
    self._impute_mask = None
    self._impute_col_var = None
    if method in ("PCGPwImpute", "PCGPwM"):
        self.model_data, self._impute_mask, self._impute_col_var = (
            _impute_iterative_svd(self.model_data))
    self._trained = False
    logger.info("rebuilding %s head from reference BAND state (%d events x %d observables) ...",
                method, self.nev, self.nobs)
    self.trainEmulatorAutoMask()
    return self
