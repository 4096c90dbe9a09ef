"""PCA-projected multi-output GP emulator (PyTorch port of ``models/emulator.py``).

Training data are standardized, projected through whitened full-SVD PCA,
and the first ``npc`` PCs are each emulated by an independent GP, all
fitted in one batched optimizer run (:func:`..models.gp.gp_fit`).
``predict`` runs the parameter-PCA transform (``parameterTrafoPCA=True``),
the batched GP posterior, the inverse PCA transform and the linear
uncertainty propagation on the emulator's device.

Reference quirks preserved as in the JAX package: truncation covariance
for neglected PCs with the ``1e-4 * scaler.var_`` diagonal stabilizer; the
predictive covariance includes the white-noise level but not alpha;
``exp_and_cov_diagonal`` exponentiates the mean and rebuilds a diagonal
covariance ``(fstd * mean)^2``.

``save`` writes the JAX package's format with plain tuples for the state
tuples, so the JAX package's ``Emulator.load`` reads it without importing
this package; ``load`` hands a save with a ``method`` field (a BAND head)
to :class:`..models.emulator_band.EmulatorBAND`, in either package.

Validation (``testEmulatorErrors*``) and the diagnostics
(``outputPCAvsParam``, ``print_learning_curve``) retrain and predict on
the emulator's device; ``predict_device`` returns device tensors.
"""

from __future__ import annotations

import copy
import logging
from typing import Sequence

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from ..config import new_generator, resolve_device, resolve_dtype
from ..ops.fused_predict import (
    backward_kernel, build_fused_state, fused_eligible, fused_pc_predict,
)
from ..ops.kernels import KernelConfig
from ..ops.scalers import (
    PCAState,
    StandardScalerState,
    fit_pca,
    fit_standard_scaler,
    pca_transform,
    scaler_transform,
)
from ..runtime import parse_model_parameter_file
from ..utils.io import load_pytree, load_training_pickle, save_pytree
from ..utils.profiling import span
from ..utils.tensors import to_device
from .gp import GPConfig, GPState, gp_fit, gp_predict, gp_sample
from .param_pca import (
    ParamPCAGroup,
    ParamPCAState,
    apply_param_pca_packed,
    default_groups,
    eta_over_s_vs_mu_B,
    fit_param_pca,
    pack_param_pca,
    y_loss_vs_y_init,
    zeta_over_s_vs_T,
)

logger = logging.getLogger(__name__)


def records_derivative(x: torch.Tensor) -> bool:
    """Whether a derivative of ``x`` is being taken: autograd records a
    gradient for it, or it carries a forward-mode tangent or sits inside a
    ``torch.func`` transform (``jacfwd``, ``vmap``)."""
    return ((torch.is_grad_enabled() and x.requires_grad)
            or torch._C._functorch.is_functorch_wrapped_tensor(x)
            or fwAD.unpack_dual(x).tangent is not None)


class Emulator:
    """Multidimensional GP emulator with optional PCA projection.

    Constructor signature mirrors the JAX package plus ``device`` (default
    CUDA; pass ``"cpu"`` for the plain host path) and ``dtype`` (default
    float32); training runs where the emulator lives.  As there, set
    ``gp_grad_precision`` (``"default"``, ``"high"`` or ``"highest"``) on
    the instance before training to choose the fused predict's backward
    kernel, and ``gp_map_prior_strength`` for a MAP fit; a loaded save file
    carries both.
    """

    def __init__(
        self,
        training_set_path: str = ".",
        parameter_file: str = "ABCD.txt",
        npc: int = 10,
        nrestarts: int = 0,
        logTrafo: bool = False,
        parameterTrafoPCA: bool = False,
        max_rel_uncertainty_data: float = 0.1,
        exp_and_cov_diagonal: bool = False,
        perform_no_PCA: bool = False,
        param_pca_groups: Sequence[ParamPCAGroup] | None = None,
        seed: int = 0,
        gp_maxiter: int = 200,
        device=None,
        dtype=None,
    ):
        self.device = resolve_device(device)
        self._dtype = resolve_dtype(dtype)
        self.gp_maxiter = gp_maxiter
        self.logTrafo_ = logTrafo
        self.parameterTrafoPCA_ = parameterTrafoPCA
        self.max_rel_uncertainty_data_ = max_rel_uncertainty_data
        self.exp_and_cov_diagonal_ = exp_and_cov_diagonal
        if not self.logTrafo_ and self.exp_and_cov_diagonal_:
            raise ValueError(
                "exp_and_cov_diagonal can only be set to True if logTrafo is True."
            )
        self.perform_no_PCA_ = perform_no_PCA
        self.npc = npc
        self.nrestarts = nrestarts
        self.seed = seed
        self.gp_alpha = 0.1  # sklearn GPR alpha
        self.gp_grad_precision = "default"

        td = load_training_pickle(
            training_set_path,
            max_rel_uncertainty=max_rel_uncertainty_data,
            log_trafo=logTrafo,
        )
        self.design_points = td.design_points
        self.design_points_org_ = td.design_points_org
        self.model_data = td.model_data
        self.model_data_err = td.model_data_err
        self.nev, self.nobs = self.model_data.shape

        self.pardict = parse_model_parameter_file(parameter_file)
        self.design_min = np.array([v[1] for v in self.pardict.values()])
        self.design_max = np.array([v[2] for v in self.pardict.values()])

        self.param_pca_groups = (
            list(param_pca_groups) if param_pca_groups is not None else default_groups()
        )
        self.param_pca_state: ParamPCAState | None = None
        if self.parameterTrafoPCA_:
            self.targetVariance = 0.99
            logger.info("Preparing parameter-space PCA ...")
            (
                self.param_pca_state,
                self.PCA_new_design_points,
                self.design_min,
                self.design_max,
            ) = fit_param_pca(
                self.design_points,
                self.design_min,
                self.design_max,
                self.param_pca_groups,
                target_variance=self.targetVariance,
            )
        self._trained = False

    # ------------------------------------------------- parametrizations
    # The viscosity curves as methods (the reference's API); they accept
    # scalars or a grid and return a float or a float64 numpy array.

    @staticmethod
    def _curve(fn, params, grid):
        out = fn(torch.tensor([params], dtype=torch.float64),
                 torch.as_tensor(np.asarray(grid, dtype=np.float64)))
        return float(out.reshape(-1)[0]) if np.ndim(grid) == 0 else out[0].numpy()

    def parametrization_zeta_over_s_vs_T(self, zeta_max, T_zeta0, sigma_plus,
                                         sigma_minus, T, mu_B):
        return self._curve(lambda p, g: zeta_over_s_vs_T(p, g, mu_B),
                           [zeta_max, T_zeta0, sigma_plus, sigma_minus], T)

    def parametrization_eta_over_s_vs_mu_B(self, eta_0, eta_2, eta_4, mu_B):
        return self._curve(eta_over_s_vs_mu_B, [eta_0, eta_2, eta_4], mu_B)

    def parametrization_y_loss_vs_y_init(self, yloss_2, yloss_4, yloss_6, y_init):
        return self._curve(y_loss_vs_y_init, [yloss_2, yloss_4, yloss_6], y_init)

    # ------------------------------------------------------------------ train

    @property
    def _np_dtype(self):
        return np.float64 if self._dtype == torch.float64 else np.float32

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=self._dtype, device=self.device)

    def trainEmulatorAutoMask(self):
        self.trainEmulator(np.ones(self.nev, dtype=bool))

    def _training_data(self, eventMask):
        """Masked training matrix; subclass hook.  The BAND impute heads
        fill NaNs per fit on exactly this subset, so that holdout rows
        never enter the fill of the training values."""
        return self.model_data[np.asarray(eventMask, dtype=bool), :]

    def _prepare_training(self, eventMask, kernel_type: str):
        """Fit scaler/PCA on the host, build GP targets.

        Returns ``(design (nev, d) tensor, z_t (npc_used, nev) tensor, ptp
        (d,) numpy, noise_diag (npc_used, nev) tensor or None)``; sets
        scaler/pca/_npc_used/gp_config.
        """
        if kernel_type not in ("RBF", "Matern", "MaternProd"):
            raise ValueError(f"Unknown kernel type: {kernel_type}")
        eventMask = np.asarray(eventMask, dtype=bool)
        data = np.asarray(self._training_data(eventMask), dtype=self._np_dtype)

        self.scaler = fit_standard_scaler(data)
        standardized = scaler_transform(self.scaler, data)
        if self.perform_no_PCA_:
            logger.info("Skipping PCA. Using raw standardized data for GP training ...")
            z = standardized
            npc_used = self.nobs
            self.pca = None
        else:
            logger.info("Standardizing data and performing PCA ...")
            self.pca = fit_pca(standardized, whiten=True)
            npc_used = self._select_npc(self.pca)
            z = pca_transform(self.pca, standardized, npc=npc_used)
            logger.info(
                "%d PCs explain %.5f of variance", npc_used,
                float(np.sum(self.pca.explained_variance_ratio[:npc_used])),
            )
        self._npc_used = npc_used
        design = self._tensor((
            self.PCA_new_design_points if self.parameterTrafoPCA_ else self.design_points
        )[eventMask, :])
        ptp = np.asarray(self.design_max) - np.asarray(self.design_min)
        if np.any(ptp <= 0):
            names = list(self.pardict.keys())
            bad = [names[i] if i < len(names) else f"column {i}"
                   for i in np.nonzero(ptp <= 0)[0]]
            raise ValueError(
                f"parameter range(s) with max <= min: {bad}; fixed (pinned) "
                "parameters must be removed from the parameter file, not "
                "zero-width"
            )
        self.gp_config = self._gp_config(
            kernel_type, self.gp_alpha, self.gp_grad_precision,
            getattr(self, "gp_map_prior_strength", 0.0))
        noise_diag = self._pc_noise_diag(eventMask, npc_used)
        return design, self._tensor(np.asarray(z).T), ptp.astype(self._np_dtype), noise_diag

    @staticmethod
    def _gp_config(kernel_kind: str, alpha: float, grad_precision: str,
                   map_prior_strength: float = 0.0) -> GPConfig:
        backward_kernel(grad_precision)  # an unknown value raises
        return GPConfig(kernel=KernelConfig(kernel_kind), alpha=alpha,
                        grad_precision=grad_precision,
                        map_prior_strength=map_prior_strength)

    def _select_npc(self, pca) -> int:
        """Number of PCs to emulate; subclass hook (the BAND heads keep a
        share of the variance instead of a fixed count)."""
        return min(self.npc, pca.components.shape[0])

    def _pc_noise_diag(self, eventMask, npc_used):
        """Per-(PC, event) known noise variances for the GP Gram diagonal,
        a tensor on the emulator's device; None for this homoskedastic head
        (PCSK and PCGPwM override it)."""
        return None

    def trainEmulator(self, eventMask, kernel_type: str = "RBF"):
        """Train on the masked subset of events."""
        design, z_t, ptp, noise_diag = self._prepare_training(eventMask, kernel_type)
        logger.info("Train GP emulators with %d training points ...", design.shape[0])
        gp_state = gp_fit(design, z_t, ptp, config=self.gp_config,
                          nrestarts=self.nrestarts, seed=self.seed,
                          maxiter=self.gp_maxiter, noise_diag=noise_diag)
        logger.info("GP LMLs: %s", gp_state.lml.cpu().numpy())
        self._finalize_training(gp_state)

    def _finalize_training(self, gp_state: GPState):
        self.gp_state = gp_state
        if not self.perform_no_PCA_:
            self._set_transform_matrices(self._npc_used)
        self._trained = True
        self._build_predict_state()

    def _set_transform_matrices(self, npc_used: int):
        """PC-space -> physical-space map, variance propagation blocks and
        the truncation covariance, on the host in float64."""
        comps = np.asarray(self.pca.components, dtype=np.float64)
        ev = np.asarray(self.pca.explained_variance, dtype=np.float64)
        scale = np.asarray(self.scaler.scale, dtype=np.float64)
        trans = comps * np.sqrt(ev)[:, None] * scale
        self._trans_matrix = trans.astype(self._np_dtype)
        a = trans[:npc_used]
        self._var_trans = (
            np.einsum("ki,kj->kij", a, a)
            .reshape(npc_used, self.nobs * self.nobs)
            .astype(self._np_dtype)
        )
        b = trans[npc_used:]
        cov_trunc = b.T @ b + np.diag(1e-4 * np.asarray(self.scaler.var, dtype=np.float64))
        self._cov_trunc = cov_trunc.astype(self._np_dtype)

    # ---------------------------------------------------------------- predict

    def _build_predict_state(self):
        """Device tensors the predict paths read (uploaded once)."""
        t = self._tensor
        self._scaler_mean = t(self.scaler.mean)
        self._scaler_scale = t(self.scaler.scale)
        if not self.perform_no_PCA_:
            self._trans_t = t(self._trans_matrix[: self._npc_used])
            self._var_trans_t = t(self._var_trans)
            self._cov_trunc_t = t(self._cov_trunc)
            self._cov_trunc_diag_t = t(np.diagonal(self._cov_trunc).copy())
        self._pp_packed = (
            pack_param_pca(self.param_pca_state, dtype=self._dtype, device=self.device)
            if self.parameterTrafoPCA_ else None
        )
        gs = self.gp_state
        kind = self.gp_config.kernel.kind
        self._fused = (
            build_fused_state(gs.params, gs.x, gs.linv, gs.alpha_vec, kind)
            if fused_eligible(kind, gs.x.shape[1], self._dtype) else None
        )

    def _transform_x(self, x: torch.Tensor) -> torch.Tensor:
        """Query parameters as the GPs see them: through the parameter-PCA
        transform when ``parameterTrafoPCA`` (before the fused op)."""
        if self._pp_packed is None:
            return x
        return apply_param_pca_packed(self._pp_packed, self.param_pca_groups, x)

    def _takes_fused(self, x: torch.Tensor, fast_grad: bool) -> bool:
        """Whether the GP predict at ``x`` runs the fused op: the emulator has
        a fused state (float32 RBF or Matern-1.5, d <= FUSED_MAX_DIM; a
        MaternProd head has none), and either the
        caller asked for the fast gradient or the queries are on the card
        with no derivative taken of them.  A CPU call keeps ``gp_predict``'s
        summation order; a caller that differentiates keeps its FP32 plain
        gradient (the fused backward's default kernel is one TF32 pass, and
        the op has no forward-mode rule)."""
        if self._fused is None:
            return False
        return fast_grad or (x.is_cuda and not records_derivative(x))

    def _gp_pc_parts(self, x: torch.Tensor, fast_grad: bool = False):
        """The GP predict of every PC at the queries (through the parameter
        transform), before the fused route's variance epilogue: ``gp_mean
        (m, npc)``, then ``qform (m, npc)`` and ``kdiag (npc,)`` on the fused
        route (the variance is ``max(kdiag - qform, 0)``), else ``gp_var (m,
        npc)`` and None; the route is :meth:`_takes_fused`'s."""
        x = self._transform_x(x)
        if self._takes_fused(x, fast_grad):
            # fused kernel (float32 RBF or Matern-1.5): k* build, mean and the
            # variance quadratic form in one pass
            with span("hic.predict"):
                gp_mean, qform = fused_pc_predict(
                    self._fused, x, self.gp_config.grad_precision)     # (m, npc)
            return gp_mean, qform, self._fused.kdiag
        with span("hic.predict"):
            gp_mean, gp_var = gp_predict(self.gp_state, x, config=self.gp_config,
                                         fast_grad=fast_grad)
        return gp_mean.T, gp_var.T, None

    def _gp_pc(self, x: torch.Tensor, fast_grad: bool = False):
        """``gp_mean (m, npc)``, ``gp_var (m, npc)`` at the queries."""
        gp_mean, q, kdiag = self._gp_pc_parts(x, fast_grad)
        if kdiag is None:
            return gp_mean, q
        return gp_mean, torch.clamp(kdiag[None, :] - q, min=0.0)

    def _predict_full(self, x: torch.Tensor, extra_std: torch.Tensor):
        """(m, d) -> mean (m, nobs), covariance (m, nobs, nobs)."""
        gp_mean, gp_var = self._gp_pc(x)
        with span("hic.assembly"):
            gp_var = gp_var + extra_std[:, None] ** 2
            if self.perform_no_PCA_:
                # the variance is de-standardized consistently with the mean
                # (deliberate divergence from the reference's unit mismatch)
                mean = gp_mean * self._scaler_scale + self._scaler_mean
                cov = torch.diag_embed(gp_var * self._scaler_scale**2)
            else:
                mean = gp_mean @ self._trans_t + self._scaler_mean
                cov = (gp_var @ self._var_trans_t).reshape(-1, self.nobs, self.nobs)
                cov = cov + self._cov_trunc_t
            if self.exp_and_cov_diagonal_:
                mean = torch.exp(mean)
                fstd = torch.sqrt(torch.diagonal(cov, dim1=1, dim2=2))
                cov = torch.diag_embed((fstd * mean) ** 2)
            return mean, cov

    def _pc_core(self, x: torch.Tensor, fast_grad: bool, raw: bool):
        gp_mean, gp_var = self._gp_pc(x, fast_grad)
        if raw:
            return gp_mean, gp_var
        if self.perform_no_PCA_:
            mean = gp_mean * self._scaler_scale + self._scaler_mean
        else:
            mean = gp_mean @ self._trans_t + self._scaler_mean
        return mean, gp_var

    def predict_pc_raw(self, x: torch.Tensor):
        """Whitened PC-space GP outputs (gp_mean (m, npc), gp_var (m, npc))."""
        return self._pc_core(x, fast_grad=False, raw=True)

    def predict_pc_raw_fastgrad(self, x: torch.Tensor):
        """Same values as :meth:`predict_pc_raw`; cheap reverse-mode gradient
        (the fused kernels for a float32 RBF or Matern-1.5 emulator).  Reverse
        mode only."""
        return self._pc_core(x, fast_grad=True, raw=True)

    def predict_pc_parts_fastgrad(self, x: torch.Tensor):
        """:meth:`predict_pc_raw_fastgrad` before its variance epilogue:
        ``(gp_mean, qform, kdiag)`` on the fused route, where the variance is
        ``max(kdiag - qform, 0)``, else ``(gp_mean, gp_var, None)``; for the
        fused Woodbury epilogue, which applies it itself."""
        return self._gp_pc_parts(x, fast_grad=True)

    def predict_diag(self, x: torch.Tensor):
        """(mean (m, nobs), diagonal of the covariance (m, nobs))."""
        mean, gp_var = self._pc_core(x, fast_grad=False, raw=False)
        if self.perform_no_PCA_:
            var = gp_var * self._scaler_scale**2
        else:
            var = gp_var @ (self._trans_t**2) + self._cov_trunc_diag_t
        if self.exp_and_cov_diagonal_:
            mean = torch.exp(mean)
            var = var * mean**2
        return mean, var

    def predict(self, X, return_cov: bool = True, extra_std=0):
        """Predict observables at ``X`` (nsamples, ndim) -> numpy arrays
        ``mean (nsamples, nobs)`` and, with ``return_cov``, ``cov
        (nsamples, nobs, nobs)``."""
        if not self._trained:
            raise RuntimeError("trainEmulator must be called before predict")
        x = self._tensor(np.atleast_2d(np.asarray(X, dtype=np.float64)))
        with torch.no_grad():
            if not return_cov:
                mean, _ = self.predict_diag(x)
                return mean.cpu().numpy()
            extra = torch.broadcast_to(
                self._tensor(np.asarray(extra_std, dtype=np.float64)).reshape(-1),
                (x.shape[0],),
            )
            mean, cov = self._predict_full(x, extra)
        return mean.cpu().numpy(), cov.cpu().numpy()

    def predict_device(self, X: torch.Tensor, extra_std: torch.Tensor | None = None):
        """Predict on device tensors with no host copy: ``X`` (m, d) on the
        emulator's device and dtype -> ``(mean (m, nobs), cov (m, nobs,
        nobs))``, differentiable in ``X``."""
        if extra_std is None:
            extra_std = torch.zeros(X.shape[0], dtype=self._dtype, device=self.device)
        return self._predict_full(X, extra_std)

    def sample_y(self, X, n_samples: int = 1, random_state=None):
        """Sample model output at ``X``: (nsamples_X, n_samples, nobs).

        Emulated PCs are drawn from their GP posteriors, neglected PCs are
        standard normal.  ``random_state`` as in sklearn: an int seeds the
        draws, None gives fresh draws per call (a seed from numpy's global
        generator), a numpy ``Generator`` or ``RandomState`` supplies the
        seed.  The normals come from a ``torch.Generator`` with that seed,
        so the draws differ from the JAX package's for the same seed.
        """
        if self.perform_no_PCA_:
            logger.warning("Sampling from raw data is not implemented.")
            return None
        if random_state is None:
            seed = int(np.random.randint(2**31))
        elif isinstance(random_state, (int, np.integer)):
            seed = int(random_state)
        elif isinstance(random_state, np.random.Generator):
            seed = int(random_state.integers(2**31))
        elif isinstance(random_state, np.random.RandomState):
            seed = int(random_state.randint(2**31))
        else:
            raise TypeError(
                f"random_state must be int, None, numpy Generator or "
                f"RandomState, got {type(random_state).__name__}"
            )
        gen = new_generator(self.device, seed)
        x = self._tensor(np.atleast_2d(np.asarray(X, dtype=np.float64)))
        with torch.no_grad():
            draws = gp_sample(self.gp_state, self._transform_x(x), n_samples,
                              config=self.gp_config, generator=gen)
            draws = draws.permute(1, 2, 0)               # (m, n_samples, npc)
            n_total = self.pca.components.shape[0]
            rest = torch.randn((x.shape[0], n_samples, n_total - self._npc_used),
                               generator=gen, dtype=self._dtype, device=self.device)
            z = torch.cat([draws, rest], dim=2)
            y = z @ self._tensor(self._trans_matrix) + self._scaler_mean
        return y.cpu().numpy()

    # ------------------------------------------------------------- validation

    def _holdout_masks(self, nTestPoints: int):
        train_mask = np.ones(self.nev, dtype=bool)
        train_mask[self.nev - nTestPoints :] = False
        return train_mask

    def _validation_arrays(self, validate_mask: np.ndarray):
        pred, pred_cov = self.predict(
            self.design_points_org_[validate_mask, :], return_cov=True
        )
        pred_err = np.sqrt(np.diagonal(pred_cov, axis1=1, axis2=2))
        if self.logTrafo_ and not self.exp_and_cov_diagonal_:
            preds = np.exp(pred)
            preds_err = pred_err * np.exp(pred)
        else:
            preds = pred
            preds_err = pred_err
        if self.logTrafo_:
            truth = np.exp(self.model_data[validate_mask, :])
            truth_err = self.model_data_err[validate_mask, :] * truth
        else:
            truth = np.array(self.model_data[validate_mask, :])
            truth_err = np.array(self.model_data_err[validate_mask, :])
        # imputed entries (the BAND impute heads) are model output, not
        # observed truth: they are marked NaN, and the E/H metrics skip them
        imp = getattr(self, "_impute_mask", None)
        if imp is not None:
            imp_v = np.asarray(imp, bool)[np.asarray(validate_mask, bool), :]
            truth = np.where(imp_v, np.nan, truth)
            truth_err = np.where(imp_v, np.nan, truth_err)
        return (
            preds.reshape(-1, self.nobs),
            preds_err.reshape(-1, self.nobs),
            truth.reshape(-1, self.nobs),
            truth_err.reshape(-1, self.nobs),
        )

    def testEmulatorErrors(self, nTestPoints: int = 1, kernel_type: str = "RBF"):
        """Hold out the last ``nTestPoints`` events; train on the rest and
        predict the holdouts.  Returns ``(pred, pred_err, truth,
        truth_err)``, each (nTestPoints, nobs) numpy."""
        logger.info("Validating GP emulator ...")
        train_mask = self._holdout_masks(nTestPoints)
        self.trainEmulator(train_mask, kernel_type=kernel_type)
        return self._validation_arrays(~train_mask)

    def testEmulatorErrorsWithTrainingPoints(
        self, nTestPoints: int = 1, kernel_type: str = "RBF"
    ):
        """Self-consistency: train without the last ``nTestPoints`` events
        and predict the training points themselves."""
        logger.info("Validating GP emulator ...")
        train_mask = self._holdout_masks(nTestPoints)
        self.trainEmulator(train_mask, kernel_type=kernel_type)
        return self._validation_arrays(train_mask)

    def getAvgTrainingDataRelError(self):
        with np.errstate(divide="ignore", invalid="ignore"):
            rel = np.nan_to_num(self.model_data_err / self.model_data)
        return np.mean(rel, axis=0)

    def _diag_pca_prep(self):
        """Scaler/PCA prep shared by the diagnostics (host numpy, float64):
        ``(scaler, pca, npc_used, z (nev, npc_used))``.  The PC count comes
        from the ``_select_npc`` hook, so a BAND head's diagnostics cover
        the PCs it emulates."""
        data = np.asarray(
            self._training_data(np.ones(len(self.model_data), dtype=bool)),
            dtype=np.float64,
        )
        scaler = fit_standard_scaler(data)
        pca = fit_pca(scaler_transform(scaler, data), whiten=True)
        npc_used = self._select_npc(pca)
        z = np.asarray(pca_transform(pca, scaler_transform(scaler, data), npc=npc_used))
        return scaler, pca, npc_used, z

    def outputPCAvsParam(self):
        """Return (design_points, PC scores^T) for diagnostics."""
        _, _, _, z = self._diag_pca_prep()
        return self.design_points, z.T

    def print_learning_curve(self, train_sizes=(0.2, 0.4, 0.6, 0.8, 0.9), n_folds=5):
        """Learning curve per PC: mean train/test R^2 over CV folds at each
        train fraction.

        ``n_folds``-fold CV over a fixed seed-0 permutation; at each
        fraction the GP is refit from scratch (this emulator's kernel,
        alpha and ``gp_maxiter``, on its device) on the leading ``frac``
        share of the fold's training split and scored with R^2 on both
        splits.  Returns a list (one per PC) of arrays (len(train_sizes),
        3) with columns (mean n_train, mean train R^2, mean test R^2).
        """
        _, _, npc_used, z = self._diag_pca_prep()
        design = np.asarray(
            self.PCA_new_design_points if self.parameterTrafoPCA_ else self.design_points,
            dtype=np.float64,
        )
        ptp = (np.asarray(self.design_max) - np.asarray(self.design_min)).astype(self._np_dtype)
        nev = design.shape[0]
        folds = np.array_split(np.random.default_rng(0).permutation(nev), n_folds)
        # before any training there is no gp_config: use the configured
        # kernel family (a BAND head's kernel_kind_, else RBF)
        cfg = getattr(self, "gp_config", None) or self._gp_config(
            getattr(self, "kernel_kind_", "RBF"), self.gp_alpha,
            getattr(self, "gp_grad_precision", "default"),
            getattr(self, "gp_map_prior_strength", 0.0))

        def r2(y_true, y_pred):
            ss_tot = np.sum((y_true - np.mean(y_true)) ** 2)
            if ss_tot == 0.0:  # single-element or constant fold: undefined
                return np.nan
            return 1.0 - np.sum((y_true - y_pred) ** 2) / ss_tot

        train_status = [[] for _ in range(npc_used)]
        for frac in train_sizes:
            tr_scores = np.zeros((npc_used, n_folds))
            te_scores = np.zeros((npc_used, n_folds))
            n_used_folds = []
            for f in range(n_folds):
                test_idx = folds[f]
                train_idx = np.concatenate([folds[g] for g in range(n_folds) if g != f])
                n_used = max(int(np.ceil(frac * len(train_idx))), 2)
                n_used_folds.append(n_used)
                train_idx = train_idx[:n_used]
                x_tr = self._tensor(design[train_idx])
                state = gp_fit(x_tr, self._tensor(z[train_idx].T), ptp, config=cfg,
                               maxiter=self.gp_maxiter)
                with torch.no_grad():
                    pred_tr = gp_predict(state, x_tr, config=cfg)[0].cpu().numpy()
                    pred_te = gp_predict(state, self._tensor(design[test_idx]),
                                         config=cfg)[0].cpu().numpy()
                for i in range(npc_used):
                    tr_scores[i, f] = r2(z[train_idx, i], pred_tr[i])
                    te_scores[i, f] = r2(z[test_idx, i], pred_te[i])
            # folds differ by one event when nev % n_folds != 0: report the
            # mean train size the scores were averaged over
            n_used_mean = float(np.mean(n_used_folds))
            for i in range(npc_used):
                tr, te = float(np.nanmean(tr_scores[i])), float(np.nanmean(te_scores[i]))
                train_status[i].append([n_used_mean, tr, te])
                logger.info("GP %d: %.1f samples, train R^2 %.2f, test R^2 %.2f",
                            i, n_used_mean, tr, te)
        return [np.asarray(s) for s in train_status]

    # ---------------------------------------------------- low-rank structure

    @property
    def has_lowrank_cov(self) -> bool:
        """True when ``cov(x) = cov_trunc + A^T diag(gp_var(x)) A`` with A
        fixed -- the standard PCA mode."""
        return self._trained and not self.perform_no_PCA_ and not self.exp_and_cov_diagonal_

    def lowrank_parts(self):
        """Host arrays (A (npc, nobs), cov_trunc (nobs, nobs))."""
        return self._trans_matrix[: self._npc_used], self._cov_trunc

    def to(self, device) -> "Emulator":
        """A new emulator whose tensors (GP factors, fused-kernel state,
        predict tensors) live on ``device``: copies, or this emulator's own
        where they are already there; host arrays and settings are shared.
        A walker mesh's posterior replica on another card predicts through
        such a copy.  Unlike ``torch.nn.Module.to`` this never moves
        ``self``."""
        new = copy.copy(self)
        device = torch.device(device)
        for name, value in vars(self).items():
            setattr(new, name, to_device(value, device))
        new.device = device
        return new

    # ---------------------------------------------------------- serialization

    @classmethod
    def from_reference(cls, source, *, device=None, dtype=None):
        """Convert a reference dill-saved emulator (or the live object) into
        a port emulator; see :func:`..models.migrate.from_reference`."""
        from .migrate import from_reference

        return from_reference(source, device=device, dtype=dtype)

    def save(self, path):
        """Write the trained emulator in the JAX package's save format."""
        if not self._trained:
            raise RuntimeError("train before saving")
        gs = self.gp_state
        tree = {
            "gp_params": gs.params,
            "gp_x": gs.x,
            "gp_y": gs.y,
            "gp_chol": gs.chol,
            "gp_alpha": gs.alpha_vec,
            "gp_linv": gs.linv,
            "gp_lml": gs.lml,
            "scaler": self.scaler,
            "pca": self.pca,
            "trans_matrix": None if self.perform_no_PCA_ else self._trans_matrix,
            "var_trans": None if self.perform_no_PCA_ else self._var_trans,
            "cov_trunc": None if self.perform_no_PCA_ else self._cov_trunc,
            "param_pca_state": self.param_pca_state,
            "pca_new_design_points": (
                self.PCA_new_design_points if self.parameterTrafoPCA_ else None
            ),
            "design_min": self.design_min,
            "design_max": self.design_max,
            "model_data": self.model_data,
            "model_data_err": self.model_data_err,
            "design_points": self.design_points,
            "design_points_org": self.design_points_org_,
            # a BAND impute head's state: without it a loaded PCGPwM head
            # would retrain as plain PCGP
            "impute_mask": getattr(self, "_impute_mask", None),
            "impute_col_var": getattr(self, "_impute_col_var", None),
        }
        meta = {
            "npc": self.npc,
            "npc_used": self._npc_used,
            "nobs": self.nobs,
            "nev": self.nev,
            "logTrafo": self.logTrafo_,
            "parameterTrafoPCA": self.parameterTrafoPCA_,
            "exp_and_cov_diagonal": self.exp_and_cov_diagonal_,
            "perform_no_PCA": self.perform_no_PCA_,
            "kernel_kind": self.gp_config.kernel.kind,
            "alpha": self.gp_config.alpha,
            "param_pca_groups": [g._asdict() for g in self.param_pca_groups],
            "pardict": self.pardict,
            "gp_alpha": self.gp_alpha,
            # the BAND fields, so that a loaded head retrains as itself
            "method": getattr(self, "method_", None),
            "pc_target_variance": getattr(self, "pc_target_variance", None),
            "map_prior_strength": self.gp_config.map_prior_strength,
            "grad_precision": self.gp_config.grad_precision,
        }
        save_pytree(path, tree, meta)

    @classmethod
    def load(cls, path, *, device=None, dtype=None):
        """Reconstruct a trained emulator from an ``Emulator.save`` file of
        either package (read without importing JAX).  A BAND save (one with
        a ``method`` field) comes back as an ``EmulatorBAND``."""
        tree, meta = load_pytree(path)
        return cls.from_jax_arrays(tree, meta, device=device, dtype=dtype)

    @classmethod
    def from_jax_arrays(cls, tree: dict, meta: dict, *, device=None, dtype=None):
        """Build the port's emulator from the numpy tree and metadata of a
        JAX package save, so both packages compute from the same GP
        factors."""
        if meta.get("method") is not None and cls is Emulator:
            from .emulator_band import EmulatorBAND

            cls = EmulatorBAND
        elif meta.get("method") is None and cls is not Emulator:
            # a BAND shell without method_ would fail only at retrain time
            raise ValueError(
                "this is a plain Emulator save; load it with Emulator.load "
                "(BAND saves carry a 'method' field)"
            )
        if meta["kernel_kind"] not in ("RBF", "Matern", "MaternProd"):
            raise ValueError(f"Unknown kernel type: {meta['kernel_kind']}")
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self._dtype = resolve_dtype(dtype)
        self.logTrafo_ = meta["logTrafo"]
        self.parameterTrafoPCA_ = meta["parameterTrafoPCA"]
        self.exp_and_cov_diagonal_ = meta["exp_and_cov_diagonal"]
        self.perform_no_PCA_ = meta["perform_no_PCA"]
        self.npc = meta["npc"]
        self._npc_used = meta["npc_used"]
        self.nobs = meta["nobs"]
        self.nev = meta["nev"]
        self.nrestarts = 0
        self.seed = 0
        self.gp_maxiter = 200
        self.gp_alpha = meta.get("gp_alpha", meta["alpha"])
        self.pardict = meta["pardict"]
        t = self._tensor
        chol = np.asarray(tree["gp_chol"])
        if "gp_linv" in tree:
            linv = np.asarray(tree["gp_linv"])
        else:  # legacy save files stored no explicit factor
            linv = np.stack([
                np.linalg.solve(np.asarray(c, np.float64), np.eye(c.shape[0]))
                for c in chol
            ])
        self.gp_state = GPState(
            params={k: t(v) for k, v in tree["gp_params"].items()},
            x=t(tree["gp_x"]), y=t(tree["gp_y"]), chol=t(chol),
            alpha_vec=t(tree["gp_alpha"]), linv=t(linv), lml=t(tree["gp_lml"]),
        )
        self.gp_grad_precision = meta.get("grad_precision", "default")
        self.gp_map_prior_strength = meta.get("map_prior_strength", 0.0)
        self.gp_config = cls._gp_config(meta["kernel_kind"], meta["alpha"],
                                        self.gp_grad_precision,
                                        self.gp_map_prior_strength)
        self.scaler = _scaler_state(tree["scaler"])
        self.pca = None if tree["pca"] is None else _pca_state(tree["pca"])
        self.param_pca_groups = [ParamPCAGroup(**g) for g in meta["param_pca_groups"]]
        pp = tree["param_pca_state"]
        self.param_pca_state = None if pp is None else ParamPCAState(
            scalers=tuple(_scaler_state(sc) for sc in pp[0]),
            pcas=tuple(_pca_state(p) for p in pp[1]),
            npcs=tuple(int(n) for n in pp[2]),
        )
        if not self.perform_no_PCA_:
            self._trans_matrix = np.asarray(tree["trans_matrix"], dtype=self._np_dtype)
            self._var_trans = np.asarray(tree["var_trans"], dtype=self._np_dtype)
            self._cov_trunc = np.asarray(tree["cov_trunc"], dtype=self._np_dtype)
        self.design_min = np.asarray(tree["design_min"])
        self.design_max = np.asarray(tree["design_max"])
        self.model_data = np.asarray(tree["model_data"])
        self.model_data_err = np.asarray(tree["model_data_err"])
        self.design_points = np.asarray(tree["design_points"])
        self.design_points_org_ = np.asarray(tree["design_points_org"])
        if self.parameterTrafoPCA_:
            pnd = tree.get("pca_new_design_points")
            # legacy save files: the masked training design (best effort)
            self.PCA_new_design_points = np.asarray(
                pnd if pnd is not None else tree["gp_x"])
        self._load_subclass_fields(tree, meta)
        self._trained = True
        self._build_predict_state()
        return self

    def _load_subclass_fields(self, tree: dict, meta: dict) -> None:
        """Restore a subclass's own saved fields (the BAND head's)."""


def _scaler_state(t) -> StandardScalerState:
    """A saved scaler (the class or a plain tuple) with numpy leaves."""
    return StandardScalerState(*(np.asarray(a) for a in t))


def _pca_state(t) -> PCAState:
    return PCAState(
        mean=np.asarray(t[0]), components=np.asarray(t[1]),
        explained_variance=np.asarray(t[2]),
        explained_variance_ratio=np.asarray(t[3]), whiten=bool(t[4]),
    )
