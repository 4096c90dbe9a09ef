"""PCGP / PCSK / PCGPwImpute / PCGPwM emulator heads (PyTorch port of the
JAX package's ``models/emulator_band.py``).

The surmise methods on the same batched-GP core as the sklearn head:

- **PCGP**: PCA-projected GP -- standardize, whitened PCA keeping enough
  components for ``target_variance`` of the variance, one GP per kept PC,
  truncation covariance for the rest.
- **PCSK**: PCGP with stochastic-kriging known simulation noise: the
  per-observable, per-design stat errors are propagated through the
  standardization and the PCA weights into per-(PC, design) noise
  variances added to each GP's Gram diagonal.
- **PCGPwImpute**: missing observables (NaN) are filled by iterative
  low-rank SVD imputation before PCGP training, per fit on the training
  subset.
- **PCGPwM**: imputation plus per-(PC, design) GP noise inflation by the
  imputation uncertainty (the per-column SVD reconstruction residual
  variance propagated through the PCA weights).
- unknown methods raise ``ValueError``.

``predict`` keeps the fixed-basis low-rank covariance, so ``Chain``'s
Woodbury path applies to these heads unchanged; a float32 RBF or Matern-1.5
head (the default kernel) runs the fused predict kernels there, the
per-design noise entering through the factor ``L^-1`` and ``K^-1 y``; a
MaternProd head takes the plain ``gp_predict``.
"""

from __future__ import annotations

import logging
from typing import Sequence

import numpy as np

from ..ops.scalers import n_components_for_variance
from .emulator import Emulator
from .param_pca import ParamPCAGroup

logger = logging.getLogger(__name__)

_METHODS = ("PCGP", "PCSK", "PCGPwImpute", "PCGPwM")


def _impute_iterative_svd(data: np.ndarray, rank: int | None = None, iters: int = 20):
    """Fill NaNs by iterative low-rank SVD reconstruction.

    Returns ``(filled, mask, col_resid_var)`` where ``col_resid_var`` is the
    per-column reconstruction residual variance on observed entries -- the
    uncertainty estimate for the imputed values."""
    mask = np.isnan(data)
    if not mask.any():
        return data, mask, np.zeros(data.shape[1])
    all_missing = mask.all(axis=0)
    if all_missing.any():
        raise ValueError(
            "imputation needs at least one observed value per observable: "
            f"column(s) {np.flatnonzero(all_missing).tolist()} are NaN for "
            "every event"
        )
    filled = data.copy()
    col_mean = np.nanmean(data, axis=0)
    filled[mask] = np.take(col_mean, np.where(mask)[1])
    r = rank or min(10, min(data.shape) - 1)
    recon = filled
    for _ in range(iters):
        mean = filled.mean(axis=0)
        u, s, vt = np.linalg.svd(filled - mean, full_matrices=False)
        recon = (u[:, :r] * s[:r]) @ vt[:r] + mean
        prev = filled[mask]
        filled[mask] = recon[mask]
        if np.max(np.abs(prev - filled[mask])) < 1e-10:
            break
    resid = np.where(mask, 0.0, data - recon)
    nobs_col = np.maximum((~mask).sum(axis=0), 1)
    col_resid_var = np.where(mask.any(axis=0), (resid**2).sum(axis=0) / nobs_col, 0.0)
    return filled, mask, col_resid_var


class EmulatorBAND(Emulator):
    """Multidimensional GP emulator with surmise-method heads.

    ``kernel_kind``: the per-PC GP covariance, "Matern" (ARD Matern-1.5,
    the default), "MaternProd" (surmise's separable product-Matern) or
    "RBF"; the fused predict kernels compute "Matern" and "RBF".
    ``map_prior_strength`` > 0 fits the hyperparameters by MAP instead of
    maximum likelihood.  ``device`` and ``dtype`` as for :class:`Emulator`.
    """

    def __init__(
        self,
        training_set_path: str = ".",
        parameter_file: str = "ABCD.txt",
        method: str = "PCGP",
        logTrafo: bool = False,
        parameterTrafoPCA: bool = False,
        max_rel_uncertainty_data: float = 0.1,
        exp_and_cov_diagonal: bool = False,
        param_pca_groups: Sequence[ParamPCAGroup] | None = None,
        target_variance: float = 0.99,
        nrestarts: int = 0,
        seed: int = 0,
        gp_maxiter: int = 200,
        kernel_kind: str = "Matern",
        map_prior_strength: float = 0.0,
        device=None,
        dtype=None,
    ):
        if method not in _METHODS:
            raise ValueError(f"Requested method not implemented: {method}")
        if kernel_kind not in ("RBF", "Matern", "MaternProd"):
            raise ValueError(f"Unknown kernel kind: {kernel_kind}")
        self.method_ = method
        self.kernel_kind_ = kernel_kind
        self.gp_map_prior_strength = float(map_prior_strength)
        self.pc_target_variance = target_variance
        super().__init__(
            training_set_path=training_set_path,
            parameter_file=parameter_file,
            npc=10**9,  # resolved by the variance threshold at train time
            nrestarts=nrestarts,
            logTrafo=logTrafo,
            parameterTrafoPCA=parameterTrafoPCA,
            max_rel_uncertainty_data=max_rel_uncertainty_data,
            exp_and_cov_diagonal=exp_and_cov_diagonal,
            perform_no_PCA=False,
            param_pca_groups=param_pca_groups,
            seed=seed,
            gp_maxiter=gp_maxiter,
            device=device,
            dtype=dtype,
        )
        # small jitter instead of sklearn's alpha=0.1: PCSK carries the real
        # noise explicitly and PCGP learns its white level
        self.gp_alpha = 1e-6
        self._impute_mask = None
        self._impute_col_var = None
        # under parameter-space PCA this is the transformed dimension
        self.nparameters = (
            self.PCA_new_design_points.shape[1] if self.parameterTrafoPCA_
            else self.design_points.shape[1]
        )
        if method in ("PCGPwImpute", "PCGPwM"):
            # record where data is missing but keep the NaNs in model_data:
            # imputation runs per fit on the masked subset (_training_data),
            # so holdout rows never leak into it
            self._impute_mask = np.isnan(np.asarray(self.model_data, dtype=np.float64))

    # ---------------------------------------------------------------- hooks

    def _select_npc(self, pca) -> int:
        npc = n_components_for_variance(pca, self.pc_target_variance)
        logger.info("%s keeps %d PCs for %.1f%% of variance",
                    self.method_, npc, self.pc_target_variance * 100)
        return npc

    def _pc_noise_diag(self, eventMask, npc_used):
        """(npc_used, nev) PC-space noise variances on the emulator's device
        and in its dtype (computed on the host in float64), or None."""
        mask = np.asarray(eventMask, dtype=bool)
        if self.method_ == "PCSK":
            # standardized stat errors -> PC-space variances:
            # var_z[k, i] = sum_j (W_kj sigma_std_ij)^2 with the whitened
            # projection weights W_kj = components_kj / sqrt(ev_k)
            err_var = np.asarray(self.model_data_err[mask, :], np.float64) ** 2
        elif (self.method_ == "PCGPwM" and self._impute_mask is not None
              and self._impute_col_var is not None):
            # imputed entries carry the per-column SVD reconstruction
            # residual variance as known noise (col_var is set by the per-fit
            # imputation; a dataset with no missing entries never sets it)
            err_var = np.where(self._impute_mask[mask, :], self._impute_col_var[None, :], 0.0)
        else:
            return None
        var_std = err_var / np.asarray(self.scaler.scale, np.float64) ** 2
        w = np.asarray(self.pca.components[:npc_used], np.float64) / np.sqrt(
            np.asarray(self.pca.explained_variance[:npc_used], np.float64)
        )[:, None]
        return self._tensor((var_std @ (w**2).T).T)

    def _training_data(self, eventMask):
        """Per-fit SVD imputation on exactly the masked subset.  A save whose
        model_data was imputed already has no NaNs left, so the fill is
        skipped and the loaded ``_impute_col_var`` keeps serving PCGPwM."""
        if self.method_ in ("PCGPwImpute", "PCGPwM"):
            raw = np.asarray(self.model_data, dtype=np.float64)[np.asarray(eventMask, dtype=bool)]
            if np.isnan(raw).any():
                filled, _, self._impute_col_var = _impute_iterative_svd(raw)
                return filled
        return super()._training_data(eventMask)

    def _load_subclass_fields(self, tree: dict, meta: dict) -> None:
        self.method_ = meta["method"]
        self.pc_target_variance = meta.get("pc_target_variance", 0.99)
        self.kernel_kind_ = meta["kernel_kind"]
        im, icv = tree.get("impute_mask"), tree.get("impute_col_var")
        self._impute_mask = None if im is None else np.asarray(im, bool)
        self._impute_col_var = None if icv is None else np.asarray(icv, np.float64)
        self.nparameters = (
            self.PCA_new_design_points.shape[1] if self.parameterTrafoPCA_
            else self.design_points.shape[1]
        )

    # ---------------------------------------------------------------- train

    def trainEmulator(self, event_mask, kernel_type: str | None = None):
        super().trainEmulator(event_mask, kernel_type=kernel_type or self.kernel_kind_)

    # ------------------------------------------------------------- predict

    def predict_test_emu_errors(self, X, theta):
        """Surmise-layout predict: (mean (nobs, m), cov (m, nobs, nobs)).
        ``X`` (surmise's observable-index grid) is ignored."""
        mean, cov = self.predict(theta, return_cov=True)
        return mean.T, cov

    # ---------------------------------------------------------- validation

    def testEmulatorErrors(self, number_test_points: int = 1):
        return super().testEmulatorErrors(nTestPoints=number_test_points,
                                          kernel_type=self.kernel_kind_)

    def testEmulatorErrorsWithTrainingPoints(self, number_test_points: int = 1):
        return super().testEmulatorErrorsWithTrainingPoints(
            nTestPoints=number_test_points, kernel_type=self.kernel_kind_)
