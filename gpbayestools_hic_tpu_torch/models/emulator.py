"""PCA-projected multi-output GP emulator (PyTorch port of ``models/emulator.py``).

Training data are standardized, projected through whitened full-SVD PCA,
and the first ``npc`` PCs are each emulated by an independent GP (one
batched :class:`..models.gp.GPState`).  ``predict`` runs the batched GP
posterior, the inverse PCA transform and the linear uncertainty
propagation on the emulator's device.

Reference quirks preserved as in the JAX package: truncation covariance
for neglected PCs with the ``1e-4 * scaler.var_`` diagonal stabilizer; the
predictive covariance includes the white-noise level but not alpha;
``exp_and_cov_diagonal`` exponentiates the mean and rebuilds a diagonal
covariance ``(fstd * mean)^2``.

Not ported yet (they raise ``NotImplementedError``): parameter-space PCA
(``parameterTrafoPCA=True``), BAND save files, ``sample_y``, and training
with ``gp_maxiter > 0`` (see ROADMAP.md).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..config import resolve_device, resolve_dtype
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
from ..utils.io import load_pytree, load_training_pickle
from .gp import GPConfig, GPState, gp_fit, gp_predict

logger = logging.getLogger(__name__)


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (see ROADMAP.md, "
        "'Modules to port'); the JAX package gpbayestools_hic_tpu has it"
    )


class Emulator:
    """Multidimensional GP emulator with optional PCA projection.

    Constructor signature mirrors the JAX package plus ``device`` (default
    CUDA; pass ``"cpu"`` for the plain host path) and ``dtype`` (default
    float32).  As there, set ``gp_grad_precision`` (``"default"``,
    ``"high"`` or ``"highest"``) on the instance before training to choose
    the fused predict's backward kernel; a loaded save file carries its own.
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
        seed: int = 0,
        gp_maxiter: int = 200,
        device=None,
        dtype=None,
    ):
        if parameterTrafoPCA:
            raise _not_ported("parameterTrafoPCA=True (models/param_pca.py)")
        self.device = resolve_device(device)
        self._dtype = resolve_dtype(dtype)
        self.gp_maxiter = gp_maxiter
        self.logTrafo_ = logTrafo
        self.parameterTrafoPCA_ = False
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
        self._trained = False

    # ------------------------------------------------------------------ train

    @property
    def _np_dtype(self):
        return np.float64 if self._dtype == torch.float64 else np.float32

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=self._dtype, device=self.device)

    def trainEmulatorAutoMask(self):
        self.trainEmulator(np.ones(self.nev, dtype=bool))

    def _prepare_training(self, eventMask, kernel_type: str):
        """Fit scaler/PCA on the host, build GP targets.

        Returns ``(design (nev, d) tensor, z_t (npc_used, nev) tensor, ptp
        (d,) numpy)``; sets scaler/pca/_npc_used/gp_config.
        """
        if kernel_type not in ("RBF", "Matern"):
            raise ValueError(f"Unknown kernel type: {kernel_type}")
        eventMask = np.asarray(eventMask, dtype=bool)
        data = np.asarray(self.model_data[eventMask, :], dtype=self._np_dtype)

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
            npc_used = min(self.npc, self.pca.components.shape[0])
            z = pca_transform(self.pca, standardized, npc=npc_used)
            logger.info(
                "%d PCs explain %.5f of variance", npc_used,
                float(np.sum(self.pca.explained_variance_ratio[:npc_used])),
            )
        self._npc_used = npc_used
        design = self._tensor(self.design_points[eventMask, :])
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
            kernel_type, self.gp_alpha, self.gp_grad_precision)
        return design, self._tensor(np.asarray(z).T), ptp.astype(self._np_dtype)

    @staticmethod
    def _gp_config(kernel_kind: str, alpha: float, grad_precision: str) -> GPConfig:
        backward_kernel(grad_precision)  # an unknown value raises
        return GPConfig(kernel=KernelConfig(kernel_kind), alpha=alpha,
                        grad_precision=grad_precision)

    def trainEmulator(self, eventMask, kernel_type: str = "RBF"):
        """Train on the masked subset of events."""
        design, z_t, ptp = self._prepare_training(eventMask, kernel_type)
        logger.info("Train GP emulators with %d training points ...", design.shape[0])
        gp_state = gp_fit(design, z_t, ptp, config=self.gp_config,
                          nrestarts=self.nrestarts, maxiter=self.gp_maxiter)
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
        gs = self.gp_state
        self._fused = (
            build_fused_state(gs.params, gs.x, gs.linv, gs.alpha_vec)
            if fused_eligible(self.gp_config.kernel.kind, gs.x.shape[1], self._dtype) else None
        )

    def _predict_full(self, x: torch.Tensor, extra_std: torch.Tensor):
        """(m, d) -> mean (m, nobs), covariance (m, nobs, nobs)."""
        gp_mean, gp_var = gp_predict(self.gp_state, x, config=self.gp_config)
        gp_mean = gp_mean.T
        gp_var = gp_var.T + extra_std[:, None] ** 2
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
        if fast_grad and self._fused is not None:
            # fused kernel (float32 RBF): k* build, mean and the variance
            # quadratic form in one pass; same max(kdiag - q, 0) epilogue
            gp_mean, qform = fused_pc_predict(
                self._fused, x, self.gp_config.grad_precision)     # (m, npc)
            gp_var = torch.clamp(self._fused.kdiag[None, :] - qform, min=0.0)
        else:
            gp_mean, gp_var = gp_predict(self.gp_state, x, config=self.gp_config,
                                         fast_grad=fast_grad)
            gp_mean, gp_var = gp_mean.T, gp_var.T
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
        (the fused kernels for a float32 RBF emulator).  Reverse mode only."""
        return self._pc_core(x, fast_grad=True, raw=True)

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

    def sample_y(self, X, n_samples: int = 1, random_state=None):
        raise _not_ported("Emulator.sample_y")

    # ---------------------------------------------------- low-rank structure

    @property
    def has_lowrank_cov(self) -> bool:
        """True when ``cov(x) = cov_trunc + A^T diag(gp_var(x)) A`` with A
        fixed -- the standard PCA mode."""
        return self._trained and not self.perform_no_PCA_ and not self.exp_and_cov_diagonal_

    def lowrank_parts(self):
        """Host arrays (A (npc, nobs), cov_trunc (nobs, nobs))."""
        return self._trans_matrix[: self._npc_used], self._cov_trunc

    # ---------------------------------------------------------- serialization

    @classmethod
    def load(cls, path, *, device=None, dtype=None):
        """Reconstruct a trained emulator from a JAX package ``Emulator.save``
        file (read without importing JAX)."""
        tree, meta = load_pytree(path)
        return cls.from_jax_arrays(tree, meta, device=device, dtype=dtype)

    @classmethod
    def from_jax_arrays(cls, tree: dict, meta: dict, *, device=None, dtype=None):
        """Build the port's emulator from the numpy tree and metadata of a
        JAX package save, so both packages compute from the same GP
        factors."""
        if meta.get("method") is not None:
            raise _not_ported("EmulatorBAND (BAND save files)")
        if meta["parameterTrafoPCA"]:
            raise _not_ported("parameterTrafoPCA=True (models/param_pca.py)")
        if meta["kernel_kind"] not in ("RBF", "Matern"):
            raise _not_ported(f"kernel kind {meta['kernel_kind']!r}")
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self._dtype = resolve_dtype(dtype)
        self.logTrafo_ = meta["logTrafo"]
        self.parameterTrafoPCA_ = False
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
        self.gp_config = cls._gp_config(meta["kernel_kind"], meta["alpha"],
                                        self.gp_grad_precision)
        self.scaler = StandardScalerState(*(np.asarray(a) for a in tree["scaler"]))
        pca = tree["pca"]
        self.pca = None if pca is None else PCAState(
            mean=np.asarray(pca[0]), components=np.asarray(pca[1]),
            explained_variance=np.asarray(pca[2]),
            explained_variance_ratio=np.asarray(pca[3]), whiten=bool(pca[4]),
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
        self._trained = True
        self._build_predict_state()
        return self
