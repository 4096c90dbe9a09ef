"""Bayesian calibration driver: box prior, PC-space Woodbury likelihood, HMC.

PyTorch port of the main path of the JAX package's ``samplers/chain.py``:

- uniform box prior normalized by the prior volume; outside-box points get
  ``-inf``, or the widest finite value of the working dtype with
  ``finite=True``;
- the vestigial ``extra_std`` term: its prior reduces to the constant
  ``2 log(1e-16)``, still added for parity with reference chain values;
- per-emulator likelihood blocks over the diagonal experimental
  covariance.  For PCA emulators (the flagship) that is the exact PC-space
  Woodbury block (:func:`make_lowrank_block`);
- chain pickle contract ``{"chain": (nwalkers, nsteps, ndim)}``.

Not ported yet (they raise ``NotImplementedError``): the diagonal,
per-block Cholesky and stitched likelihood blocks (needed for no-PCA or
``exp_and_cov_diagonal`` emulators, a dense experimental covariance, or
``likelihood_mode`` other than ``"auto"``), the ensemble, PTLMC and SMC
samplers, and HMC ``resume``/``warm_start``/``n_leapfrog="auto"``/device
meshes (see ROADMAP.md).
"""

from __future__ import annotations

import logging
import pickle
from pathlib import Path

import numpy as np
import torch

from ..config import resolve_device, resolve_dtype
from ..ops.linalg import spd_qform_logdet
from ..runtime import parse_model_parameter_file
from ..utils.io import load_exp_data_pickle

logger = logging.getLogger(__name__)

# 2*log(1e-16): the constant the reference's zeroed extra_std prior adds.
_EXTRA_STD_CONST = 2.0 * np.log(1e-16)


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (see ROADMAP.md); "
        "the JAX package gpbayestools_hic_tpu has it"
    )


def make_lowrank_block(e, exp_mean: np.ndarray, exp_var: np.ndarray,
                       dtype: torch.dtype, device: torch.device):
    """PC-space Woodbury likelihood of one PCA emulator (exact).

    With ``cov(x) = C0' + A^T diag(v) A`` (``C0' = cov_trunc + diag(exp
    var)``, A fixed) and ``mean(x) = gp_mean @ A + shift``, the likelihood
    collapses into PC space: expanding around ``p0``, the C0'^-1-metric
    projection of the data residual onto rowspace(A), with ``d = gp_mean -
    p0`` and ``M = A C0'^-1 A^T``::

        y C0'^-1 y^T = d M d^T + const2,    u = y C0'^-1 A^T = d M

    and Woodbury + the matrix-determinant lemma give the exact
    log-likelihood from an (npc, npc) capacitance per walker.

    Returns ``(block_ll(bs, x_safe) -> (m,), bs)``.
    """
    a_mat, cov_trunc = e.lowrank_parts()
    a64 = np.asarray(a_mat, dtype=np.float64)
    c0 = np.asarray(cov_trunc, dtype=np.float64) + np.diag(exp_var.astype(np.float64))
    c0_chol = np.linalg.cholesky(c0)
    logdet_c0 = 2.0 * np.sum(np.log(np.diag(c0_chol)))
    c0_inv = np.linalg.inv(c0)
    g = a64 @ c0_inv                     # (npc, n)
    m_mat = g @ a64.T                    # (npc, npc)
    npc = a64.shape[0]
    shift = np.asarray(e.scaler.mean, dtype=np.float64)
    r0 = shift - exp_mean.astype(np.float64)
    p0 = -np.linalg.solve(m_mat, g @ r0)
    r_perp = r0 + p0 @ a64
    const2 = float(r_perp @ c0_inv @ r_perp)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    bs = {
        "p0": t(p0), "m": t(m_mat), "const2": t(const2),
        "logdet_c0": t(logdet_c0), "eye_npc": t(np.eye(npc)),
    }

    def block_ll(bs, x_safe):
        gp_mean, v = e.predict_pc_raw_fastgrad(x_safe)     # (m, npc) x2
        d = gp_mean - bs["p0"]
        u = d @ bs["m"]
        q0 = (d * u).sum(1) + bs["const2"]
        # floor strictly above 0: d/dv sqrt(v) at the clamp is +inf, so an
        # f32 PC variance that cancels to <= 0 would put NaN in gradients
        sv = torch.sqrt(torch.clamp(v, min=1e-22))
        s = bs["eye_npc"] + sv[:, :, None] * bs["m"] * sv[:, None, :]
        corr, logdet_s = spd_qform_logdet(s, sv * u)
        lp = -0.5 * (q0 - corr) - 0.5 * (bs["logdet_c0"] + logdet_s)
        return torch.where(torch.isfinite(lp), lp, torch.full_like(lp, -torch.inf))

    return block_ll, bs


class Chain:
    """High-level interface for running MCMC calibration and accessing results."""

    def __init__(
        self,
        mcmc_path: str = "./mcmc/chain.pkl",
        expdata_path: str = "./exp_data.dat",
        model_parafile: str = "./model.dat",
        *,
        device=None,
        dtype=None,
    ):
        logger.info("Initializing MCMC ...")
        self.device = resolve_device(device)
        self._dtype = resolve_dtype(dtype)
        self.mcmc_path = Path(mcmc_path)
        self.mcmc_path.parent.mkdir(parents=True, exist_ok=True)

        self.pardict = parse_model_parameter_file(model_parafile)
        self.ndim = len(self.pardict)
        self.label = [v[0] for v in self.pardict.values()]
        self.min = np.array([v[1] for v in self.pardict.values()])
        self.max = np.array([v[2] for v in self.pardict.values()])
        bad = [name for name, v in self.pardict.items() if v[2] <= v[1]]
        if bad:
            raise ValueError(
                f"parameter range(s) with max <= min in {model_parafile}: {bad}"
            )
        self.prior_volume_ = float(np.prod(self.max - self.min))

        logger.info("Loading the experiment data from %s ...", expdata_path)
        self.expdata, self.expdata_cov = load_exp_data_pickle(expdata_path)
        self.nobs = self.expdata.shape[1]
        self.emuList: list = []
        self.chain = False
        self._device_fns = None
        self.likelihood_mode = "auto"

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=self._dtype, device=self.device)

    # ------------------------------------------------------------- emulators

    def loadEmulator(self, emulatorPathList):
        """Load trained emulators: paths to JAX package ``Emulator.save``
        files, or live port emulators on this chain's device and dtype."""
        from ..models.emulator import Emulator

        for emu in emulatorPathList:
            if isinstance(emu, (str, Path)):
                emu = Emulator.load(emu, device=self.device, dtype=self._dtype)
            elif not isinstance(emu, Emulator):
                raise TypeError(
                    f"loadEmulator takes save-file paths or port Emulators, "
                    f"got {type(emu).__name__}"
                )
            elif emu.device != self.device or emu._dtype != self._dtype:
                raise ValueError(
                    f"emulator lives on {emu.device}/{emu._dtype}, the chain "
                    f"on {self.device}/{self._dtype}"
                )
            self.emuList.append(emu)
        logger.info("Number of Emulators: %d", len(self.emuList))
        self._device_fns = None

    # ------------------------------------------------------------ device path

    def _build_device_fns(self):
        """Assemble the log-likelihood / log-posterior functions."""
        if not self.emuList:
            raise RuntimeError("loadEmulator before evaluating the posterior")
        if self.likelihood_mode != "auto":
            raise _not_ported(f"likelihood_mode={self.likelihood_mode!r}")
        dtype = self._dtype
        expdata_np = np.asarray(self.expdata, dtype=np.float64).flatten()
        expcov_np = np.asarray(self.expdata_cov, dtype=np.float64)
        nobs = self.nobs
        emus = list(self.emuList)
        offsets = np.cumsum([0] + [e.nobs for e in emus])
        if offsets[-1] != nobs:
            raise ValueError(
                f"emulators predict {offsets[-1]} observables, experimental "
                f"data has {nobs}"
            )
        off = expcov_np - np.diag(np.diagonal(expcov_np))
        if not bool(np.all(off == 0.0)):
            raise _not_ported("a dense experimental covariance (stitched likelihood)")
        exp_var_np = np.diagonal(expcov_np)

        block_fns, block_states = [], []
        for e, i0, i1 in zip(emus, offsets[:-1], offsets[1:]):
            if not e.has_lowrank_cov:
                raise _not_ported(
                    "the diagonal / Cholesky likelihood blocks (no-PCA or "
                    "exp_and_cov_diagonal emulators)"
                )
            fn, bs = make_lowrank_block(
                e, expdata_np[i0:i1], exp_var_np[i0:i1], dtype, self.device
            )
            block_fns.append(fn)
            block_states.append(bs)

        self._like_state = {
            "lo": self._tensor(self.min),
            "hi": self._tensor(self.max),
            "blocks": tuple(block_states),
        }

        def model_predict(state, x, extra_std):
            """(m, ndim) -> mean (m, nobs), block-diagonal cov (m, nobs, nobs).

            ``extra_std`` (scalar or (m,)) is multiplied by each sample's
            LAST parameter column and added to every emulator's predictive
            PC standard deviation, as the reference's ``_predict`` does."""
            m = x.shape[0]
            extra = extra_std * x[:, -1]
            mean = torch.zeros((m, nobs), dtype=dtype, device=x.device)
            cov = torch.zeros((m, nobs, nobs), dtype=dtype, device=x.device)
            for e, i0, i1 in zip(emus, offsets[:-1], offsets[1:]):
                mu_i, cov_i = e._predict_full(x, extra)
                mean[:, i0:i1] = mu_i
                cov[:, i0:i1, i0:i1] = cov_i
            return mean, cov

        def loglike_core(state, x):
            x_safe = torch.clamp(x, state["lo"], state["hi"])
            ll = torch.zeros((x.shape[0],), dtype=dtype, device=x.device)
            for fn, bs in zip(block_fns, state["blocks"]):
                ll = ll + fn(bs, x_safe)
            return ll + _EXTRA_STD_CONST

        # the reference's finite floor is -1e300, which overflows float32;
        # use the widest finite value the working dtype holds instead
        finite_floor = -1e300 if dtype == torch.float64 else float(torch.finfo(dtype).min) / 2

        def inside_box(state, x):
            return ((x > state["lo"]) & (x < state["hi"])).all(1)

        def log_likelihood(state, x, finite=False):
            ll = loglike_core(state, x)
            outside = torch.full_like(ll, finite_floor if finite else -torch.inf)
            return torch.where(inside_box(state, x), ll, outside)

        def log_posterior(state, x):
            ll = loglike_core(state, x)
            return torch.where(inside_box(state, x), ll, torch.full_like(ll, -torch.inf))

        self._device_fns = {
            "log_likelihood": log_likelihood,
            "log_posterior": log_posterior,
            "model_predict": model_predict,
        }
        return self._device_fns

    @property
    def device_fns(self):
        if self._device_fns is None:
            self._build_device_fns()
        return self._device_fns

    def posterior_with_state(self):
        """(pure_fn, state) pair for samplers: ``pure_fn(state, x) -> (m,)``."""
        fns = self.device_fns
        return fns["log_posterior"], self._like_state

    # --------------------------------------------------------- numpy-facing

    def _as_x(self, X) -> torch.Tensor:
        return self._tensor(np.atleast_2d(np.asarray(X, dtype=np.float64)))

    def _predict(self, X, extra_std=0.0):
        """Concatenated emulator predictions, (mean (m, nobs), cov (m, nobs, nobs))."""
        x = self._as_x(X)
        extra = np.asarray(extra_std, dtype=np.float64)
        if extra.ndim > 1 or (extra.ndim == 1 and extra.shape[0] != x.shape[0]):
            raise ValueError(
                f"extra_std must be a scalar or length-{x.shape[0]} array, "
                f"got shape {extra.shape}"
            )
        with torch.no_grad():
            mean, cov = self.device_fns["model_predict"](
                self._like_state, x, self._tensor(extra)
            )
        return mean.cpu().numpy(), cov.cpu().numpy()

    def log_prior(self, X):
        X = np.atleast_2d(np.asarray(X, dtype=float))
        lp = np.full(X.shape[0], -np.inf)
        inside = np.all((X > self.min) & (X < self.max), axis=1)
        lp[inside] = np.log(1.0 / self.prior_volume_)
        return lp

    def log_likelihood(self, X, extra_std_prior_scale: float = 0.001, finite: bool = False):
        with torch.no_grad():
            out = self.device_fns["log_likelihood"](self._like_state, self._as_x(X), finite)
        return out.cpu().numpy()

    def log_posterior(self, X, extra_std_prior_scale: float = 0.05):
        with torch.no_grad():
            out = self.device_fns["log_posterior"](self._like_state, self._as_x(X))
        return out.cpu().numpy()

    def random_pos(self, n: int = 1, seed=None):
        rng = np.random.default_rng(seed)
        return rng.uniform(self.min, self.max, (n, self.ndim))

    # ------------------------------------------------------------ chain file

    def _append_and_write_chain(self, chain_data, res_chain, nthin):
        thinned = np.asarray(res_chain)[:, ::nthin, :]
        if "chain" in chain_data:
            chain_data["chain"] = np.concatenate((chain_data["chain"], thinned), axis=1)
        else:
            chain_data["chain"] = thinned
        self.chain = chain_data["chain"]
        logger.info("writing chain to file")
        with open(self.mcmc_path, "wb") as f:
            pickle.dump(chain_data, f)

    def convergence_report(self, rhat_threshold: float = 1.01) -> dict:
        """Rank-normalized split-R-hat, integrated autocorrelation times and
        ESS of the stored walker chain."""
        from ..utils.metrics import convergence_diagnostics

        if self.chain is False:
            with open(self.mcmc_path, "rb") as f:
                self.chain = pickle.load(f)["chain"]
        arr = np.asarray(self.chain)
        if arr.ndim != 3:
            raise ValueError(
                f"convergence_report needs a (nwalkers, nsteps, ndim) chain, "
                f"got shape {arr.shape}"
            )
        rep = convergence_diagnostics(arr, rhat_threshold=rhat_threshold)
        logger.info(
            "Convergence: max rhat %.4f, max tau %.1f, ESS %.0f, %s",
            float(np.max(rep["rhat"])), float(np.nanmax(rep["tau"])), rep["ess"],
            "CONVERGED" if rep["converged"] else "NOT CONVERGED",
        )
        return rep

    # ----------------------------------------------------------------- HMC

    def run_MCMC_HMC(
        self,
        nsteps: int = 500,
        nwalkers: int = 256,
        nburnsteps: int | str = "auto",
        n_leapfrog: int | None = None,
        nthin: int = 1,
        seed: int = 0,
        target_accept: float = 0.8,
        traj_jitter: int = 1,
        devices: int | None = None,
        mesh=None,
        resume: bool = False,
        warm_start=None,
        scheme: str = "auto",
        window: int | None = None,
        persist: float = 0.0,
        warmup_walkers: int | str | None = "auto",
    ):
        """Preconditioned Hamiltonian MC over the differentiable posterior.

        Same knobs and defaults as the JAX package: ``nburnsteps`` is the
        per-phase warmup length (``"auto"``: each adaptation phase stops
        itself once the step size has settled with acceptance on target),
        ``n_leapfrog=None`` means 8, ``scheme="auto"`` picks windowed HMC
        with persistent momentum at adapted acceptance >= 0.75 and endpoint
        MH otherwise, ``warmup_walkers="auto"`` adapts on
        ``min(256, nwalkers)`` walkers.  Writes ``{"chain": (nwalkers,
        ceil(nsteps/nthin), ndim)}`` to ``mcmc_path``.
        """
        from .hmc import run_hmc

        if devices is not None or mesh is not None:
            raise _not_ported("multi-device HMC (devices=/mesh=)")
        if resume or warm_start is not None:
            raise _not_ported("HMC resume / warm_start")
        if n_leapfrog is None:
            n_leapfrog = 8
        if isinstance(n_leapfrog, str):
            raise _not_ported('n_leapfrog="auto"')
        logger.info("Starting HMC ...")
        log_post, like_state = self.posterior_with_state()
        x0 = self.random_pos(nwalkers, seed=seed)
        if isinstance(warmup_walkers, str):
            if warmup_walkers != "auto":
                raise ValueError(
                    f"warmup_walkers must be an int, None, or 'auto', "
                    f"got {warmup_walkers!r}"
                )
            warmup_walkers = min(256, nwalkers)
        res = run_hmc(
            log_post, x0, nsteps, seed,
            state=like_state, lo=self.min, hi=self.max,
            n_leapfrog=n_leapfrog, warmup=nburnsteps,
            target_accept=target_accept, traj_jitter=traj_jitter,
            scheme=scheme, window=window, persist=persist,
            warmup_walkers=warmup_walkers, device=self.device, dtype=self._dtype,
        )
        logger.info(
            "HMC: step size %.4f, n_leapfrog %d, mean accept %.3f",
            res.step_size, res.n_leapfrog, float(np.mean(res.acceptance)),
        )
        self._append_and_write_chain({}, res.chain, nthin)
        return res
