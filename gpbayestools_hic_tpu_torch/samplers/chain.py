"""Bayesian calibration: priors, likelihood, MCMC front-ends.

PyTorch port of the JAX package's ``samplers/chain.py``:

- uniform box prior normalized by the prior volume; outside-box points get
  ``-inf``, or the widest finite value of the working dtype with
  ``finite=True``;
- the vestigial ``extra_std`` term: its prior reduces to the constant
  ``2 log(1e-16)``, still added for parity with reference chain values;
- with a diagonal experimental covariance the likelihood factorizes over
  per-emulator blocks.  ``likelihood_mode="auto"`` picks per emulator the
  exact PC-space Woodbury block (PCA emulators, the flagship;
  :func:`make_lowrank_block`), the diagonal block (no-PCA and
  ``exp_and_cov_diagonal`` emulators) or the dense per-block Cholesky;
  ``"generic"`` takes the dense per-block Cholesky everywhere and
  ``"stitched"`` one dense (nobs, nobs) factorization per walker, the
  reference's own shape.  A dense experimental covariance always takes the
  stitched form.  The dense forms go through
  :func:`..ops.fused_mvn.mvn_loglike_best`;
- ``run_mcmc``: the ensemble sampler with emcee semantics (two-phase
  burn-in, top-lnprob resample, thinning, resume-by-append);
- ``run_MCMC_HMC`` (with ``n_leapfrog="auto"``, ``warm_start`` and
  ``resume``), ``run_MCMC_PTLMC`` (parallel-tempered Langevin MC) and
  ``run_pocoMC`` (flow-preconditioned SMC with its evidence);
- chain pickle contract ``{"chain": (nwalkers, nsteps, ndim)}``;
- ``devices=``/``mesh=`` on every sampler shard the walker (chain,
  particle) axis over a :class:`..parallel.mesh.WalkerMesh`, with the JAX
  package's semantics (divisibility, ``-1``, ``pool``): each device
  evaluates its shard of the posterior against a replica built from
  copies of the emulators (:meth:`Chain._posterior_fns_on`), and every
  random draw stays on the chain's device, so a seed gives the same draws
  sharded and unsharded.
"""

from __future__ import annotations

import functools
import logging
import pickle
import zlib
from pathlib import Path

import numpy as np
import torch

from ..config import resolve_device, resolve_dtype
from ..ops import fused_woodbury
from ..ops.fused_mvn import mvn_loglike_best
from ..ops.linalg import mvn_loglike_diagcov_batch, spd_qform_logdet
from ..runtime import parse_model_parameter_file
from ..utils.io import load_exp_data_pickle
from ..utils.profiling import span

logger = logging.getLogger(__name__)

# 2*log(1e-16): the constant the reference's zeroed extra_std prior adds.
_EXTRA_STD_CONST = 2.0 * np.log(1e-16)


def warm_fallback_seed(seed: int, final_state) -> int:
    """Seed of a warm-started HMC run with no chain file: the CRC32 of the
    warm start's final state, folded into ``(seed, 1 << 21)`` by
    :func:`.ensemble.derive_seed`, so chained continuations with one seed
    (run 2 from run 1, run 3 from run 2) draw distinct momenta, and the
    same pair always gives the same stream.  (A resumed chain folds its
    stored length in as ``(1 << 20) + len`` instead.)"""
    from .ensemble import derive_seed

    fs = np.ascontiguousarray(np.asarray(final_state, dtype=np.float64))
    tag = zlib.crc32(fs.tobytes()) & 0x7FFFFFFF
    return derive_seed(derive_seed(seed, 1 << 21), tag)


def make_lowrank_block(e, exp_mean: np.ndarray, exp_var: np.ndarray,
                       dtype: torch.dtype, device: torch.device):
    """PC-space Woodbury likelihood of one PCA emulator (exact).

    With ``cov(x) = C0' + A^T diag(v) A`` (``C0' = cov_trunc + diag(exp
    var)``, A fixed) and ``mean(x) = gp_mean @ A + shift``, the likelihood
    collapses into PC space: expanding around ``p0``, the C0'^-1-metric
    projection of the data residual onto rowspace(A), with ``d = gp_mean -
    p0`` and ``M = A C0'^-1 A^T``, Woodbury and the matrix-determinant
    lemma give::

        y cov^-1 y^T = d (M^-1 + diag(v))^-1 d^T + const2
        log det cov  = log det C0' + log det M + log det(M^-1 + diag(v))

    so each walker factors one (npc, npc) matrix ``B = M^-1 + diag(v)``.
    The JAX package factors ``I + V^1/2 M V^1/2`` and subtracts its
    correction from ``d M d^T`` instead: the same value, but in float32
    the two terms cancel as M grows with the kept PCs (0.025 log-units
    off float64 with the BAND heads' 11 to 70 PCs, against 7.5e-5 in this
    form); B is well conditioned (v >= 0 on SPD M^-1), needs no square
    root of v, and M^-1, log det M come from the host in float64.

    Returns ``(LowRankBlock, bs)``: the block's predict, kept apart from its
    epilogue so that a posterior call evaluates every block's epilogue at
    once (:func:`woodbury_blocks`), and its state.
    """
    a_mat, cov_trunc = e.lowrank_parts()
    a64 = np.asarray(a_mat, dtype=np.float64)
    c0 = np.asarray(cov_trunc, dtype=np.float64) + np.diag(exp_var.astype(np.float64))
    c0_chol = np.linalg.cholesky(c0)
    logdet_c0 = 2.0 * np.sum(np.log(np.diag(c0_chol)))
    c0_inv = np.linalg.inv(c0)
    g = a64 @ c0_inv                     # (npc, n)
    m_mat = g @ a64.T                    # (npc, npc)
    shift = np.asarray(e.scaler.mean, dtype=np.float64)
    r0 = shift - exp_mean.astype(np.float64)
    p0 = -np.linalg.solve(m_mat, g @ r0)
    r_perp = r0 + p0 @ a64
    const2 = float(r_perp @ c0_inv @ r_perp)
    m_chol = np.linalg.cholesky(m_mat)
    m_inv = np.linalg.inv(m_mat)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    bs = {
        "p0": t(p0), "m_inv": t(0.5 * (m_inv + m_inv.T)), "const2": t(const2),
        "logdet_c0_m": t(logdet_c0 + 2.0 * np.sum(np.log(np.diag(m_chol)))),
    }
    return LowRankBlock(e.predict_pc_parts_fastgrad), bs


class LowRankBlock:
    """A Woodbury block's predict: ``predict(x_safe)`` gives ``(gp_mean,
    var, kdiag)`` as :meth:`..models.emulator.Emulator.predict_pc_parts_fastgrad`
    does; :func:`woodbury_blocks` evaluates the blocks' epilogue."""

    def __init__(self, predict):
        self.predict = predict


def _lowrank_library(bs, gp_mean, var, kdiag):
    """One block's lp (m,) through the library's factor, plain autograd."""
    v = var if kdiag is None else torch.clamp(kdiag[None, :] - var, min=0.0)
    d = gp_mean - bs["p0"]
    quad, logdet_b = spd_qform_logdet(bs["m_inv"] + torch.diag_embed(v), d)
    lp = -0.5 * (quad + bs["const2"]) - 0.5 * (bs["logdet_c0_m"] + logdet_b)
    return torch.where(torch.isfinite(lp), lp, torch.full_like(lp, -torch.inf))


def woodbury_blocks(states, preds):
    """Every Woodbury block's lp at once: ``((m, nb), fused)``.  ``preds``
    are the blocks' ``(gp_mean, var, kdiag)``.  A float32 CUDA call whose
    every block has at most ``fused_woodbury.MAX_K`` PCs runs the fused
    kernels (``fused`` True: one forward launch, one backward); any other
    call takes the library's factor block by block, as before the kernels
    (CPU and float64 callers keep its values and gradients bit for bit)."""
    mean0 = preds[0][0]
    with span("hic.woodbury"):
        if fused_woodbury.takes_kernel(mean0.device, mean0.dtype,
                                       [p[0].shape[-1] for p in preds]):
            means, vars_, kdiags = zip(*preds)
            return fused_woodbury.fused_woodbury(states, means, vars_, kdiags), True
        return torch.stack([_lowrank_library(bs, *p) for bs, p in zip(states, preds)], 1), False


def make_diag_block(e, exp_mean: np.ndarray, exp_var: np.ndarray,
                    dtype: torch.dtype, device: torch.device):
    """O(n) likelihood of an emulator whose covariance is diagonal (no-PCA
    or ``exp_and_cov_diagonal``).  Returns ``(block_ll, bs)``."""
    bs = {
        "exp_block": torch.as_tensor(exp_mean, dtype=dtype, device=device),
        "exp_var_block": torch.as_tensor(exp_var, dtype=dtype, device=device),
    }

    def block_ll(bs, x_safe):
        mean, var = e.predict_diag(x_safe)
        return mvn_loglike_diagcov_batch(mean - bs["exp_block"], var + bs["exp_var_block"])

    return block_ll, bs


def make_cholesky_block(e, exp_mean: np.ndarray, exp_var: np.ndarray,
                        dtype: torch.dtype, device: torch.device):
    """Dense per-walker likelihood of one emulator's block: the full
    predictive covariance plus the experimental variances, through the
    fused MVN kernel (float32 on CUDA) or the batched Cholesky.  Returns
    ``(block_ll, bs)``."""
    bs = {
        "exp_block": torch.as_tensor(exp_mean, dtype=dtype, device=device),
        "exp_var_diag": torch.diag(torch.as_tensor(exp_var, dtype=dtype, device=device)),
    }

    def block_ll(bs, x_safe):
        zero = torch.zeros((x_safe.shape[0],), dtype=dtype, device=x_safe.device)
        mu_i, cov_i = e._predict_full(x_safe, zero)
        return mvn_loglike_best(mu_i - bs["exp_block"], cov_i + bs["exp_var_diag"])

    return block_ll, bs


def pick_block(e, *args):
    """The cheapest exact block for emulator ``e`` (``likelihood_mode="auto"``)."""
    if e.has_lowrank_cov:
        return make_lowrank_block(e, *args)
    if e.perform_no_PCA_ or e.exp_and_cov_diagonal_:
        return make_diag_block(e, *args)
    return make_cholesky_block(e, *args)


LIKELIHOOD_MODES = ("auto", "generic", "stitched")


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
        self._likelihood_mode = "auto"

    # ------------------------------------------------------------ mode knob

    @property
    def likelihood_mode(self):
        """Likelihood assembly mode: ``"auto"`` (Woodbury/diagonal fast
        paths), ``"generic"`` (per-block dense Cholesky), or ``"stitched"``
        (full dense-covariance Cholesky, the reference's shape).  Assigning
        a new mode drops the assembled posterior functions (they are built
        for one mode), so a change after a posterior evaluation takes
        effect."""
        return self._likelihood_mode

    @likelihood_mode.setter
    def likelihood_mode(self, value):
        if value not in LIKELIHOOD_MODES:
            raise ValueError(
                f"unknown likelihood_mode {value!r}: use 'auto' (Woodbury/"
                "diagonal fast paths), 'generic' (per-block Cholesky), or "
                "'stitched' (full dense-covariance Cholesky, the "
                "reference's shape)"
            )
        if value != self._likelihood_mode:
            self._device_fns = None
        self._likelihood_mode = value

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
        """Assemble the log-likelihood / log-posterior functions on the
        chain's device.  The two posterior functions carry ``replica(device)``
        (:meth:`_posterior_fns_on`) for a walker mesh."""
        if not self.emuList:
            raise RuntimeError("loadEmulator before evaluating the posterior")
        fns, self._like_state = self._assemble(self.emuList, self.device)
        for name in ("log_likelihood", "log_posterior"):
            fns[name].replica = functools.partial(self._replica, name)
        self._device_fns = fns
        return fns

    def _posterior_fns_on(self, device) -> dict:
        """The posterior functions of :meth:`_build_device_fns` assembled on
        ``device`` from copies of the emulators (:meth:`..models.emulator.
        Emulator.to`); they take the chain's state moved there
        (:func:`..parallel.mesh.replicate`)."""
        if not self.emuList:
            raise RuntimeError("loadEmulator before evaluating the posterior")
        fns, _ = self._assemble([e.to(device) for e in self.emuList], torch.device(device))
        return fns

    def _replica(self, name: str, device):
        """``device_fns[name]`` for ``device``: the chain's own function on
        its device, else one over emulator copies there."""
        if torch.device(device) == self.device:
            return self.device_fns[name]
        return self._posterior_fns_on(device)[name]

    def _assemble(self, emus, device):
        """``(functions, state)`` of the likelihood over ``emus`` (which live
        on ``device``), with the state's tensors on ``device``."""
        dtype = self._dtype
        expdata_np = np.asarray(self.expdata, dtype=np.float64).flatten()
        expcov_np = np.asarray(self.expdata_cov, dtype=np.float64)
        nobs = self.nobs
        emus = list(emus)

        def tensor(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        offsets = np.cumsum([0] + [e.nobs for e in emus])
        if offsets[-1] != nobs:
            raise ValueError(
                f"emulators predict {offsets[-1]} observables, experimental "
                f"data has {nobs}"
            )
        # A diagonal experimental covariance makes the total covariance
        # block-diagonal per emulator, so the likelihood factorizes over
        # blocks.  A dense one needs the stitched (nobs, nobs) matrix.
        off = expcov_np - np.diag(np.diagonal(expcov_np))
        exp_cov_is_diagonal = bool(np.all(off == 0.0))
        exp_var_np = np.diagonal(expcov_np).copy()

        mode = self.likelihood_mode  # validated by the property setter
        use_stitched = (not exp_cov_is_diagonal) or mode == "stitched"
        block_fns, block_states = [], []
        if not use_stitched:
            maker = pick_block if mode == "auto" else make_cholesky_block
            for e, i0, i1 in zip(emus, offsets[:-1], offsets[1:]):
                fn, bs = maker(e, expdata_np[i0:i1], exp_var_np[i0:i1], dtype, device)
                block_fns.append(fn)
                block_states.append(bs)

        like_state = {
            "lo": tensor(self.min),
            "hi": tensor(self.max),
            "expdata": tensor(expdata_np),
            "expcov": tensor(expcov_np),
            "blocks": tuple(block_states),
        }

        def model_predict(state, x, extra_std):
            """(m, ndim) -> mean (m, nobs), block-diagonal cov (m, nobs, nobs).

            ``extra_std`` (scalar or (m,)) is multiplied by each sample's
            LAST parameter column; its square is added to every emulator's
            predictive PC variance, as the reference's ``_predict`` does."""
            with span("hic.assembly"):
                m = x.shape[0]
                extra = extra_std * x[:, -1]
                mean = torch.zeros((m, nobs), dtype=dtype, device=x.device)
                cov = torch.zeros((m, nobs, nobs), dtype=dtype, device=x.device)
                for e, i0, i1 in zip(emus, offsets[:-1], offsets[1:]):
                    mu_i, cov_i = e._predict_full(x, extra)
                    mean[:, i0:i1] = mu_i
                    cov[:, i0:i1, i0:i1] = cov_i
                return mean, cov

        def loglike_core_blocked(state, x):
            """Likelihood factorized over per-emulator covariance blocks: each
            block's predict in block order (a diagonal or dense block's whole
            likelihood), then every Woodbury block's epilogue at once."""
            x_safe = torch.clamp(x, state["lo"], state["hi"])
            terms, preds, lowrank = [], [], []
            for fn, bs in zip(block_fns, state["blocks"]):
                if isinstance(fn, LowRankBlock):
                    preds.append(fn.predict(x_safe))
                    lowrank.append(bs)
                    terms.append(None)
                else:
                    terms.append(fn(bs, x_safe))
            ll = None
            if preds:
                lp_low, fused = woodbury_blocks(lowrank, preds)
                if fused:  # the kernels' blocks in one reduction
                    ll, terms = lp_low.sum(1), [t for t in terms if t is not None]
                else:      # the library route keeps its sum in block order
                    cols = iter(lp_low.unbind(1))
                    terms = [next(cols) if t is None else t for t in terms]
            if ll is None:
                ll = torch.zeros((x.shape[0],), dtype=dtype, device=x.device)
            for t in terms:
                ll = ll + t
            return ll + _EXTRA_STD_CONST

        def loglike_core_stitched(state, x):
            """One dense (nobs, nobs) likelihood per walker."""
            x_safe = torch.clamp(x, state["lo"], state["hi"])
            zero = torch.zeros((), dtype=dtype, device=x.device)
            mean, cov = model_predict(state, x_safe, zero)
            return mvn_loglike_best(
                mean - state["expdata"], cov + state["expcov"]) + _EXTRA_STD_CONST

        # Outside points are masked below anyway; the clamp keeps extreme
        # proposals numerically safe inside the emulator.
        loglike_core = loglike_core_stitched if use_stitched else loglike_core_blocked

        # the reference's finite floor is -1e300, which overflows float32;
        # use the widest finite value the working dtype holds instead
        finite_floor = -1e300 if dtype == torch.float64 else float(torch.finfo(dtype).min) / 2

        def inside_box(state, x):
            return ((x > state["lo"]) & (x < state["hi"])).all(1)

        def log_likelihood(state, x, finite=False):
            with span("hic.posterior"):
                ll = loglike_core(state, x)
                outside = torch.full_like(ll, finite_floor if finite else -torch.inf)
                return torch.where(inside_box(state, x), ll, outside)

        def log_posterior(state, x):
            with span("hic.posterior"):
                ll = loglike_core(state, x)
                return torch.where(inside_box(state, x), ll, torch.full_like(ll, -torch.inf))

        fns = {
            "log_likelihood": log_likelihood,
            "log_posterior": log_posterior,
            "model_predict": model_predict,
        }
        return fns, like_state

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

    def log_likelihood_point_by_point(self, X, extra_std_prior_scale: float = 0.001):
        """Kept for API parity; the batch path is identical here (the
        reference loops per point)."""
        return self.log_likelihood(X, extra_std_prior_scale)

    def random_pos(self, n: int = 1, seed=None):
        rng = np.random.default_rng(seed)
        return rng.uniform(self.min, self.max, (n, self.ndim))

    @staticmethod
    def map(f, args):
        """Vectorized-pool shim kept for API parity with the reference."""
        return f(args)

    # ------------------------------------------------------------ ensemble

    def _validate_resume_chain(self, prev: np.ndarray) -> None:
        """Check a stored chain satisfies the walker-chain resume contract
        ``(nwalkers, nsteps, ndim)``.  A flat 2-D chain (a weighted sample
        without a walker axis) cannot seed walker restarts."""
        if prev.ndim != 3:
            raise ValueError(
                f"existing chain at {self.mcmc_path} has shape "
                f"{prev.shape}; resume needs the walker-chain contract "
                f"(nwalkers, nsteps, ndim) -- a flat 2-D chain was "
                f"likely written by run_pocoMC and cannot seed walker "
                f"restarts"
            )
        if prev.shape[2] != self.ndim:
            raise ValueError(
                f"existing chain has ndim={prev.shape[2]}, "
                f"posterior has ndim={self.ndim}"
            )

    def run_mcmc(
        self,
        nsteps: int = 500,
        nburnsteps: int | None = None,
        nwalkers: int | None = None,
        status=None,
        nthin: int = 10,
        seed: int = 0,
        skip_initial_state_check: bool = False,
        move: str = "stretch",
        devices: int | None = None,
        mesh=None,
    ):
        """Ensemble-MCMC calibration with emcee semantics: two-phase burn-in
        with walker resampling at the top-lnprob unique points, thinning,
        and resume-by-append from an existing chain pickle.

        ``move``: ``"stretch"`` (reference default), ``"de"``,
        ``"snooker"``, or ``"de-snooker"`` -- see :mod:`.ensemble`.  The
        posterior is the one ``likelihood_mode`` selects.  Returns an
        :class:`.ensemble.EnsembleResult` of numpy arrays for the
        production phase and writes its thinned chain to ``mcmc_path``.

        ``devices``/``mesh``: the walkers' posterior evaluations are
        sharded over a device mesh (:mod:`..parallel.mesh`; ``devices=N``
        the first N cards, ``-1`` all of them); ``nwalkers``, or the
        resumed chain's walker count, must divide over it.  The results
        equal the unsharded run's up to float reassociation.
        """
        from ..parallel.mesh import check_divisible, resolve_mesh, sharded_log_prob
        from .ensemble import derive_seed

        mesh = resolve_mesh(devices, mesh)
        chain_data = {}
        try:
            with open(self.mcmc_path, "rb") as f:
                chain_data = pickle.load(f)
        except FileNotFoundError:
            pass
        burn_flag = "chain" not in chain_data
        if not burn_flag:
            self._validate_resume_chain(np.asarray(chain_data["chain"]))
        if nburnsteps is None or nwalkers is None:
            logger.error("must specify nburnsteps and nwalkers to start chain")
            return

        if mesh is not None:
            check_divisible(mesh, nwalkers if burn_flag else chain_data["chain"].shape[0])
        log_post, like_state = self.posterior_with_state()
        # what the segments evaluate: the replicas are built once per run
        run_fn, run_state = ((sharded_log_prob(log_post, mesh, like_state), None)
                             if mesh is not None else (log_post, like_state))
        logger.info("Starting MCMC ...")

        if burn_flag:
            logger.info("no existing chain found, starting initial burn-in")
            nburn0 = nburnsteps // 2
            k1, k2, k3 = (derive_seed(seed, i) for i in (1, 2, 3))
            x0 = self.random_pos(nwalkers, seed=seed)
            if not skip_initial_state_check:
                self._check_initial_state(like_state, x0)
            logger.info("running %d walkers for %d steps", nwalkers, nburn0)
            res = self._run_segments(run_fn, run_state, x0, nburn0, k1, status, move)

            logger.info("resampling walker positions")
            flat = res.chain.reshape(-1, self.ndim)
            flat_lp = res.log_prob.reshape(-1)
            # top-lnprob unique points, as the reference resamples
            uniq_idx = np.unique(flat_lp, return_index=True)[1][-nwalkers:]
            x0 = flat[uniq_idx]
            if x0.shape[0] < nwalkers:  # degenerate: pad by repeating best
                x0 = np.concatenate(
                    [x0, np.repeat(x0[-1:], nwalkers - x0.shape[0], axis=0)])

            nburn1 = nburnsteps - nburn0
            logger.info("running %d walkers for %d steps", nwalkers, nburn1)
            res = self._run_segments(run_fn, run_state, x0, nburn1, k2, status, move)
            x0 = res.final_state
            logger.info("burn-in complete, starting production")
            prod_seed = k3
        else:
            logger.info("restarting from last point of existing chain")
            x0 = np.asarray(chain_data["chain"])[:, -1, :]
            if not skip_initial_state_check:
                self._check_initial_state(like_state, x0)
            # fold the stored chain length into the seed: same-seed resumed
            # segments would otherwise replay one random stream and
            # cross-correlate the appended chain
            prod_seed = derive_seed(seed, (1 << 20) + chain_data["chain"].shape[1])

        logger.info("running %d walkers for %d steps", x0.shape[0], nsteps)
        res = self._run_segments(run_fn, run_state, x0, nsteps, prod_seed, status, move)
        self._append_and_write_chain(chain_data, res.chain, nthin)
        return res

    def _check_initial_state(self, like_state, x0):
        """emcee's initial-state check (skipped via
        ``skip_initial_state_check=True``, same kwarg as emcee): every
        starting walker must have a finite log-posterior, and the ensemble
        must be linearly independent (a degenerate ensemble breaks the
        stretch move's affine invariance)."""
        with torch.no_grad():
            lp0 = self.device_fns["log_posterior"](like_state, self._as_x(x0)).cpu().numpy()
        n_bad = int(np.sum(~np.isfinite(lp0)))
        if n_bad:
            raise ValueError(
                f"{n_bad} of {len(lp0)} initial walkers have non-finite "
                "log-posterior; fix the starting state or pass "
                "skip_initial_state_check=True"
            )
        x_np = np.asarray(x0, dtype=np.float64)
        rank = np.linalg.matrix_rank(x_np - x_np.mean(axis=0))
        if rank < min(self.ndim, x_np.shape[0] - 1):
            raise ValueError(
                "initial walker ensemble is linearly dependent (rank "
                f"{rank} < {min(self.ndim, x_np.shape[0] - 1)}); the stretch "
                "move cannot explore the full space from it; pass "
                "skip_initial_state_check=True to bypass"
            )

    @staticmethod
    def _log_acceptance(acceptance):
        af = np.asarray(acceptance)
        logger.info(
            "acceptance fraction: mean %.4f, std %.4f, min %.4f, max %.4f",
            af.mean(), af.std(), af.min(), af.max(),
        )

    def _run_segments(self, log_post, like_state, x0, nsteps, seed, status,
                      move: str = "stretch"):
        """Run ``nsteps`` ensemble steps from ``x0`` (numpy), logging
        acceptance every ``status`` steps (``None``: ~10% of the segment).

        Every chunk uses the same seed and its absolute step offset, so the
        log cadence cannot change the sampled chain; the walker state stays
        on the device between chunks.  Returns an ``EnsembleResult`` of
        float64 numpy arrays.
        """
        from .ensemble import EnsembleResult, run_ensemble

        if status is None:
            status = max(nsteps // 10, 1)
        chunked = bool(status) and status < nsteps
        if not chunked:
            status = max(nsteps, 1)
        state_x = self._as_x(x0)
        chains, lps, accs = [], [], []
        done = 0
        while True:
            chunk = min(status, nsteps - done)
            res = run_ensemble(log_post, state_x, chunk, seed, state=like_state,
                               move=move, step_offset=done)
            done += chunk
            if chunked:
                logger.info("step %d:", done)
            acc = res.acceptance.cpu().numpy().astype(np.float64)
            self._log_acceptance(acc)
            chains.append(res.chain.cpu().numpy().astype(np.float64))
            lps.append(res.log_prob.cpu().numpy().astype(np.float64))
            accs.append(acc * chunk)
            state_x = res.final_state
            if done >= nsteps:
                break
        return EnsembleResult(
            chain=np.concatenate(chains, axis=1),
            log_prob=np.concatenate(lps, axis=1),
            acceptance=sum(accs) / max(nsteps, 1),
            final_state=res.final_state.cpu().numpy().astype(np.float64),
            final_log_prob=res.final_log_prob.cpu().numpy().astype(np.float64),
        )

    # ------------------------------------------------------------- rescoring

    def compute_log_likelihood_for_chain(
        self, output_path: str = "./mcmc/log_likelihood.pkl", batch_size: int = 4096
    ):
        """Re-score a saved chain pointwise, in batches on the device.  A
        walker chain scores as (nwalkers, nsteps); a flat (nsamples, ndim)
        chain as (nsamples,)."""
        if self.chain is False:
            logger.error("Load chain before computing log likelihood")
            with open(self.mcmc_path, "rb") as f:
                self.chain = pickle.load(f)["chain"]
        logger.info("Computing log likelihood for the chain...")
        chain = np.asarray(self.chain)
        flat = chain.reshape(-1, self.ndim)
        out = np.empty(flat.shape[0])
        for i in range(0, flat.shape[0], batch_size):
            out[i : i + batch_size] = self.log_likelihood(flat[i : i + batch_size])
        likelihood = out.reshape(chain.shape[:2]) if chain.ndim == 3 else out
        with open(output_path, "wb") as f:
            pickle.dump({"log_likelihood": likelihood}, f)
        return likelihood

    # ------------------------------------------------------------ chain file

    def _append_and_write_chain(self, chain_data, res_chain, nthin):
        """Thin the sampler output, append under the resume contract, and
        persist.  Dumps the full dict, so extra keys written alongside the
        chain survive a resume."""
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
        n_leapfrog: int | str | None = None,
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
        ``n_leapfrog=None`` means 8 for a fresh run and ``"auto"`` (the
        warm start's length) with a ``warm_start``, ``scheme="auto"`` picks
        windowed HMC with persistent momentum at adapted acceptance >= 0.75
        and endpoint MH otherwise, ``warmup_walkers="auto"`` adapts on
        ``min(256, nwalkers)`` walkers.

        ``resume=True`` continues the chain pickle at ``mcmc_path``: the
        walkers restart from its last samples (the file's walker count
        wins) and the thinned samples are appended.  ``warm_start`` (an
        :class:`.hmc.HMCResult` on this posterior) skips every adaptation
        phase; with no chain pickle the walkers start from its final state
        (logged as a warning when ``resume=True``).  Writes ``{"chain":
        (nwalkers, ceil(nsteps/nthin), ndim)}`` to ``mcmc_path``.

        ``devices``/``mesh``: the walkers' value-and-gradient evaluations
        are sharded over a device mesh (as for :meth:`run_mcmc`); the
        walker count must divide over it, and ``warmup_walkers="auto"``
        falls back to the full batch where 256 does not.
        """
        from ..parallel.mesh import check_divisible, resolve_mesh
        from .ensemble import derive_seed
        from .hmc import run_hmc

        mesh = resolve_mesh(devices, mesh)
        if n_leapfrog is None:
            n_leapfrog = "auto" if warm_start is not None else 8
        logger.info("Starting HMC ...")
        chain_data = {}
        if resume:
            try:
                with open(self.mcmc_path, "rb") as f:
                    chain_data = pickle.load(f)
            except FileNotFoundError:
                pass
        log_post, like_state = self.posterior_with_state()
        if "chain" in chain_data:
            prev = np.asarray(chain_data["chain"])
            self._validate_resume_chain(prev)
            logger.info("restarting from last point of existing chain")
            nwalkers = prev.shape[0]
            x0 = prev[:, -1, :]
            # a resumed run with the same seed must not replay the fresh
            # run's momenta: fold the stored length in
            run_seed = derive_seed(seed, (1 << 20) + prev.shape[1])
        elif warm_start is not None:
            # no warmup runs under warm_start, so prior draws would go
            # straight into the chain: continue from the final walkers
            if resume:
                logger.warning(
                    "resume=True but no chain found at %s; continuing from "
                    "warm_start's final walker positions", self.mcmc_path,
                )
            x0 = np.asarray(warm_start.final_state)
            if x0.ndim != 2 or x0.shape[1] != self.ndim:
                raise ValueError(
                    f"warm_start.final_state has shape {x0.shape}, "
                    f"expected (nwalkers, {self.ndim})"
                )
            nwalkers = x0.shape[0]
            run_seed = warm_fallback_seed(seed, x0)
        else:
            x0 = self.random_pos(nwalkers, seed=seed)
            run_seed = seed
        if mesh is not None:
            check_divisible(mesh, nwalkers)
        if isinstance(warmup_walkers, str):
            if warmup_walkers != "auto":
                raise ValueError(
                    f"warmup_walkers must be an int, None, or 'auto', "
                    f"got {warmup_walkers!r}"
                )
            warmup_walkers = min(256, nwalkers)
            if mesh is not None and warmup_walkers % mesh.size:
                warmup_walkers = None  # the full batch divides
        res = run_hmc(
            log_post, x0, nsteps, run_seed,
            state=like_state, lo=self.min, hi=self.max,
            n_leapfrog=n_leapfrog, warmup=nburnsteps,
            target_accept=target_accept, traj_jitter=traj_jitter,
            warm_start=warm_start, scheme=scheme, window=window, persist=persist,
            warmup_walkers=warmup_walkers, mesh=mesh, device=self.device,
            dtype=self._dtype,
        )
        logger.info(
            "HMC: step size %.4f, n_leapfrog %d, mean accept %.3f",
            res.step_size, res.n_leapfrog, float(np.mean(res.acceptance)),
        )
        self._append_and_write_chain(chain_data, res.chain, nthin)
        return res

    # ---------------------------------------------------------------- PTLMC

    def run_MCMC_PTLMC(
        self,
        nsteps: int = 500,
        nwalkers: int = 16,
        ntemps: int = 50,
        maxtemp: float = 100.0,
        nstartparameters: int = 1000,
        seed: int = 0,
        use_gradients: bool = False,
        devices: int | None = None,
        mesh=None,
        stats: dict | None = None,
    ):
        """Parallel-tempered Langevin MC (:func:`.ptlmc.run_ptlmc`), with the
        JAX package's knobs.  ``use_gradients=True`` turns on the Langevin
        drift.  Writes ``{"chain": (nwalkers, nsteps, ndim)}`` (the
        ``T = 1`` chains) to ``mcmc_path``.  ``stats``, when given,
        receives the run's counts and timings.  ``devices``/``mesh``: the
        (ntemps + nwalkers) chains' posterior evaluations are sharded over
        a device mesh, over which that count must divide."""
        from ..parallel.mesh import check_divisible, resolve_mesh
        from .ptlmc import run_ptlmc

        mesh = resolve_mesh(devices, mesh)
        if mesh is not None:
            check_divisible(mesh, ntemps + nwalkers, "chains (ntemps + nwalkers)")
        logger.info("Starting MCMC ...")
        log_post, like_state = self.posterior_with_state()
        theta = run_ptlmc(
            log_post,
            lambda n: self.random_pos(n, seed=seed),
            numtemps=ntemps,
            numchain=nwalkers,
            sampperchain=nsteps,
            maxtemp=maxtemp,
            nstartparameters=nstartparameters,
            seed=seed,
            state=like_state,
            use_gradients=use_gradients,
            mesh=mesh,
            device=self.device,
            dtype=self._dtype,
            stats=stats,
        )
        self.chain = np.asarray(theta).reshape((nwalkers, nsteps, self.ndim))
        logger.info("Writing MCMC chains to file...")
        with open(self.mcmc_path, "wb") as f:
            pickle.dump({"chain": self.chain}, f)

    # ----------------------------------------------------------------- SMC

    def smc_checkpoint_path(self) -> Path:
        """``<stem>_smc_checkpoint.pkl`` beside ``mcmc_path``: two chains in
        one directory keep separate checkpoints."""
        return self.mcmc_path.with_name(f"{self.mcmc_path.stem}_smc_checkpoint.pkl")

    def run_pocoMC(
        self,
        n_effective: int = 1000,
        n_active: int = 250,
        n_prior: int = 2000,
        sample: str = "tpcn",
        n_max_steps: int = 200,
        random_state: int = 42,
        n_total: int = 5000,
        n_evidence: int = 5000,
        pool=None,
        prior=None,
        devices: int | None = None,
        mesh=None,
        resume: bool = False,
        checkpoint: bool = True,
        **smc_kwargs,
    ):
        """Flow-preconditioned SMC with pocoMC semantics
        (:func:`.smc.run_smc`), with the JAX package's knobs.

        ``prior``: ``None`` (the uniform box), a list of frozen scipy
        distributions (or an object with ``dists``), converted to a
        :class:`..utils.priors.ScipyPrior`, or an object with
        ``log_prior_torch``; anything else is refused.  ``devices``/``mesh``
        shard the particles' likelihood evaluations over a device mesh
        (``n_prior``, ``n_active`` and ``n_evidence`` must divide over it).
        ``pool`` (the reference's process count) maps onto the same knob:
        an integer ``pool`` with no ``devices``/``mesh`` asks for
        ``min(pool, torch.cuda.device_count())`` cards when the particle
        counts divide over them, and is logged and ignored otherwise.
        ``checkpoint`` writes the
        sampler state after every iteration to
        :meth:`smc_checkpoint_path`; ``resume=True`` continues from it,
        bit for bit the uninterrupted run.  Further keyword arguments go
        to :func:`.smc.run_smc` (``max_iterations``, the flow budget, the
        evidence proposal).  Writes the chain dict (``chain, weights,
        logl, logp, logz, logz_err`` and every evidence estimate) to
        ``mcmc_path`` and returns it.
        """
        from ..parallel.mesh import resolve_mesh
        from ..utils.priors import ScipyPrior
        from .smc import run_smc

        if resume and not checkpoint:
            raise ValueError(
                "resume=True requires checkpoint=True (the resume state "
                "is the checkpoint file)"
            )
        if devices is None and mesh is None and isinstance(pool, int) and pool > 1:
            n_dev = min(pool, torch.cuda.device_count())
            if n_dev > 1 and all(n % n_dev == 0 for n in (n_prior, n_active, n_evidence or n_dev)):
                devices = n_dev
                logger.info("pool=%d mapped to %d-device particle sharding", pool, n_dev)
            elif n_dev > 1:
                logger.info(
                    "pool=%d ignored: particle counts not divisible by %d devices "
                    "(pass devices=/mesh= explicitly to force)", pool, n_dev,
                )
        mesh = resolve_mesh(devices, mesh)
        if prior is not None and not hasattr(prior, "log_prior_torch"):
            if isinstance(prior, (list, tuple)):
                prior = ScipyPrior(prior)
            elif hasattr(prior, "dists"):
                prior = ScipyPrior(prior.dists)
        if prior is not None and getattr(prior, "dim", self.ndim) != self.ndim:
            raise ValueError("prior.dim does not match the model parameter space")

        logger.info("Starting preconditioned SMC ...")
        result = run_smc(
            self.device_fns["log_likelihood"],
            self.min,
            self.max,
            likelihood_state=self._like_state,
            n_effective=n_effective,
            n_active=n_active,
            n_prior=n_prior,
            sample=sample,
            n_max_steps=n_max_steps,
            n_total=n_total,
            n_evidence=n_evidence,
            seed=random_state,
            custom_prior=prior,
            mesh=mesh,
            checkpoint_path=self.smc_checkpoint_path() if checkpoint else None,
            resume=resume,
            device=self.device,
            dtype=self._dtype,
            **smc_kwargs,
        )
        logger.info("Log evidence: %s", result["logz"])
        logger.info("Log evidence error: %s", result["logz_err"])
        chain_data = {
            "chain": np.asarray(result["samples"]),
            "weights": np.asarray(result["weights"]),
            "logl": np.asarray(result["logl"]),
            "logp": np.asarray(result["logp"]),
        }
        chain_data.update({k: result[k] for k in _EVIDENCE_KEYS})
        self.chain = chain_data["chain"]
        with open(self.mcmc_path, "wb") as f:
            pickle.dump(chain_data, f)
        return chain_data


# the evidence entries of run_pocoMC's chain dict, as the JAX package writes them
_EVIDENCE_KEYS = (
    "logz", "logz_err", "logz_ps", "logz_err_ps", "logz_source", "logz_is",
    "logz_err_is", "logz_khat", "logz_bridge", "logz_err_bridge",
)
