"""Plain reference of the calibration posterior over PCSK emulators.

The posterior of ``posterior.py`` with surmise-style PCSK heads in place of
the sklearn head, written from the semantics, not from the port's code:

- per block, the standard scaler (biased variance) and a full-SVD
  whitened PCA of the training outputs; the block keeps the fewest PCs
  whose cumulative explained-variance ratio exceeds ``target_variance``
  (0.99);
- the stochastic-kriging noise of each kept PC at each design point, from
  the per-design simulation errors (the configuration's ``train_err``):
  ``var_z[k, i] = sum_j (W_kj sigma_std,ij)^2`` with ``sigma_std`` the
  errors over the scaler's scale and ``W_kj = V_kj / sqrt(ev_k)`` the
  whitened projection weights;
- one exact GP per kept PC with the ARD Matern-1.5 kernel ``amp (1 + s)
  e^-s``, ``s = sqrt(3) |(x - x') / ls|``, white noise, that per-design
  noise and the BAND heads' jitter ``gp_alpha`` (1e-6) on the training
  diagonal; predictive variance ``amp + noise - |L^-1 k*|^2`` clipped at
  zero (white noise in, per-design noise and jitter out);
- the map back to observables with the truncation covariance of the
  dropped PCs (``B^T B + 1e-4 var``), and per block the Gaussian
  log-likelihood with the experimental variances, plus
  ``EXTRA_STD_CONST`` inside the open box, ``-inf`` outside.

Block b's GPs take the hyperparameters ``hyper[b * npc : b * npc + k_b]``
of the problem's draws (``npc`` the configuration's scalar, the largest
block's count).  Everything is worked out again from the raw problem; it
imports neither JAX nor anything of the port.  ``tf32=True`` is the
control, as in ``posterior.py``: float32 with every product's operands
rounded to TF32.  The value and the gradient in the HMC sampler's
coordinates come from ``posterior.py::evaluate_u``, which takes this
class as it takes that one.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .posterior import Posterior, _sqdist, evaluate, evaluate_u  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def pc_count(explained_variance: np.ndarray, target: float) -> int:
    """The fewest PCs whose cumulative explained-variance ratio exceeds
    ``target``."""
    ratio = np.cumsum(explained_variance) / np.sum(explained_variance)
    return min(int(np.sum(ratio <= target)) + 1, explained_variance.shape[0])


def fit_block_pcsk(y: np.ndarray, err: np.ndarray, target: float):
    """Scaler, whitened PCA and PCSK noise of one block, float64: the GP
    targets (k, n), their per-design noise variances (k, n), the map A (k,
    nobs), the shift back to observables and the truncation covariance."""
    mean = y.mean(0)
    var = y.var(0)
    scale = np.sqrt(var)
    scale = np.where(scale == 0.0, 1.0, scale)
    ys = (y - mean) / scale
    pmean = ys.mean(0)
    yc = ys - pmean
    _, s, vt = np.linalg.svd(yc, full_matrices=False)
    ev = s ** 2 / (y.shape[0] - 1)
    k = pc_count(ev, target)
    w = vt[:k] / np.sqrt(ev[:k])[:, None]
    z = yc @ w.T
    var_z = ((err / scale) ** 2 @ (w ** 2).T).T
    trans = vt * np.sqrt(ev)[:, None] * scale
    cov_trunc = trans[k:].T @ trans[k:] + np.diag(1e-4 * var)
    return z.T, var_z, trans[:k], mean + pmean * scale, cov_trunc


def matern15(amp: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """``amp (1 + s) e^-s`` with ``s = sqrt(3 r2)``; the square root is
    taken where r2 > 0 only, so that autograd's derivative stays finite at
    r = 0 (where the kernel's is zero)."""
    pos = r2 > 0
    s = torch.where(pos, torch.sqrt(3.0 * torch.where(pos, r2, torch.ones_like(r2))),
                    torch.zeros_like(r2))
    return amp[:, None, None] * (1.0 + s) * torch.exp(-s)


class PosteriorPCSK(Posterior):
    """The log posterior of one problem (``benchmark/harness/problem.py``)
    under nine PCSK Matern-1.5 heads, on ``device`` in ``dtype`` (float64;
    the control float32 with ``tf32=True``).  ``self.npcs`` holds each
    block's PC count."""

    def __init__(self, problem: dict, cfg: dict, *, device="cpu",
                 dtype=torch.float64, tf32: bool = False):
        self.device = torch.device(device)
        self.dtype = dtype
        self.tf32 = tf32
        self.alpha = float(cfg["gp_alpha"])
        npc = int(cfg["npc"])
        target = float(cfg["target_variance"])
        t = self._t
        self.x_train = t(problem["design"])
        self.lo = t(problem["lo"])
        self.hi = t(problem["hi"])
        outputs = np.asarray(problem["outputs"], dtype=np.float64)
        errors = np.asarray(problem["train_err"], dtype=np.float64)
        exp_mean = np.asarray(problem["exp_mean"], dtype=np.float64)
        exp_var = np.asarray(problem["exp_err"], dtype=np.float64) ** 2
        hyper = problem["hyper"]
        self.blocks, self.npcs = [], []
        i0 = 0
        for b, nobs in enumerate(cfg["blocks"]):
            i1 = i0 + nobs
            z, var_z, a, shift, cov_trunc = fit_block_pcsk(outputs[:, i0:i1], errors[:, i0:i1],
                                                           target)
            k = z.shape[0]
            self.npcs.append(k)
            gps = slice(b * npc, b * npc + k)
            amp = torch.exp(t(hyper["log_amp"][gps]))
            ls = torch.exp(t(hyper["log_ls"][gps]))
            noise = torch.exp(t(hyper["log_noise"][gps]))
            xs = self.x_train[None] / ls[:, None, :]                       # (k, n, d)
            gram = matern15(amp, _sqdist(xs, xs))
            n = gram.shape[-1]
            eye = torch.eye(n, dtype=dtype, device=self.device)
            gram = gram + (noise + self.alpha)[:, None, None] * eye + torch.diag_embed(t(var_z))
            chol = torch.linalg.cholesky(gram)
            g = torch.linalg.solve_triangular(chol, eye.expand(k, n, n), upper=False)  # L^-1
            alpha_vec = torch.cholesky_solve(t(z)[:, :, None], chol)[:, :, 0]
            a_t = t(a)
            self.blocks.append({
                "xs": xs, "amp": amp, "inv_ls": 1.0 / ls, "kdiag": amp + noise,
                "g": g, "alpha": alpha_vec, "a": a_t,
                "aa": (a_t[:, :, None] * a_t[:, None, :]).reshape(k, nobs * nobs),
                "shift": t(shift),
                "c0": t(cov_trunc + np.diag(exp_var[i0:i1])),
                "exp": t(exp_mean[i0:i1]),
            })
            i0 = i1

    def _block_loglike(self, blk: dict, q: torch.Tensor) -> torch.Tensor:
        qs = q[None] * blk["inv_ls"][:, None, :]                            # (k, m, d)
        kstar = matern15(blk["amp"], _sqdist(blk["xs"], qs))                # (k, n, m)
        gp_mean = self._mm(blk["alpha"][:, None, :], kstar)[:, 0, :].T    # (m, k)
        v = self._mm(blk["g"], kstar)
        gp_var = torch.clamp(blk["kdiag"][:, None] - (v * v).sum(1), min=0.0).T
        mean = self._mm(gp_mean, blk["a"]) + blk["shift"]
        nobs = mean.shape[1]
        cov = self._mm(gp_var, blk["aa"]).reshape(-1, nobs, nobs) + blk["c0"]
        r = mean - blk["exp"]
        chol, info = torch.linalg.cholesky_ex(cov)
        w = torch.linalg.solve_triangular(chol, r[:, :, None], upper=False)[:, :, 0]
        ll = -0.5 * (w * w).sum(1) - torch.log(torch.diagonal(chol, dim1=1, dim2=2)).sum(1)
        return torch.where(info == 0, ll, torch.full_like(ll, -math.inf))
