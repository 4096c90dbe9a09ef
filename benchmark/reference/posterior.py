"""Plain reference of the calibration posterior that the port samples.

Written from the semantics, not from the port's code: the standard scaler
(biased variance), a full-SVD whitened PCA of each emulator's block, one
exact GP per kept PC (``amp * RBF + noise`` plus sklearn's ``alpha`` on
the training diagonal; predictive variance ``amp + noise - |L^-1 k*|^2``,
clipped at zero), the PCA map back to observables with the truncation
covariance of the dropped PCs (``B^T B + 1e-4 var``), and per emulator's
block the Gaussian log-likelihood ``-1/2 r^T C^-1 r - 1/2 log det C``
(without the ``n/2 log 2 pi`` constant) with ``C`` the predictive
covariance plus the experimental variances.  The blocks are independent
(the experimental covariance is diagonal), so the stitched and the
per-block likelihoods are one number, which is computed here block by
block.  The log posterior adds the constant ``2 log(1e-16)`` of the
reference package's zeroed ``extra_std`` prior inside the open parameter
box, and is ``-inf`` outside it.

Everything is worked out again from the benchmark's raw inputs (the
design, the training outputs, the hyperparameters and the experimental
data): nothing the program made is read.  It imports neither JAX nor
anything of the port.

``tf32=True`` is the control: the same computation in float32 with every
matrix product's operands rounded to TF32 (10 mantissa bits, to nearest),
forward and backward, as float32 products on the tensor cores with TF32
allowed would do; the factorizations and solves stay float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

EXTRA_STD_CONST = 2.0 * math.log(1e-16)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 mantissa bits), to nearest even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """a @ b with both operands rounded to TF32, the backward's products too."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return round_tf32(a) @ round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = round_tf32(g) @ round_tf32(b).transpose(-2, -1)
        gb = round_tf32(a).transpose(-2, -1) @ round_tf32(g)
        return _sum_to(ga, a.shape), _sum_to(gb, b.shape)


def _sum_to(g: torch.Tensor, shape) -> torch.Tensor:
    while g.dim() > len(shape):
        g = g.sum(0)
    for i, s in enumerate(shape):
        if s == 1 and g.shape[i] != 1:
            g = g.sum(i, keepdim=True)
    return g


def _fit_block(y: np.ndarray, npc: int):
    """Scaler and whitened PCA of one block's training outputs (n, nobs),
    float64: the GP targets (npc, n), the map A (npc, nobs) and the shift
    back to observables, and the truncation covariance."""
    mean = y.mean(0)
    var = y.var(0)
    scale = np.sqrt(var)
    scale = np.where(scale == 0.0, 1.0, scale)
    ys = (y - mean) / scale
    pmean = ys.mean(0)
    yc = ys - pmean
    _, s, vt = np.linalg.svd(yc, full_matrices=False)
    ev = s ** 2 / (y.shape[0] - 1)
    z = (yc @ vt[:npc].T) / np.sqrt(ev[:npc])
    trans = vt * np.sqrt(ev)[:, None] * scale
    a = trans[:npc]
    b = trans[npc:]
    cov_trunc = b.T @ b + np.diag(1e-4 * var)
    return z.T, a, mean + pmean * scale, cov_trunc


class Posterior:
    """The log posterior of one problem (see ``benchmark/harness/problem.py``
    for its fields), on ``device`` in ``dtype`` (float64; the control
    float32 with ``tf32=True``)."""

    def __init__(self, problem: dict, cfg: dict, *, device="cpu",
                 dtype=torch.float64, tf32: bool = False):
        self.device = torch.device(device)
        self.dtype = dtype
        self.tf32 = tf32
        self.alpha = float(cfg.get("gp_alpha", 0.1))
        npc = int(cfg["npc"])
        t = self._t
        self.x_train = t(problem["design"])
        self.lo = t(problem["lo"])
        self.hi = t(problem["hi"])
        outputs = np.asarray(problem["outputs"], dtype=np.float64)
        exp_mean = np.asarray(problem["exp_mean"], dtype=np.float64)
        exp_var = np.asarray(problem["exp_err"], dtype=np.float64) ** 2
        hyper = problem["hyper"]
        self.blocks = []
        i0 = 0
        for b, nobs in enumerate(cfg["blocks"]):
            i1 = i0 + nobs
            z, a, shift, cov_trunc = _fit_block(outputs[:, i0:i1], npc)
            gps = slice(b * npc, (b + 1) * npc)
            log_amp = t(hyper["log_amp"][gps])
            log_ls = t(hyper["log_ls"][gps])
            log_noise = t(hyper["log_noise"][gps])
            amp, ls, noise = torch.exp(log_amp), torch.exp(log_ls), torch.exp(log_noise)
            xs = self.x_train[None] / ls[:, None, :]                       # (npc, n, d)
            k = amp[:, None, None] * torch.exp(-0.5 * _sqdist(xs, xs))
            n = k.shape[-1]
            k = k + (noise + self.alpha)[:, None, None] * torch.eye(n, dtype=dtype, device=self.device)
            chol = torch.linalg.cholesky(k)
            eye = torch.eye(n, dtype=dtype, device=self.device).expand(npc, n, n)
            g = torch.linalg.solve_triangular(chol, eye, upper=False)      # L^-1
            alpha_vec = torch.cholesky_solve(t(z)[:, :, None], chol)[:, :, 0]
            a_t = t(a)
            self.blocks.append({
                "xs": xs, "amp": amp, "inv_ls": 1.0 / ls, "kdiag": amp + noise,
                "g": g, "alpha": alpha_vec, "a": a_t,
                "aa": (a_t[:, :, None] * a_t[:, None, :]).reshape(npc, nobs * nobs),
                "shift": t(shift),
                "c0": t(cov_trunc + np.diag(exp_var[i0:i1])),
                "exp": t(exp_mean[i0:i1]),
            })
            i0 = i1

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=self.dtype,
                               device=self.device)

    def _mm(self, a, b):
        return _TF32MatMul.apply(a, b) if self.tf32 else a @ b

    def _block_loglike(self, blk: dict, q: torch.Tensor) -> torch.Tensor:
        qs = q[None] * blk["inv_ls"][:, None, :]                            # (npc, m, d)
        kstar = blk["amp"][:, None, None] * torch.exp(-0.5 * _sqdist(blk["xs"], qs))
        gp_mean = self._mm(blk["alpha"][:, None, :], kstar)[:, 0, :].T    # (m, npc)
        v = self._mm(blk["g"], kstar)                                      # (npc, n, m)
        gp_var = torch.clamp(blk["kdiag"][:, None] - (v * v).sum(1), min=0.0).T
        mean = self._mm(gp_mean, blk["a"]) + blk["shift"]
        nobs = mean.shape[1]
        cov = self._mm(gp_var, blk["aa"]).reshape(-1, nobs, nobs) + blk["c0"]
        r = mean - blk["exp"]
        chol, info = torch.linalg.cholesky_ex(cov)
        w = torch.linalg.solve_triangular(chol, r[:, :, None], upper=False)[:, :, 0]
        ll = -0.5 * (w * w).sum(1) - torch.log(torch.diagonal(chol, dim1=1, dim2=2)).sum(1)
        return torch.where(info == 0, ll, torch.full_like(ll, -math.inf))

    def log_posterior(self, x: torch.Tensor) -> torch.Tensor:
        """(m, d) parameters -> (m,) log posterior, differentiable."""
        x = x.to(dtype=self.dtype, device=self.device)
        inside = ((x > self.lo) & (x < self.hi)).all(1)
        q = torch.minimum(torch.maximum(x, self.lo), self.hi)
        ll = sum(self._block_loglike(blk, q) for blk in self.blocks) + EXTRA_STD_CONST
        ll = torch.where(torch.isfinite(ll), ll, torch.full_like(ll, -math.inf))
        return torch.where(inside, ll, torch.full_like(ll, -math.inf))

    def log_posterior_u(self, u: torch.Tensor, mu: torch.Tensor, chol: torch.Tensor):
        """The HMC sampler's whitened unbounded coordinates: ``x = lo +
        (hi - lo) sigmoid(chol u + mu)``; returns ``(lp_u, lp_x)``, ``lp_u``
        with the log-Jacobian of the map."""
        u = u.to(dtype=self.dtype, device=self.device)
        z = self._mm(u, chol.to(dtype=self.dtype, device=self.device).T) + mu.to(
            dtype=self.dtype, device=self.device)
        width = self.hi - self.lo
        x = self.lo + width * torch.sigmoid(z)
        logjac = (torch.log(width) - torch.nn.functional.softplus(z)
                  - torch.nn.functional.softplus(-z)).sum(1)
        lp_x = self.log_posterior(x)
        return lp_x + logjac, lp_x


def _sqdist(xs: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """(b, n, d), (b, m, d) -> (b, n, m) squared distances from direct
    differences, one input dimension at a time."""
    d2 = None
    for j in range(xs.shape[-1]):
        diff = xs[:, :, j, None] - qs[:, None, :, j]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    return d2


def evaluate(post: Posterior, x: torch.Tensor, rows: int = 512) -> np.ndarray:
    """log posterior at x (m, d), in blocks of ``rows``, as float64 numpy."""
    out = []
    with torch.no_grad():
        for i in range(0, x.shape[0], rows):
            out.append(post.log_posterior(x[i:i + rows]).double().cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)


def evaluate_u(post: Posterior, u: torch.Tensor, mu, chol, rows: int = 256):
    """``(lp_u, lp_x, grad_u lp_u)`` at the whitened coordinates u (m, d),
    in blocks of ``rows``, as float64 numpy; a non-finite lp_u gets a zero
    gradient, as the sampler sets it."""
    lps_u, lps_x, grads = [], [], []
    for i in range(0, u.shape[0], rows):
        uu = u[i:i + rows].to(dtype=post.dtype, device=post.device).detach().requires_grad_(True)
        with torch.enable_grad():
            lp_u, lp_x = post.log_posterior_u(uu, mu, chol)
            (g,) = torch.autograd.grad(lp_u.sum(), uu)
        g = torch.where(torch.isfinite(lp_u)[:, None], g, torch.zeros_like(g))
        lps_u.append(lp_u.detach().double().cpu().numpy())
        lps_x.append(lp_x.detach().double().cpu().numpy())
        grads.append(g.double().cpu().numpy())
    return np.concatenate(lps_u), np.concatenate(lps_x), np.concatenate(grads)
