"""Float64 host-numpy ground truth of the chain's log-posterior.

The port's own copy of the oracle in the JAX package's
``tools/tpu_validation.py``.  From the identical trained GP state (kernel
hyperparameters, alpha_vec, explicit L^-1) it recomputes, in float64
numpy, what the device path evaluates: the parameter-PCA transform where an
emulator has one, per-emulator RBF cross-kernels, PC
means and variances, the low-rank physical covariance ``A^T diag(v) A +
cov_trunc + exp_var``, and a full float64 Cholesky log-likelihood per
walker.  The float32 posterior on the device must stay within 0.5
log-units of it (:data:`PRECISION_GATE`).
"""

from __future__ import annotations

import numpy as np

from ..models.param_pca import apply_param_pca

#: max |lp_f32 - lp_f64| allowed on the device (log-units)
PRECISION_GATE = 0.5

# the reference's zeroed-extra_std constant kept in the posterior
_EXTRA_STD_CONST = 2.0 * np.log(1e-16)


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t, np.float64)


def f64_log_posterior(chain, x: np.ndarray) -> np.ndarray:
    """Float64 log-posterior of every row of ``x`` (inside the prior box)."""
    x = np.asarray(x, np.float64)
    exp_mean_full = np.asarray(chain.expdata, np.float64).flatten()
    exp_var_full = np.diag(np.asarray(chain.expdata_cov, np.float64))
    offsets = np.cumsum([0] + [e.nobs for e in chain.emuList])
    lp64 = np.full(len(x), _EXTRA_STD_CONST)
    for e, i0, i1 in zip(chain.emuList, offsets[:-1], offsets[1:]):
        stt = e.gp_state
        xq = (apply_param_pca(e.param_pca_state, e.param_pca_groups, x)
              if e.parameterTrafoPCA_ else x)
        ls = np.exp(_np(stt.params["log_ls"]))
        amp = np.exp(_np(stt.params["log_amp"]))
        noise = np.exp(_np(stt.params["log_noise"]))
        xt = _np(stt.x)
        av = _np(stt.alpha_vec)
        linv = _np(stt.linv)
        a, cov_trunc = e.lowrank_parts()
        a = np.asarray(a, np.float64)
        cov_trunc = np.asarray(cov_trunc, np.float64)
        npc = av.shape[0]
        mean = np.zeros((len(x), i1 - i0))
        gv = np.zeros((len(x), npc))
        for k in range(npc):
            xs = xt / ls[k]
            qs = xq / ls[k]
            d2 = np.maximum(
                np.sum(xs**2, 1)[:, None] + np.sum(qs**2, 1)[None, :]
                - 2 * xs @ qs.T, 0,
            )
            kstar = amp[k] * np.exp(-0.5 * d2)
            mean += np.outer(kstar.T @ av[k], a[k])
            # k*^T K^-1 k* = |G k*|^2 (K^-1 = G^T G): O(n^2) per query
            # column, where forming K^-1 would cost O(n^3) per GP
            gk = linv[k] @ kstar
            gv[:, k] = np.maximum(amp[k] + noise[k] - np.sum(gk * gk, 0), 0)
        mean += np.asarray(e.scaler.mean, np.float64)
        y = mean - exp_mean_full[i0:i1]
        c0 = cov_trunc + np.diag(exp_var_full[i0:i1])
        for i in range(len(x)):
            cov = (a.T * gv[i]) @ a + c0
            chol = np.linalg.cholesky(cov)
            alpha = np.linalg.solve(cov, y[i])
            lp64[i] += -0.5 * y[i] @ alpha - np.log(np.diag(chol)).sum()
    return lp64
