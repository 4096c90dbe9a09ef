"""Flow-preconditioned sequential Monte Carlo (pocoMC-parity sampler).

PyTorch port of the JAX package's ``samplers/smc.py``: an
adaptive-temperature SMC sampler with persistent sampling, whose MCMC moves
run in the latent space of a normalizing flow fit to the current particles.

1.  ``n_prior`` particles from the prior, in unbounded coordinates
    ``u = logit((x - lo) / (hi - lo))`` (the ``finite=True`` likelihood
    contract: flows cannot digest -inf).
2.  Every particle ever produced is kept; its weight toward the target
    ``L^beta pi`` uses the balance heuristic over the mixture of all past
    iteration distributions (:func:`_mixture_terms`).
3.  ``beta`` anneals 0 -> 1, chosen by bisection so that the weight ESS
    over the whole history equals ``n_effective``.
4.  Each iteration resamples ``n_active`` particles from the weighted
    history, fits the flow to them (:func:`.flows.fit_flow`), fits the
    latent Student-t dof (``sample="tpcn"``) and moves them by
    t-preconditioned Crank-Nicolson (``"pcn"``: Gaussian; ``"rwm"``:
    latent random walk) until the mean latent correlation with the start
    falls below 0.75 or ``n_max_steps``.
5.  At ``beta = 1`` iterations go on until the history ESS reaches
    ``n_total``.
6.  Evidence: the persistent-sampling estimate with a batch-bootstrap
    error, refined by importance sampling from a defensive mixture of a
    moment-matched multivariate t and the box prior, Pareto-smoothed
    (PSIS, with its tail index ``khat``), and an optimal-bridge
    diagnostic; :func:`_select_evidence` picks the primary pair.

Device and host: the flow fit, the dof fit and the MCMC moves run on the
device; the MCMC phase is a host loop that reads one number per step (the
latent correlation that decides the stop), and the flow fit reads its stop
flag every few steps.  The history, the weights, the temperature
bisection and the evidence are float64 numpy on the host, copied from the
JAX package, so every sum over log-likelihoods is taken in float64.
All device randomness comes from one ``torch.Generator`` seeded with
``seed``; the host's from one numpy generator with the same seed.  The
checkpoint pickles both generators' states with the history and the flow,
so that a resumed run is bit for bit the uninterrupted one.
"""

from __future__ import annotations

import inspect
import logging
import time
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..config import new_generator, resolve_device, resolve_dtype
from .ensemble import derive_seed
from .flows import Flow, FlowConfig, fit_flow

logger = logging.getLogger(__name__)

# stop the adaptive MCMC phase once the mean latent-space correlation with
# the phase-start positions decays below this (pocoMC's mixing criterion)
_CORR_STOP = 0.75

# flow-fit steps between two reads of the patience stop flag
_FIT_CHECK_EVERY = 8


# ---------------------------------------------------------------- transforms


def _to_unbounded(x, lo, hi):
    p = torch.clamp((x - lo) / (hi - lo), 1e-7, 1 - 1e-7)
    return torch.log(p) - torch.log1p(-p)


def _to_bounded(u, lo, hi):
    """u -> x plus log |dx/du| (per sample)."""
    x = lo + (hi - lo) * torch.sigmoid(u)
    logdet = (torch.log(hi - lo) + F.logsigmoid(u) + F.logsigmoid(-u)).sum(-1)
    return x, logdet


# host (numpy) twins for the driver loop
def _to_unbounded_np(x, lo, hi):
    p = np.clip((x - lo) / (hi - lo), 1e-7, 1 - 1e-7)
    return np.log(p) - np.log1p(-p)


def _log_sigmoid_np(u):
    return -np.logaddexp(0.0, -u)


def _to_bounded_np(u, lo, hi):
    from scipy.special import expit  # overflow-stable sigmoid

    x = lo + (hi - lo) * expit(u)
    logdet = np.sum(np.log(hi - lo) + _log_sigmoid_np(u) + _log_sigmoid_np(-u), axis=-1)
    return x, logdet


# -------------------------------------------------------------- core kernels


@torch.no_grad()
def _eval_u(log_likelihood, log_prior_fn, state, u, lo, hi, log_prior_x):
    """u-space particle evaluation: returns (x, logl, logp_u, logp_x).

    ``logp_u = log p_x(x) + log|dx/du|``; with no custom prior log p_x is
    the uniform-box constant, else ``log_prior_fn(x)`` floored at -1e30 so
    the flow and pCN arithmetic never see -inf."""
    x, logdet_xu = _to_bounded(u, lo, hi)
    logl = log_likelihood(state, x, True)
    if log_prior_fn is None:
        logp_x = torch.full(u.shape[:1], log_prior_x, dtype=u.dtype, device=u.device)
    else:
        logp_x = torch.clamp(log_prior_fn(x), min=-1e30)
    return x, logl, logp_x + logdet_xu, logp_x


def _t_logpdf(z2, nu, d: int):
    """log density (up to const) of a standard multivariate t with dof nu,
    as a function of |z|^2."""
    return -0.5 * (nu + d) * torch.log1p(z2 / nu)


_DOF_GRID = (3.0, 5.0, 8.0, 12.0, 20.0, 50.0, 1e6)


@torch.no_grad()
def _estimate_dof(z):
    """Max-likelihood dof of a standard multivariate t over a small grid
    (nu = 1e6 is about Gaussian).  The nu-only normalization is computed in
    float64 on the host: in float32 its ~1e6-sized terms round by as much
    as the O(1) gaps between grid points."""
    from scipy.special import gammaln

    d = z.shape[1]
    grid_np = np.asarray(_DOF_GRID, dtype=np.float64)
    const = gammaln((grid_np + d) / 2) - gammaln(grid_np / 2) - 0.5 * d * np.log(grid_np)
    grid = torch.as_tensor(grid_np, dtype=z.dtype, device=z.device)
    const = torch.as_tensor(const, dtype=z.dtype, device=z.device)
    z2 = (z**2).sum(1)
    lls = const - 0.5 * (grid + d) * torch.log1p(z2[None, :] / grid[:, None]).mean(1)
    return grid[torch.argmax(lls)]


@torch.no_grad()
def _mcmc_adaptive(log_likelihood, log_prior_fn, state, flow, u, logl, logp_u, beta,
                   rho, nu, gen, lo, hi, log_prior_x, n_max_steps, *, kernel: str):
    """Adaptive-length MCMC phase in flow-latent space.

    Target in z: ``beta logl + logp_u + log|du/dz|``.  ``tpcn``/``pcn``:
    t-preconditioned Crank-Nicolson, the per-particle scale drawn from
    ``s | z ~ InvGamma((nu + d)/2, (nu + |z|^2)/2)`` and ``z' = sqrt(1 -
    rho^2) z + rho sqrt(s) xi``, which preserves t_nu(0, I), so the MH
    ratio uses ``log pi(z) - log t_nu(z)``; ``rwm``: ``z' = z + rho xi``.
    Steps go on until the mean per-dimension correlation between the
    current and the starting latent positions falls below 0.75 (at least
    2 steps), at most ``n_max_steps``; one read of that correlation per
    step.  ``rho`` adapts toward acceptance 0.234.  Returns ``(u, logl,
    logp_u, logp_x, rho, steps, mean_accept)``.
    """
    n, d = u.shape
    z0, logdet_zu = flow(u)
    z0_mean = z0.mean(0)
    z0_sd = z0.std(0, correction=0) + 1e-12

    def lfun(logl_v, logp_u_v, logdet_uz_v, z):
        base = beta * logl_v + logp_u_v + logdet_uz_v
        if kernel == "rwm":
            return base
        return base - _t_logpdf((z**2).sum(-1), nu, d)

    def corr_with_start(z):
        zs = z.std(0, correction=0) + 1e-12
        c = ((z0 - z0_mean) * (z - z.mean(0))).mean(0) / (z0_sd * zs)
        return c.abs().mean()

    z, logl_c, logp_c, logdet_c = z0, logl, logp_u, -logdet_zu
    acc_sum = torch.zeros((), dtype=u.dtype, device=u.device)
    steps, corr = 0, 1.0
    shape = torch.full((n,), 0.5, dtype=u.dtype, device=u.device) * (nu + d)
    while steps < n_max_steps and (corr > _CORR_STOP or steps < 2):
        xi = torch.randn(z.shape, generator=gen, dtype=z.dtype, device=z.device)
        if kernel == "rwm":
            zp = z + rho * xi
        else:
            g = torch._standard_gamma(shape, generator=gen)
            s = 0.5 * (nu + (z**2).sum(-1)) / g
            zp = torch.sqrt(1.0 - rho**2) * z + rho * torch.sqrt(s)[:, None] * xi
        up, logdet_uzp = flow.inverse(zp)
        _, logl_p, logp_p, _ = _eval_u(log_likelihood, log_prior_fn, state, up, lo, hi,
                                       log_prior_x)
        log_a = lfun(logl_p, logp_p, logdet_uzp, zp) - lfun(logl_c, logp_c, logdet_c, z)
        uu = torch.rand((n,), generator=gen, dtype=z.dtype, device=z.device)
        accept = torch.log(uu) < log_a
        z = torch.where(accept[:, None], zp, z)
        logl_c = torch.where(accept, logl_p, logl_c)
        logp_c = torch.where(accept, logp_p, logp_c)
        logdet_c = torch.where(accept, logdet_uzp, logdet_c)
        rate = accept.to(z.dtype).mean()
        rho = torch.clamp(rho * torch.exp(0.5 * (rate - 0.234)), 1e-4, 0.99)
        acc_sum = acc_sum + rate
        steps += 1
        corr = float(corr_with_start(z))
    u, _ = flow.inverse(z)
    _, logdet_xu = _to_bounded(u, lo, hi)
    return u, logl_c, logp_c, logp_c - logdet_xu, rho, steps, acc_sum / max(steps, 1)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _smc_iteration(log_likelihood, log_prior_fn, state, flow, flow_weights, u_act,
                   logl_act, logp_u_act, beta, rho, gen, lo, hi, log_prior_x,
                   n_max_steps, steps_fit, *, kernel: str, patience: int):
    """One SMC iteration: flow fit -> dof estimate -> adaptive MCMC.

    Returns ``(u, logl, logp_x, rho, stats)`` with ``stats`` a dict of the
    MCMC steps, mean acceptance, flow loss, rho, flow-fit steps and the
    seconds of the fit and of the MCMC phase."""
    dev = u_act.device
    t0 = time.perf_counter()
    fit_stats = {}
    with torch.enable_grad():
        flow_loss = fit_flow(flow, u_act, flow_weights, steps_fit, patience=patience,
                             check_every=_FIT_CHECK_EVERY, stats=fit_stats)
    _sync(dev)
    t1 = time.perf_counter()
    with torch.no_grad():
        if kernel == "tpcn":
            nu = _estimate_dof(flow(u_act)[0])
        else:
            nu = torch.tensor(1e6, dtype=u_act.dtype, device=dev)
    u, logl, _, logp_x, rho, steps, acc = _mcmc_adaptive(
        log_likelihood, log_prior_fn, state, flow, u_act, logl_act, logp_u_act, beta,
        rho, nu, gen, lo, hi, log_prior_x, n_max_steps,
        kernel="rwm" if kernel == "rwm" else "tpcn",
    )
    _sync(dev)
    stats = {"steps": steps, "accept": float(acc), "flow_loss": float(flow_loss),
             "rho": float(rho), "fit_steps": fit_stats["steps"], "fit_s": t1 - t0,
             "mcmc_s": time.perf_counter() - t1}
    return u, logl, logp_x, rho, stats


# --------------------------------------------- persistent-sampling weights


def _mixture_terms(logl_h, betas, logzs, counts):
    """Beta-INDEPENDENT pieces of the balance-heuristic weights.

    ``logl_h (N,)``: history log-likelihoods; ``betas/logzs/counts (T,)``:
    per-iteration inverse temperature, evidence estimate, particle count.
    Returns ``(logl_clean (N,), log_mix (N,))`` with
    ``log w_j(beta) = beta * logl_clean_j - log_mix_j`` -- the prior density
    cancels between the target and every mixture component (see module
    docstring).  Computed ONCE per SMC iteration; the beta bisection then
    reuses it across its ~60 ESS evaluations (the (N, T) matrix does not
    depend on the query beta).
    """
    # nan=-1e300 too: a NaN likelihood particle must get ~zero weight, not
    # logl=0 (which would dominate every real, strongly negative particle)
    logl_h = np.nan_to_num(
        np.asarray(logl_h, dtype=np.float64), nan=-1e300, neginf=-1e300
    )
    betas = np.asarray(betas, dtype=np.float64)
    logzs = np.asarray(logzs, dtype=np.float64)
    counts = np.asarray(counts, dtype=np.float64)
    n_total = counts.sum()
    # (N, T): log[(n_t/N) * exp(beta_t * logl_j - logZ_t)]
    comp = (
        logl_h[:, None] * betas[None, :]
        - logzs[None, :]
        + np.log(counts / n_total)[None, :]
    )
    m = comp.max(axis=1)
    log_mix = m + np.log(np.sum(np.exp(comp - m[:, None]), axis=1))
    return logl_h, log_mix


def _log_weights(logl_clean, log_mix, beta):
    """Balance-heuristic log-weights at ``beta`` from the precomputed
    :func:`_mixture_terms` pieces (the (N, T) mixture matrix is
    beta-independent and reused across the bisection's ESS evaluations)."""
    return beta * logl_clean - log_mix


def _ess(log_w):
    log_w = log_w - np.max(log_w)
    w = np.exp(log_w)
    return (w.sum() ** 2) / np.sum(w**2)


def _next_beta(logl_clean, log_mix, beta, n_effective):
    """Largest beta' in [beta, 1] whose history-weight ESS >= n_effective.

    Takes the precomputed :func:`_mixture_terms`.  Returns ``beta``
    unchanged when even the current temperature cannot support the target
    ESS -- the iteration then only accumulates particles
    (persistent-sampling behavior)."""
    def ess_at(b):
        return _ess(b * logl_clean - log_mix)

    if ess_at(beta) < n_effective:
        return beta
    if ess_at(1.0) >= n_effective:
        return 1.0
    lo_b, hi_b = beta, 1.0
    for _ in range(60):
        mid = 0.5 * (lo_b + hi_b)
        if ess_at(mid) >= n_effective:
            lo_b = mid
        else:
            hi_b = mid
    return lo_b


def _ps_logz_err(lw1, counts, rng, n_boot: int = 256) -> float:
    """Batch-bootstrap standard error of the persistent-sampling logZ.

    ``logZ_PS = log((1/N) sum_j w_j)`` over the full history.  History
    particles are correlated WITHIN an iteration batch (each batch is one
    MCMC phase over jointly resampled particles) and approximately
    independent ACROSS batches, so the bootstrap resamples whole iteration
    batches: draw T batch indices with replacement, form
    ``Z* = sum_t S_t* / sum_t n_t*`` from the per-batch weight sums, and
    report ``std(log Z*)``.  This replaces the earlier ad-hoc
    ``sqrt(sum w^2 - 1/n)`` (which was an ESS diagnostic, not a variance of
    logZ).  Conditioned on the realized annealing path; the repeat-seed
    calibration test (test_smc.py) bounds the total scatter against this
    error.
    """
    lw1 = np.asarray(lw1, dtype=np.float64)
    w = np.exp(lw1 - lw1.max())
    bounds = np.cumsum([0] + list(counts))
    s_t = np.array([w[a:b].sum() for a, b in zip(bounds[:-1], bounds[1:])])
    n_t = np.asarray(counts, dtype=np.float64)
    n_batches = len(n_t)
    idx = rng.integers(0, n_batches, size=(n_boot, n_batches))
    z_boot = s_t[idx].sum(axis=1) / n_t[idx].sum(axis=1)
    z_boot = np.maximum(z_boot, 1e-300)
    return float(np.std(np.log(z_boot)))


# PSIS reliability ceiling: a fitted GPD tail index above this means the
# importance-weight distribution has too heavy a right tail for the
# estimate (and its delta-method error) to be trusted (Vehtari et al.,
# "Pareto Smoothed Importance Sampling", JMLR 2024 -- k < 0.7 is the
# published finite-variance-in-practice threshold)
EVIDENCE_KHAT_MAX = 0.7


def _gpd_fit(x: np.ndarray) -> tuple[float, float]:
    """Fit a generalized Pareto (k, sigma) to exceedances ``x`` (ascending).

    Zhang & Stephens (2009) profile-posterior estimator (the method the
    PSIS paper prescribes): parametrize by ``b = k / sigma``, place the
    quantile-derived grid prior on ``b``, weight grid points by profile
    likelihood, and read ``k`` from the posterior-mean ``b``.  A weak
    Gaussian prior ``k ~ N(0.5, 1/sqrt(2 n))`` regularizes small tails.
    """
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    prior_bs, prior_k = 3.0, 10.0
    m_est = 30 + int(np.sqrt(n))
    b = 1.0 - np.sqrt(m_est / (np.arange(1, m_est + 1, dtype=np.float64) - 0.5))
    b /= prior_bs * x[max(int(n / 4 + 0.5) - 1, 0)]
    b += 1.0 / x[-1]
    k = np.mean(np.log1p(-b[:, None] * x), axis=1)
    log_lik = n * (np.log(-b / k) - k - 1.0)
    w = 1.0 / np.sum(np.exp(log_lik - log_lik[:, None]), axis=1)
    keep = w >= 10 * np.finfo(float).eps
    b, w = b[keep], w[keep]
    b_post = np.sum(b * w / w.sum())
    k_post = float(np.mean(np.log1p(-b_post * x)))
    sigma = -k_post / b_post
    k_post = (n * k_post + prior_k * 0.5) / (n + prior_k)
    return float(k_post), float(sigma)


def _psis_smooth(log_w: np.ndarray) -> tuple[np.ndarray, float]:
    """Pareto-smoothed importance weights plus the tail index ``khat``.

    Fits a GPD to the ``M = min(n/5, 3 sqrt(n))`` largest weights
    (exceedances over the (n-M)-th order statistic) and replaces them with
    the expected order statistics of the fit, capped at the raw maximum
    (Vehtari et al. 2024, algorithm 1).  Smoothing tames the variance the
    heaviest realized weights inject; ``khat`` diagnoses whether the tail
    was represented at all (``khat > 0.7`` = unreliable).  Returns the
    input unchanged with ``khat = nan`` when the tail is too small to fit
    (< 5 points) or degenerate (all exceedances equal).
    """
    log_w = np.asarray(log_w, dtype=np.float64)
    n = log_w.shape[0]
    # the tail is sized from the FINITE weight count: with many exact-zero
    # (-inf) draws a count-based tail would reach into them, and the GPD
    # smoothing would fabricate positive mass for draws that contributed
    # none (clamped 1e-300 pseudo-exceedances), biasing logz_is upward
    n_fin = int(np.isfinite(log_w).sum())
    m_tail = min(n_fin // 5, int(3.0 * np.sqrt(n_fin)))
    if m_tail < 5:
        return log_w, float("nan")
    order = np.argsort(log_w)
    tail_idx = order[n - m_tail:]
    log_max = log_w[order[-1]]
    if not np.isfinite(log_max):
        return log_w, float("nan")
    # weight space, scaled so the max raw weight is 1 (overflow-safe)
    w_tail = np.exp(log_w[tail_idx] - log_max)
    cutoff = np.exp(log_w[order[n - m_tail - 1]] - log_max)
    exceed = w_tail - cutoff
    if exceed[-1] <= 0 or not np.all(np.isfinite(exceed)):
        return log_w, float("nan")
    k, sigma = _gpd_fit(np.maximum(exceed, 1e-300))
    if not np.isfinite(k) or sigma <= 0:
        return log_w, float("nan")
    # expected order statistics of the fitted GPD, capped at the raw max
    p = (np.arange(1, m_tail + 1) - 0.5) / m_tail
    if abs(k) < 1e-12:
        q = -sigma * np.log1p(-p)
    else:
        q = sigma / k * (np.power(1.0 - p, -k) - 1.0)
    smoothed = np.minimum(cutoff + q, 1.0)
    out = log_w.copy()
    out[tail_idx] = np.log(smoothed) + log_max
    return out, float(k)


def _fit_t_proposal(u_hist, log_w, dof: float) -> dict:
    """Moment-matched multivariate-Student-t evidence proposal (host f64).

    Fit on the WEIGHTED history (normalized ``log_w``): mean + covariance,
    with the t scale matrix set to ``cov * (dof - 2) / dof`` so the
    proposal's covariance exactly matches the posterior's while its tails
    stay heavier (``dof`` <= 2 keeps the raw covariance as the scale).

    An ANALYTIC proposal by design: evidence round 5 measured the refit
    FLOW memorizing its (duplicate-laden) fit resample -- log q read
    +6.4 nats higher at fit particles than at held-out posterior
    particles -- which biased every flow-based evidence estimator low
    (flagship: IS stuck at ~754.8 vs the true ~760.3 across rounds 3-5).
    A closed-form t cannot memorize points, its density is exact, and
    the bridge estimator only needs overlap, which moment matching
    guarantees.  Degenerate weighted covariances fall back to their
    diagonal (+ jitter).
    """
    log_w = np.asarray(log_w, np.float64)
    w = np.exp(log_w - log_w.max())
    w = w / w.sum()
    u_hist = np.asarray(u_hist, np.float64)
    mu = w @ u_hist
    du = u_hist - mu
    cov = (du * w[:, None]).T @ du
    d = u_hist.shape[1]
    cov = cov + 1e-10 * np.trace(cov) / d * np.eye(d) + 1e-12 * np.eye(d)
    scale = cov * ((dof - 2.0) / dof) if dof > 2.0 else cov
    try:
        chol = np.linalg.cholesky(scale)
    except np.linalg.LinAlgError:
        chol = np.sqrt(np.diag(np.maximum(np.diag(scale), 1e-12)))[
            :, None
        ] * np.eye(d)
    return {
        "mu": mu,
        "chol": chol,
        "dof": float(dof),
        "logdet": float(2.0 * np.sum(np.log(np.diag(chol)))),
    }


def _t_proposal_draw(rng, prop: dict, n: int) -> np.ndarray:
    """n iid draws from the fitted multivariate t (host numpy)."""
    d = prop["mu"].shape[0]
    xi = rng.standard_normal((n, d))
    w_chi2 = 2.0 * rng.standard_gamma(0.5 * prop["dof"], n)
    z = xi * np.sqrt(prop["dof"] / w_chi2)[:, None]
    return prop["mu"] + z @ prop["chol"].T


def _t_proposal_logpdf(prop: dict, u) -> np.ndarray:
    """Exact log density of the fitted multivariate t at ``u`` (host)."""
    from scipy.special import gammaln

    from scipy.linalg import solve_triangular

    u = np.asarray(u, np.float64)
    d = prop["mu"].shape[0]
    nu = prop["dof"]
    z = solve_triangular(prop["chol"], (u - prop["mu"]).T, lower=True)
    m2 = np.sum(z * z, axis=0)
    const = (
        gammaln(0.5 * (nu + d))
        - gammaln(0.5 * nu)
        - 0.5 * d * np.log(nu * np.pi)
        - 0.5 * prop["logdet"]
    )
    return const - 0.5 * (nu + d) * np.log1p(m2 / nu)


def _bridge_logz(lw_q, lw_p, logz0, n_iter: int = 200, tol: float = 1e-10):
    """Optimal-bridge (Meng & Wong 1996) log-evidence.

    ``lw_q``: ``log[L(x) pi(x) / q(x)]`` at iid PROPOSAL draws;
    ``lw_p``: the same quantity at (approximately unweighted) POSTERIOR
    draws; ``logz0``: initialization.  Iterates the self-consistent
    optimal bridge ``Z = E_q[l h] / E_p[h]`` with
    ``h = 1 / (s1 l + s2 Z)`` in log space.

    Robust exactly where raw importance sampling fails: both integrands
    are BOUNDED (``l h <= 1/s1`` on the q side, ``h <= 1/(s2 Z)`` on the
    p side), so a flow proposal that under-covers the posterior costs
    statistical efficiency, not correctness -- only support OVERLAP is
    required, which the posterior-weighted flow refit guarantees.
    Returns nan when the iteration fails to converge or either sample
    set is empty.
    """
    from scipy.special import logsumexp

    # +-inf values are REAL draws with exact 0 / bounded contributions
    # (l = 0 on the q side contributes nothing to the numerator; l = inf
    # on the p side means q underflowed there and h = 0): they stay in
    # the sample COUNTS and fall out of the sums naturally.  Dropping
    # them (an earlier revision filtered all non-finite) biases the
    # estimate -- removing h ~ 0 posterior terms inflates the
    # denominator mean and pushed the flagship bridge 15 log-units low.
    # Only NaN (arithmetic garbage) is removed.
    lw_q = np.asarray(lw_q, np.float64)
    lw_p = np.asarray(lw_p, np.float64)
    lw_q = lw_q[~np.isnan(lw_q)]
    lw_p = lw_p[~np.isnan(lw_p)]
    n2, n1 = lw_q.shape[0], lw_p.shape[0]
    if n1 == 0 or n2 == 0 or not np.isfinite(logz0):
        return float("nan")
    ls1 = np.log(n1 / (n1 + n2))
    ls2 = np.log(n2 / (n1 + n2))
    logz = float(logz0)
    with np.errstate(invalid="ignore"):
        for _ in range(n_iter):
            # inf - inf in the q-side term means l = inf there: the
            # integrand limit is 1/s1 -- substitute it exactly
            tq = lw_q - np.logaddexp(ls1 + lw_q, ls2 + logz)
            tq = np.where(np.isposinf(lw_q), -ls1, tq)
            num = logsumexp(tq) - np.log(n2)
            den = logsumexp(
                -np.logaddexp(ls1 + lw_p, ls2 + logz)
            ) - np.log(n1)
            new = num - den
            if not np.isfinite(new):
                return float("nan")
            if abs(new - logz) < tol:
                return float(new)
            logz = new
    return float("nan")


def _bridge_err(lw_q, lw_p, logz, rng, n_boot: int = 64) -> float:
    """Bootstrap standard error of the bridge estimate: resample both
    draw sets with replacement (duplicated posterior-resample entries
    appear in the array, so the bootstrap sees their variance cost) and
    re-run the iteration from the converged value."""
    lw_q = np.asarray(lw_q, np.float64)
    lw_p = np.asarray(lw_p, np.float64)
    lw_q = lw_q[~np.isnan(lw_q)]
    lw_p = lw_p[~np.isnan(lw_p)]
    boots = []
    for _ in range(n_boot):
        bq = lw_q[rng.integers(0, len(lw_q), len(lw_q))]
        bp = lw_p[rng.integers(0, len(lw_p), len(lw_p))]
        z = _bridge_logz(bq, bp, logz, n_iter=100)
        if np.isfinite(z):
            boots.append(z)
    if len(boots) < max(8, n_boot // 4):
        return float("nan")
    return float(np.std(boots))



# PSIS error-inflation factor for khat > EVIDENCE_KHAT_MAX: the
# delta-method error under-reports when the weight tail is heavy
# (Vehtari et al.: errors unreliable past 0.7); measured flagship seed
# scatter (+potential residual bias) sits ~3x the claimed error there
EVIDENCE_KHAT_ERR_INFLATE = 3.0


def _select_evidence(logz_ps, err_ps, logz_is, err_is, khat=None):
    """Primary-evidence selection between the persistent-sampling and the
    (PSIS-smoothed, defensive-proposal) importance-sampling estimates.

    History of the design, all measured on the 17-dim flagship: the
    round-3/4 failure mode was an IS estimate biased LOW with a
    confidently small delta-method error (754.8 vs PS 760.3; root cause
    -- flow memorization of the fit resample -- fixed in round 5 by the
    analytic proposal).  The primary guard is therefore the **3-sigma
    cross-check against PS**: a refinement that disagrees beyond the
    combined errors is dropped and, since one of the two claimed errors
    is then provably too small, PS is returned with its error inflated
    to half the gap.  ``khat`` (the PSIS generalized-Pareto tail index)
    plays a calibration role rather than a hard gate: past
    :data:`EVIDENCE_KHAT_MAX` the delta-method error under-reports, so
    the IS error is inflated by :data:`EVIDENCE_KHAT_ERR_INFLATE` before
    the cross-check and in the primary pair when IS is selected (a hard
    khat gate was measured too trigger-happy: flagship khat realizations
    straddle 0.7-1.2 seed to seed while the PSIS estimate itself is
    stable at +-0.2; ``logz_err_is`` stays the raw delta-method error
    with ``logz_khat`` reported alongside).  The smallest-error
    surviving candidate wins.

    The bridge estimate is NOT a selection candidate: asymptotically its
    bounded integrands make it undercoverage-proof, but at flagship
    sample sizes it showed a reproducible finite-sample bias
    (758.4 +- 0.05 bootstrap across seeds vs the 760.3-761.3 cluster of
    PS/IS -- the q-weight tail mass it effectively truncates) with a
    bootstrap error blind to that bias.  It is reported as a diagnostic
    (``logz_bridge``) only.

    Returns ``(logz, logz_err, source, is_unreliable)`` with source in
    {"ps", "is"}; ``is_unreliable`` is True exactly when a refinement
    was attempted and none survived the cross-check (the caller's
    warning keys off it so the tolerance rule lives in one place).
    """
    cands = [(float(err_ps), 0, "ps", float(logz_ps))]
    attempted = False
    disagreement_gaps = []
    if logz_is is not None and err_is is not None:
        attempted = True
        err_eff = float(err_is)
        if khat is not None and np.isfinite(khat) and khat > EVIDENCE_KHAT_MAX:
            err_eff *= EVIDENCE_KHAT_ERR_INFLATE
        gap = abs(float(logz_is) - float(logz_ps))
        if gap <= 3.0 * float(np.hypot(err_eff, err_ps)):
            cands.append((err_eff, 1, "is", float(logz_is)))
        else:
            disagreement_gaps.append(gap)
    if len(cands) == 1 and attempted:
        err = float(err_ps)
        if disagreement_gaps:
            err = max(err, 0.5 * max(disagreement_gaps))
        return float(logz_ps), err, "ps", True
    err, _, source, val = min(cands)
    return val, err, source, False


def _rvs_takes_random_state(rvs) -> bool:
    """Whether ``rvs`` accepts ``random_state`` (by name or through
    ``**kwargs``), read from its signature."""
    try:
        params = inspect.signature(rvs).parameters.values()
    except (TypeError, ValueError):  # no signature to read (builtins)
        return False
    return any(p.name == "random_state" or p.kind is inspect.Parameter.VAR_KEYWORD
               for p in params)


def _draw_prior_in_box(custom_prior, rng, n, lo_np, hi_np):
    """Draw ``n`` prior samples strictly inside the box.

    Uniform-box prior (``custom_prior is None``): direct draws, mass
    fraction 1.  Custom prior: rejection-sampled into the box (clipping
    would pile draws onto the faces and bias every importance weight); the
    accepted fraction estimates the prior mass inside the box.  The draws
    come from the run's generator when the prior's ``rvs`` takes
    ``random_state`` (read from its signature; an error inside ``rvs``
    propagates), and from the prior's own stream otherwise, which is then
    only reproducible if seeded by the caller.  Returns ``(draws (n, d),
    frac_in)``.
    """
    if custom_prior is None:
        return rng.uniform(lo_np, hi_np, (n, lo_np.shape[0])), 1.0
    seeded = _rvs_takes_random_state(custom_prior.rvs)
    if not seeded:
        logger.warning("custom_prior.rvs takes no random_state: its draws are not "
                       "tied to the run's seed")
    kept, n_try, n_in = [], 0, 0
    while sum(a.shape[0] for a in kept) < n:
        if n_try >= 1000 * n:
            raise ValueError(
                "custom_prior places less than ~0.1% of its mass inside "
                "the sampling box [prior_lo, prior_hi]; check the "
                "parameter ranges against the prior"
            )
        draw = custom_prior.rvs(n, random_state=rng) if seeded else custom_prior.rvs(n)
        draw = np.atleast_2d(np.asarray(draw))
        m = np.all((draw > lo_np) & (draw < hi_np), axis=1)
        n_try += draw.shape[0]
        n_in += int(m.sum())
        kept.append(draw[m])
    x = np.concatenate(kept, axis=0)[:n]
    # the margin only guards the logit against exact-boundary round-off
    x = np.clip(x, lo_np + 1e-9, hi_np - 1e-9)
    return x, n_in / n_try


def _systematic_resample(rng, log_w, n):
    """Indices of a systematic resample from LOG-weights (the JAX package's
    ``utils.closure.systematic_resample_indices`` on the exponentiated,
    max-shifted weights)."""
    log_w = np.nan_to_num(np.asarray(log_w, dtype=np.float64), nan=-1e300, neginf=-1e300)
    w = np.exp(log_w - log_w.max())
    if not np.all(np.isfinite(w)) or np.any(w < 0) or w.sum() <= 0:
        raise ValueError("weights must be finite, nonnegative, and sum to > 0")
    w = w / w.sum()
    positions = (rng.random() + np.arange(n)) / n
    return np.searchsorted(np.cumsum(w), positions).clip(0, len(w) - 1)


# --------------------------------------------------------- checkpoint/resume


def _save_smc_checkpoint(path, payload: dict) -> None:
    """Atomic pickle write (tmp + rename): a kill mid-write must leave
    either the previous checkpoint or the new one, never a torn file."""
    import os
    import pickle

    path = str(path)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, path)


def _load_smc_checkpoint(path, expect_knobs: dict):
    """Load + validate an SMC checkpoint; raises on a knob mismatch (a
    resumed run with different particle counts / kernel / seed would
    silently corrupt the persistent-sampling mixture weights)."""
    import pickle

    with open(path, "rb") as f:
        payload = pickle.load(f)
    got = payload.get("knobs", {})
    bad = {
        k: (got.get(k), v) for k, v in expect_knobs.items()
        if got.get(k) != v
    }
    if bad:
        raise ValueError(
            f"SMC checkpoint at {path} was written with different settings "
            f"(stored vs requested): {bad}; delete the checkpoint or rerun "
            "with the original knobs"
        )
    return payload


# -------------------------------------------------------------------- driver


def run_smc(
    log_likelihood: Callable,
    prior_lo,
    prior_hi,
    *,
    likelihood_state=None,
    n_effective: int = 1000,
    n_active: int = 250,
    n_prior: int = 2000,
    sample: str = "tpcn",
    n_max_steps: int = 200,
    n_total: int = 5000,
    n_evidence: int = 5000,
    seed: int = 42,
    custom_prior=None,
    flow_config: FlowConfig = FlowConfig(),
    flow_fit_steps: int = 300,
    flow_fit_steps_warm: int | None = None,
    flow_fit_patience: int = 25,
    max_iterations: int = 400,
    evidence_defensive_frac: float = 0.1,
    evidence_base_dof: float = 5.0,
    checkpoint_path=None,
    resume: bool = False,
    mesh=None,
    device=None,
    dtype=None,
    stats: list | None = None,
) -> dict:
    """Run the preconditioned SMC sampler (see the module docstring).

    ``log_likelihood(state, x, finite)`` maps an (m, d) tensor to (m,) and
    must return finite values outside the box when ``finite`` is true.
    ``prior_lo``/``prior_hi`` bound the box.  ``custom_prior``: ``None``
    is the uniform box; otherwise an object with ``log_prior_torch(x) ->
    (m,)`` and ``rvs`` (see :class:`..utils.priors.ScipyPrior`); a
    numpy-only prior is refused.  ``evidence_defensive_frac`` /
    ``evidence_base_dof``: the share of the ``n_evidence`` draws taken
    from the box prior, and the dof of the moment-matched t.

    ``checkpoint_path``: the full state (history, beta ladder, normalizers,
    both generators' states, the flow, rho) is pickled there after every
    completed iteration; ``resume=True`` continues from it, and the
    resumed evolution is bit for bit the uninterrupted one.  A checkpoint
    written with other knobs is refused.  ``stats``, when given (a list),
    receives one dict per iteration (beta, MCMC steps, flow-fit steps, and
    the seconds of the flow fit, the MCMC phase and the host).

    ``mesh``: a :class:`..parallel.mesh.WalkerMesh` over which every
    likelihood evaluation of the particles (the prior draws, each MCMC
    step, the evidence draws) is sharded, against replicas built once per
    run; ``n_prior``, ``n_active`` and ``n_evidence`` must divide over it.
    The draws, the flow and the host history stay as they are.

    Runs on ``device`` (default CUDA) in ``dtype`` (default float32).
    Returns the weighted posterior (every particle; use ``weights``), its
    log-likelihoods and log-priors and the evidence estimates, with the
    JAX package's keys.
    """
    if sample not in ("pcn", "tpcn", "rwm"):
        raise ValueError(f"unknown sample kernel: {sample}")
    if n_active > n_effective:
        raise ValueError(
            f"n_active ({n_active}) must not exceed n_effective ({n_effective})"
        )
    dev = resolve_device(device)
    dtype = resolve_dtype(dtype)
    state = likelihood_state if likelihood_state is not None else ()
    ll_fn = log_likelihood
    if mesh is not None:
        from ..parallel.mesh import check_divisible, sharded_log_prob

        check_divisible(mesh, n_prior, "n_prior particles")
        check_divisible(mesh, n_active, "n_active particles")
        if n_evidence:
            check_divisible(mesh, n_evidence, "n_evidence draws")
        sharded = sharded_log_prob(log_likelihood, mesh, state)

        def ll_fn(_state, x, finite):
            return sharded(x, finite)
    lo_np = np.asarray(prior_lo.cpu() if torch.is_tensor(prior_lo) else prior_lo, np.float64)
    hi_np = np.asarray(prior_hi.cpu() if torch.is_tensor(prior_hi) else prior_hi, np.float64)
    ndim = lo_np.shape[0]

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    prior_lo, prior_hi = t(lo_np), t(hi_np)
    log_prior_x = float(-np.sum(np.log(hi_np - lo_np)))

    logger.info(
        "SMC (persistent sampling): n_prior=%d, n_active=%d, ESS target %d, "
        "kernel %s", n_prior, n_active, n_effective, sample,
    )
    log_prior_fn = None
    if custom_prior is not None:
        if not hasattr(custom_prior, "log_prior_torch"):
            raise ValueError(
                "custom priors must expose a torch log_prior_torch(x) (see "
                "utils.priors.ScipyPrior for scipy frozen-distribution lists); "
                "a numpy-only logpdf cannot enter the device loop and would "
                "silently be replaced by the uniform box"
            )
        log_prior_fn = custom_prior.log_prior_torch

    # the knobs that shape the resumed evolution, and the box; the evidence
    # knobs and max_iterations may change on resume
    ckpt_knobs = {
        "n_prior": n_prior, "n_active": n_active,
        "n_effective": n_effective, "n_total": n_total,
        "sample": sample, "seed": seed, "ndim": ndim,
        "n_max_steps": n_max_steps,
        "flow_fit_steps": flow_fit_steps,
        "flow_fit_steps_warm": flow_fit_steps_warm,
        "flow_fit_patience": flow_fit_patience,
        "flow_config": str(flow_config),
        "box_lo": tuple(float(v) for v in lo_np),
        "box_hi": tuple(float(v) for v in hi_np),
        "has_custom_prior": custom_prior is not None,
        "dtype": str(dtype),
    }
    restored = None
    if resume and checkpoint_path is not None:
        try:
            restored = _load_smc_checkpoint(checkpoint_path, ckpt_knobs)
        except FileNotFoundError:
            logger.info("resume=True but no SMC checkpoint at %s; starting fresh",
                        checkpoint_path)

    gen = new_generator(dev, seed)
    flow = Flow(ndim, flow_config, seed=derive_seed(seed, 1), dtype=dtype, device=dev)
    if restored is None:
        rng = np.random.default_rng(seed)
        x0, prior_frac_in = _draw_prior_in_box(custom_prior, rng, n_prior, lo_np, hi_np)
        if custom_prior is not None and prior_frac_in < 0.999:
            logger.warning(
                "custom prior has ~%.1f%% of its mass outside the sampling "
                "box; initial draws were rejection-sampled into the box and "
                "the evidence accounts for the truncation (log mass %.4f)",
                100.0 * (1.0 - prior_frac_in), np.log(prior_frac_in),
            )
        u0 = t(_to_unbounded_np(x0, lo_np, hi_np))
        _, logl0, _, logp_x0 = _eval_u(ll_fn, log_prior_fn, state, u0, prior_lo,
                                       prior_hi, log_prior_x)
        # the persistent history, on the host in float64
        u_h = [u0.cpu().numpy().astype(np.float64)]
        logl_h = [logl0.cpu().numpy().astype(np.float64)]
        logp_h = [logp_x0.cpu().numpy().astype(np.float64)]
        # batch 0's component is the prior restricted to the box: its
        # log-normalizer is log(mass inside)
        betas, logzs, counts = [0.0], [float(np.log(prior_frac_in))], [n_prior]
        rho = torch.tensor(0.5, dtype=dtype, device=dev)
        beta = 0.0
        iteration = 0
        total_steps = 0
    else:
        u_h = list(restored["u_h"])
        logl_h = list(restored["logl_h"])
        logp_h = list(restored["logp_h"])
        betas = list(restored["betas"])
        logzs = list(restored["logzs"])
        counts = list(restored["counts"])
        beta = float(restored["beta"])
        iteration = int(restored["iteration"])
        total_steps = int(restored["total_steps"])
        prior_frac_in = float(restored["prior_frac_in"])
        rng = restored["rng"]
        gen.set_state(torch.as_tensor(restored["torch_generator"]))
        rho = torch.as_tensor(restored["rho"], dtype=dtype, device=dev)
        flow.load_state_dict({k: torch.as_tensor(v) for k, v in restored["flow"].items()})
        logger.info(
            "resumed SMC from checkpoint: iteration %d, beta %.4f, %d history particles",
            iteration, beta, sum(a.shape[0] for a in u_h),
        )

    flow_weights = torch.ones(n_active, dtype=dtype, device=dev)

    def save_checkpoint():
        if checkpoint_path is None:
            return
        _save_smc_checkpoint(checkpoint_path, {
            "version": 1,
            "knobs": ckpt_knobs,
            "u_h": u_h, "logl_h": logl_h, "logp_h": logp_h,
            "betas": betas, "logzs": logzs, "counts": counts,
            "beta": beta, "iteration": iteration,
            "total_steps": total_steps,
            "prior_frac_in": prior_frac_in,
            "rng": rng,
            "torch_generator": gen.get_state().numpy(),
            "rho": float(rho),
            "flow": {k: v.cpu().numpy() for k, v in flow.state_dict().items()},
        })

    def history():
        return np.concatenate(logl_h), np.concatenate(u_h)

    def logmeanexp(lw):
        m = lw.max()
        return m + np.log(np.mean(np.exp(lw - m)))

    def run_iteration(beta_target, lw, hl, hu, t_host):
        """Resample n_active from the ``lw``-weighted history, fit the
        flow, move, append."""
        nonlocal rho, total_steps
        idx = _systematic_resample(rng, lw, n_active)
        u_np = hu[idx]
        _, logdet_xu = _to_bounded_np(u_np, lo_np, hi_np)
        warm = flow_fit_steps_warm
        if warm is None:
            # never longer than the cold fit
            warm = min(flow_fit_steps, max(75, flow_fit_steps // 3))
        steps_fit = flow_fit_steps if iteration <= 1 else warm
        u_new, logl_new, logp_x_new, rho, it = _smc_iteration(
            ll_fn, log_prior_fn, state, flow, flow_weights, t(u_np), t(hl[idx]),
            t(np.concatenate(logp_h)[idx] + logdet_xu), beta_target, rho, gen,
            prior_lo, prior_hi, log_prior_x, n_max_steps, steps_fit,
            kernel=sample, patience=flow_fit_patience,
        )
        t1 = time.perf_counter()
        u_h.append(u_new.cpu().numpy().astype(np.float64))
        logl_h.append(logl_new.cpu().numpy().astype(np.float64))
        logp_h.append(logp_x_new.cpu().numpy().astype(np.float64))
        total_steps += it["steps"]
        it.update(iteration=iteration, beta=float(beta_target),
                  host_s=time.perf_counter() - t1 + t_host)
        if stats is not None:
            stats.append(it)
        return it

    # ----------------------------------------------------- annealing phase
    while beta < 1.0 and iteration < max_iterations:
        t0 = time.perf_counter()
        iteration += 1
        hl, hu = history()
        lc, lm = _mixture_terms(hl, betas, logzs, counts)
        beta_new = _next_beta(lc, lm, beta, n_effective)
        lw = _log_weights(lc, lm, beta_new)
        logz_new = logmeanexp(lw)
        it = run_iteration(beta_new, lw, hl, hu, time.perf_counter() - t0)
        betas.append(beta_new)
        logzs.append(logz_new)
        counts.append(n_active)
        beta = beta_new
        logger.info(
            "SMC iter %d: beta=%.4f, steps=%d, accept=%.3f, rho=%.3f, "
            "flow loss=%.2f (%d fit steps), logz=%.3f", iteration, beta, it["steps"],
            it["accept"], it["rho"], it["flow_loss"], it["fit_steps"], logz_new,
        )
        save_checkpoint()
    if beta < 1.0:
        logger.warning("SMC: beta schedule did not converge in %d iterations",
                       max_iterations)

    # ------------------------------------------------- posterior collection
    hl, hu = history()
    while True:
        t0 = time.perf_counter()
        lc, lm = _mixture_terms(hl, betas, logzs, counts)
        lw1 = _log_weights(lc, lm, 1.0)
        ess1 = _ess(lw1)
        if ess1 >= n_total or iteration >= max_iterations:
            break
        iteration += 1
        logz1 = logmeanexp(lw1)
        it = run_iteration(1.0, lw1, hl, hu, time.perf_counter() - t0)
        betas.append(1.0)
        logzs.append(logz1)
        counts.append(n_active)
        logger.info("SMC posterior iter %d: ESS %.0f / %d, steps=%d, accept=%.3f",
                    iteration, ess1, n_total, it["steps"], it["accept"])
        save_checkpoint()
        hl, hu = history()

    hp = np.concatenate(logp_h)
    ess_final = _ess(lw1)
    if iteration >= max_iterations and ess_final < n_total:
        logger.warning(
            "SMC: posterior collection hit max_iterations=%d with history "
            "ESS %.0f below the n_total=%d target; the returned weighted "
            "posterior is valid but less resolved than requested",
            max_iterations, ess_final, n_total,
        )
    logz_ps = logmeanexp(lw1)
    w = np.exp(lw1 - lw1.max())
    weights = w / w.sum()
    x_all = _to_bounded_np(hu, lo_np, hi_np)[0]
    logger.info("SMC done: %d iterations, %d MCMC steps, %d particles, ESS %.0f",
                iteration, total_steps, len(hl), ess_final)

    # ------------------------------------------------------------- evidence
    logz_err_ps = _ps_logz_err(lw1, counts, rng)
    logz, logz_err = logz_ps, logz_err_ps
    logz_is = logz_err_is = logz_khat = None
    logz_bridge = logz_err_bridge = None
    logz_source = "ps"
    if n_evidence and n_evidence > 0:
        # defensive mixture: n_t draws from the moment-matched t fit to the
        # weighted history, n_def from the prior restricted to the box;
        # every draw is scored under both components
        if not 0.0 <= evidence_defensive_frac < 1.0:
            raise ValueError(
                f"evidence_defensive_frac must be in [0, 1), got {evidence_defensive_frac}"
            )
        n_def = int(round(evidence_defensive_frac * n_evidence))
        n_t = n_evidence - n_def
        t_prop = _fit_t_proposal(hu, lw1, float(evidence_base_dof))
        u_parts = []
        if n_t > 0:
            u_parts.append(_t_proposal_draw(rng, t_prop, n_t))
        if n_def > 0:
            x_def, _ = _draw_prior_in_box(custom_prior, rng, n_def, lo_np, hi_np)
            u_parts.append(_to_unbounded_np(x_def, lo_np, hi_np))
        u_all_np = np.concatenate(u_parts, axis=0)
        _, logl_ev, logp_u_ev, _ = _eval_u(ll_fn, log_prior_fn, state, t(u_all_np),
                                           prior_lo, prior_hi, log_prior_x)
        logl_np = logl_ev.cpu().numpy().astype(np.float64)
        logp_u_np = logp_u_ev.cpu().numpy().astype(np.float64)
        log_qt_np = _t_proposal_logpdf(t_prop, u_all_np)

        # the defensive component is p_u(u) / frac_in in u-space
        def mix_logq(log_qt_vals, logp_u_vals):
            comps = []
            if n_t > 0:
                comps.append(np.log(n_t / n_evidence) + log_qt_vals)
            if n_def > 0:
                comps.append(np.log(n_def / n_evidence) + logp_u_vals - np.log(prior_frac_in))
            return comps[0] if len(comps) == 1 else np.logaddexp(comps[0], comps[1])

        log_w_ev = logl_np + logp_u_np - mix_logq(log_qt_np, logp_u_np)
        # non-finite weights carry zero mass
        log_w_ev = np.where(np.isfinite(log_w_ev), log_w_ev, -np.inf)
        if np.all(~np.isfinite(log_w_ev)):
            logger.warning("evidence IS: no finite weights; keeping PS estimate")
        else:
            log_w_sm, khat = _psis_smooth(log_w_ev)
            logz_khat = None if np.isnan(khat) else float(khat)
            m = log_w_sm.max()
            wv = np.exp(log_w_sm - m)
            logz_is = float(m + np.log(np.mean(wv)))
            logz_err_is = float(np.std(wv) / (np.mean(wv) * np.sqrt(n_evidence)))

            # bridge diagnostic: the q side reuses the raw mixture weights,
            # the p side scores a posterior resample of the history under
            # the same mixture (host arithmetic only)
            idx_p = _systematic_resample(rng, lw1, n_evidence)
            u_p_np = hu[idx_p]
            log_qt_p = _t_proposal_logpdf(t_prop, u_p_np)
            logp_u_p = hp[idx_p] + _to_bounded_np(u_p_np, lo_np, hi_np)[1]
            lw_p = hl[idx_p] + logp_u_p - mix_logq(log_qt_p, logp_u_p)
            logz_bridge = _bridge_logz(log_w_ev, lw_p, logz_ps)
            logz_err_bridge = (
                _bridge_err(log_w_ev, lw_p, logz_bridge, rng)
                if np.isfinite(logz_bridge) else float("nan")
            )
            if not (np.isfinite(logz_bridge) and np.isfinite(logz_err_bridge)):
                logz_bridge = logz_err_bridge = None

            logz, logz_err, logz_source, is_unreliable = _select_evidence(
                logz_ps, logz_err_ps, logz_is, logz_err_is, logz_khat
            )

            def fmt(v):
                return "n/a" if v is None else f"{v:.3f}"

            if is_unreliable:
                logger.warning(
                    "evidence: the IS refinement (%s +- %s, khat %s) disagrees "
                    "with the persistent-sampling estimate %.3f +- %.3f beyond "
                    "3 sigma -- reporting the PS estimate with error %.3f "
                    "(bridge diagnostic: %s +- %s)",
                    fmt(logz_is), fmt(logz_err_is), fmt(logz_khat), logz_ps,
                    logz_err_ps, logz_err, fmt(logz_bridge), fmt(logz_err_bridge),
                )
            else:
                logger.info(
                    "evidence: PS %.3f +- %.3f, IS %s +- %s (khat %s), bridge "
                    "diagnostic %s +- %s -- source %s",
                    logz_ps, logz_err_ps, fmt(logz_is), fmt(logz_err_is),
                    fmt(logz_khat), fmt(logz_bridge), fmt(logz_err_bridge), logz_source,
                )

    return {
        "samples": x_all,
        "weights": weights,
        "logl": hl,
        "logp": hp,
        "logz": float(logz),
        "logz_err": float(logz_err),
        "logz_source": logz_source,
        "logz_ps": float(logz_ps),
        "logz_err_ps": float(logz_err_ps),
        "logz_is": None if logz_is is None else float(logz_is),
        "logz_err_is": None if logz_err_is is None else float(logz_err_is),
        "logz_khat": logz_khat,
        "logz_bridge": None if logz_bridge is None else float(logz_bridge),
        "logz_err_bridge": None if logz_err_bridge is None else float(logz_err_bridge),
        "beta_iterations": iteration,
        "ess": float(ess_final),
        "total_mcmc_steps": total_steps,
    }
