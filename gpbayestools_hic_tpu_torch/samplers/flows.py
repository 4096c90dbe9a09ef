"""Normalizing flows for SMC preconditioning.

PyTorch port of the JAX package's ``samplers/flows.py``: alternating-mask
coupling layers (monotonic rational-quadratic splines, ``"rqs"``, or
RealNVP affine, ``"affine"``) with small GELU MLP conditioners, after a
moment-matching whitening pre-layer.

- :class:`Flow` is an ``nn.Module``: the conditioners' weights are its
  parameters; the whitening pre-layer (``pre_mean``, ``pre_log_scale``)
  and the coupling masks are buffers, never trained.
- ``forward`` maps data ``u`` to latent ``z`` (trained toward N(0, I)),
  ``inverse`` maps back, each with its log-determinant; ``logprob`` is
  log q(u).
- :func:`fit_flow` is the weighted maximum-likelihood fit: AdamW over the
  coupling parameters only (the JAX package's ``optax.adamw`` with weight
  decay masked to the coupling layers), optional patience, and the best
  parameters seen are returned.
- :func:`flow_from_jax` carries a JAX flow's parameters into a module.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class FlowConfig(NamedTuple):
    n_layers: int = 6
    hidden: int = 64
    # tanh bound on per-layer log-scales (affine couplings)
    max_log_scale: float = 1.0
    weight_decay: float = 1e-2
    # "rqs" (rational-quadratic splines) or "affine" (RealNVP)
    coupling: str = "rqs"
    rqs_bins: int = 8
    rqs_bound: float = 5.0  # spline support [-B, B]; identity tails outside


_MIN_BIN = 1e-3
_SOFTPLUS_INV_1 = 0.5413248546129181  # softplus(x) = 1


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _conditioner_width(ndim: int, config: FlowConfig) -> int:
    if config.coupling == "rqs":
        return ndim * (3 * config.rqs_bins + 1)
    return 2 * ndim


def _mlp_init(rng, sizes):
    """He-normal MLP weights from a numpy generator, the last layer zero
    (the flow starts as the identity); the JAX package's draws in order."""
    params = []
    for din, dout in zip(sizes[:-1], sizes[1:]):
        params.append([rng.standard_normal((din, dout)) * np.sqrt(2.0 / din), np.zeros(dout)])
    params[-1][0] = np.zeros_like(params[-1][0])
    return params


def _rqs_transform(x, raw, config: FlowConfig, inverse: bool):
    """Monotonic rational-quadratic spline (Durkan et al.): ``x`` (..., d),
    ``raw`` (..., d, 3K+1).  Identity outside [-B, B]; zero raw parameters
    give the identity.  Returns (y, per-element logdet)."""
    k_bins = config.rqs_bins
    b = config.rqs_bound
    widths = _MIN_BIN + (1 - _MIN_BIN * k_bins) * torch.softmax(raw[..., :k_bins], dim=-1)
    heights = _MIN_BIN + (1 - _MIN_BIN * k_bins) * torch.softmax(
        raw[..., k_bins:2 * k_bins], dim=-1)
    derivs = _softplus(raw[..., 2 * k_bins:] + _SOFTPLUS_INV_1)
    ones = torch.ones_like(derivs[..., :1])
    derivs = torch.cat([ones, derivs[..., 1:-1], ones], dim=-1)
    zeros = torch.zeros_like(widths[..., :1])
    cum_w = torch.cat([zeros, torch.cumsum(widths, dim=-1)], dim=-1) * (2 * b) - b
    cum_h = torch.cat([zeros, torch.cumsum(heights, dim=-1)], dim=-1) * (2 * b) - b

    inside = (x > -b) & (x < b)
    x_safe = torch.clamp(x, -b + 1e-6, b - 1e-6)
    grid = cum_h if inverse else cum_w
    idx = (x_safe[..., None] >= grid[..., 1:-1]).to(torch.int64).sum(-1, keepdim=True)

    def take(a):
        return torch.take_along_dim(a, idx, dim=-1)[..., 0]

    w_k = take(widths) * (2 * b)
    h_k = take(heights) * (2 * b)
    x_k = take(cum_w[..., :-1])
    y_k = take(cum_h[..., :-1])
    d_k = take(derivs[..., :-1])
    d_k1 = take(derivs[..., 1:])
    s_k = h_k / w_k

    if not inverse:
        xi = (x_safe - x_k) / w_k
        xi1m = xi * (1 - xi)
        denom = s_k + (d_k1 + d_k - 2 * s_k) * xi1m
        y = y_k + h_k * (s_k * xi**2 + d_k * xi1m) / denom
        deriv = (s_k**2 * (d_k1 * xi**2 + 2 * s_k * xi1m + d_k * (1 - xi) ** 2)) / denom**2
        return torch.where(inside, y, x), torch.where(inside, torch.log(deriv),
                                                      torch.zeros_like(x))

    y_rel = x_safe - y_k
    a_q = h_k * (s_k - d_k) + y_rel * (d_k1 + d_k - 2 * s_k)
    b_q = h_k * d_k - y_rel * (d_k1 + d_k - 2 * s_k)
    c_q = -s_k * y_rel
    disc = torch.clamp(b_q**2 - 4 * a_q * c_q, min=0.0)
    xi = torch.clamp(2 * c_q / (-b_q - torch.sqrt(disc)), 0.0, 1.0)
    xi1m = xi * (1 - xi)
    denom = s_k + (d_k1 + d_k - 2 * s_k) * xi1m
    deriv = (s_k**2 * (d_k1 * xi**2 + 2 * s_k * xi1m + d_k * (1 - xi) ** 2)) / denom**2
    return (torch.where(inside, x_k + xi * w_k, x),
            torch.where(inside, -torch.log(deriv), torch.zeros_like(x)))


class Flow(nn.Module):
    """Coupling flow over ``ndim`` inputs; the identity at initialization.

    ``seed`` seeds the numpy generator of the conditioners' He-normal
    weights (an int, or the JAX package's key data as a list of ints, which
    gives the JAX flow's initial weights)."""

    def __init__(self, ndim: int, config: FlowConfig = FlowConfig(), seed=0,
                 dtype=torch.float32, device=None):
        super().__init__()
        if config.coupling not in ("rqs", "affine"):
            raise ValueError(f"unknown coupling {config.coupling!r}: use 'rqs' or 'affine'")
        self.config = config
        self.ndim = ndim
        rng = np.random.default_rng(seed)
        sizes = [ndim, config.hidden, config.hidden, _conditioner_width(ndim, config)]
        self.layers = nn.ModuleList()
        for _ in range(config.n_layers):
            self.layers.append(nn.ParameterList([
                nn.Parameter(torch.as_tensor(a, dtype=dtype, device=device))
                for wb in _mlp_init(rng, sizes) for a in wb
            ]))
        masks = ((torch.arange(ndim)[None, :] + torch.arange(config.n_layers)[:, None]) % 2) == 0
        self.register_buffer("masks", masks.to(dtype=dtype, device=device))
        self.register_buffer("pre_mean", torch.zeros(ndim, dtype=dtype, device=device))
        self.register_buffer("pre_log_scale", torch.zeros(ndim, dtype=dtype, device=device))

    @staticmethod
    def _mlp(layer, x):
        n = len(layer) // 2
        for i in range(n):
            x = x @ layer[2 * i] + layer[2 * i + 1]
            if i < n - 1:
                x = F.gelu(x, approximate="tanh")  # jax.nn.gelu's default
        return x

    def _coupling(self, i, u, inverse: bool):
        cfg = self.config
        mask = self.masks[i]
        h = self._mlp(self.layers[i], u * mask)
        if cfg.coupling == "rqs":
            raw = h.reshape(*u.shape, 3 * cfg.rqs_bins + 1)
            y, logdet_elem = _rqs_transform(u, raw, cfg, inverse)
            return torch.where(mask > 0, u, y), (logdet_elem * (1 - mask)).sum(-1)
        raw_s, t = h[..., :self.ndim], h[..., self.ndim:]
        s = cfg.max_log_scale * torch.tanh(raw_s / cfg.max_log_scale) * (1 - mask)
        t = t * (1 - mask)
        if inverse:
            return (u - t) * torch.exp(-s), -s.sum(-1)
        return u * torch.exp(s) + t, s.sum(-1)

    def forward(self, u):
        """Data -> latent: ``(z, log|det dz/du|)``, u (b, d)."""
        x = (u - self.pre_mean) * torch.exp(-self.pre_log_scale)
        logdet = (-self.pre_log_scale).sum() * torch.ones(u.shape[0], dtype=u.dtype,
                                                          device=u.device)
        for i in range(len(self.layers)):
            x, ld = self._coupling(i, x, inverse=False)
            logdet = logdet + ld
        return x, logdet

    def inverse(self, z):
        """Latent -> data: ``(u, log|det du/dz|)``, z (b, d)."""
        x = z
        logdet = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
        for i in reversed(range(len(self.layers))):
            x, ld = self._coupling(i, x, inverse=True)
            logdet = logdet + ld
        u = x * torch.exp(self.pre_log_scale) + self.pre_mean
        return u, logdet + self.pre_log_scale.sum()

    def logprob(self, u):
        """log q(u) = log N(z; 0, I) + log|det dz/du|."""
        z, logdet = self(u)
        d = u.shape[-1]
        return -0.5 * (z**2).sum(-1) - 0.5 * d * np.log(2.0 * np.pi) + logdet

    @torch.no_grad()
    def set_whitening(self, u, weights):
        """Set the pre-layer from the weighted moments of ``u``; returns the
        normalized weights."""
        w = weights / weights.sum()
        mean = (w[:, None] * u).sum(0)
        var = (w[:, None] * (u - mean) ** 2).sum(0)
        self.pre_mean.copy_(mean)
        self.pre_log_scale.copy_(0.5 * torch.log(var + 1e-12))
        return w


def fit_flow(flow: Flow, u, weights, steps: int, *, lr: float = 1e-3, patience: int = 0,
             return_best: bool = True, check_every: int = 1, stats: dict | None = None):
    """Weighted maximum-likelihood fit of ``flow`` on samples ``u`` (b, d).

    Sets the whitening pre-layer from the weighted moments, then runs up to
    ``steps`` full-batch AdamW steps over the coupling parameters (weight
    decay ``flow.config.weight_decay``).  With ``return_best`` (the JAX
    package's ``fit_flow_dynamic``) the flow ends at the best parameters
    seen, the loss of each step being that of the parameters before its
    update, and the best loss is returned; with ``patience > 0`` the fit
    stops once the loss has not improved on its best by more than 0.1% of
    |best| for ``patience`` steps.  The best parameters, the best loss and
    the patience counter stay on the device, and the stop flag is read
    every ``check_every`` steps: steps past the stop change neither, so
    every ``check_every`` returns the same parameters.  With
    ``return_best=False`` (the JAX ``fit_flow`` with ``patience <= 0``)
    the flow ends at its last parameters and the last step's loss is
    returned.  ``stats``, when given, receives the steps run.
    """
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    w = flow.set_whitening(u, weights)
    params = list(flow.layers.parameters())
    opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=flow.config.weight_decay)
    best = torch.tensor(torch.finfo(u.dtype).max / 8, dtype=u.dtype, device=u.device)
    since = torch.zeros((), dtype=torch.int64, device=u.device)
    active = torch.ones((), dtype=torch.bool, device=u.device)
    best_p = [p.detach().clone() for p in params]
    loss = None
    i = 0
    for i in range(steps):
        opt.zero_grad(set_to_none=False)
        loss = -(w * flow.logprob(u)).sum()
        loss.backward()
        loss = loss.detach()
        if return_best:
            take = active & (loss < best)
            for b, p in zip(best_p, params):
                b.copy_(torch.where(take, p.detach(), b))
            improved = loss < best - 1e-3 * best.abs()
            best = torch.where(active, torch.minimum(best, loss), best)
            since = torch.where(active, torch.where(improved, 0, since + 1), since)
            if patience > 0:
                active = active & (since < patience)
        opt.step()
        if patience > 0 and (i + 1) % check_every == 0 and not bool(active):
            break
    if stats is not None:
        stats["steps"] = i + 1
    if not return_best:
        return loss
    with torch.no_grad():
        for b, p in zip(best_p, params):
            p.copy_(b)
    return best


def flow_from_jax(params, config: FlowConfig = FlowConfig(), device=None) -> Flow:
    """A :class:`Flow` holding the JAX package's flow parameters (the
    pytree of ``init_flow``/``fit_flow``, as numpy arrays)."""
    pre_mean = np.asarray(params["pre_mean"])
    dtype = torch.float64 if pre_mean.dtype == np.float64 else torch.float32
    flow = Flow(pre_mean.shape[0], config, dtype=dtype, device=device)
    with torch.no_grad():
        for layer, jl in zip(flow.layers, params["layers"]):
            flat = [a for wb in jl["mlp"] for a in (wb["w"], wb["b"])]
            for p, a in zip(layer, flat):
                p.copy_(torch.as_tensor(np.array(a)))
        flow.pre_mean.copy_(torch.as_tensor(np.array(pre_mean)))
        flow.pre_log_scale.copy_(torch.as_tensor(np.array(params["pre_log_scale"])))
    return flow
