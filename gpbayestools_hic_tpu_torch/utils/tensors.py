"""Tensor helpers shared by the models, the samplers and the walker mesh."""

from __future__ import annotations

from typing import Callable

import torch


def to_device(tree, device: torch.device):
    """``tree`` with every tensor leaf moved to ``device`` (dicts, lists,
    tuples and named tuples are rebuilt; other leaves are shared)."""
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, dict):
        return type(tree)((k, to_device(v, device)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_device(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree


def value_and_grad(fn: Callable) -> Callable:
    """``x -> (fn(x), d sum(fn(x)) / dx)`` for a batched ``fn`` mapping
    (m, ndim) to (m,), both detached."""

    def vg(x):
        with torch.enable_grad():
            xr = x.detach().requires_grad_(True)
            f = fn(xr)
            (g,) = torch.autograd.grad(f.sum(), xr)
        return f.detach(), g

    return vg
