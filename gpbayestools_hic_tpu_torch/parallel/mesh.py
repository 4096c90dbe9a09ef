"""Walker-parallel evaluation over several devices.

PyTorch port of the JAX package's ``parallel/mesh.py``.  There a 1-D
``Mesh`` with a ``walkers`` axis shards the walker batch by placement and
XLA partitions the jitted posterior with no communication.  PyTorch has no
such partitioner, so the port scatters and gathers on the host:

- a :class:`WalkerMesh` is an ordered tuple of devices, one walker shard
  each;
- :func:`sharded_log_prob` splits an (m, ndim) batch along dim 0 into
  ``mesh.size`` chunks (:func:`shard_batch`, ``tensor_split``, so the
  count need not divide), evaluates each chunk on its device against that
  device's replica of the posterior and gathers the results onto the
  input's device;
- its ``value_and_grad`` twin does the same with each shard's
  ``torch.autograd.grad`` run on its own device.

The shards are issued one after another from the calling thread.  The
port's posterior is host-bound (hundreds of small launches per call), so
this costs about the shard count times one call's host time.  Issuing
each shard from a host thread of its own, in the manner of
``torch.nn.parallel.parallel_apply``, was slower still on an H100: every
PyTorch operation releases and retakes the interpreter lock, and with
several threads each of those becomes a thread switch
(``tools/torch_sharding.py`` times both).  A CUDA graph per replica is
the cure for the host time (ROADMAP.md, host dispatch).

The samplers keep positions, adaptation, reductions and every random draw
on one device (the run's own) over the whole batch and shard only the
posterior evaluations, so a seed gives the same draws sharded and
unsharded.

A replica is the posterior's state moved to a device (:func:`replicate`)
together with a function that computes there.  A function whose closure
holds device-resident objects (the ``Chain`` posterior holds its
emulators' GP factors) brings its own copy for a device through a
``replica(device)`` attribute; any other function is used as it is on
every device.

A mesh built directly from a device list may name one device more than
once (``WalkerMesh([torch.device("cpu")] * 8)``, or ``[cuda:0] * 4``):
the sharded path then runs on one device, as the JAX package's tests run
on 8 virtual CPU devices.  That is a check of the sharded path, not a way
to gain speed.  :func:`make_mesh` never repeats a device.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Sequence

import torch

from ..utils.tensors import to_device, value_and_grad


class WalkerMesh:
    """An ordered tuple of devices, one walker shard each."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a walker mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"WalkerMesh({[str(d) for d in self.devices]})"


def make_mesh(n_devices: int | None = None) -> WalkerMesh:
    """Mesh over the first ``n_devices`` CUDA devices (all if None)."""
    available = torch.cuda.device_count()
    n = available if n_devices is None else int(n_devices)
    if n > available or n < 1:
        # a smaller mesh than the caller asked for would quietly run on
        # fewer cards
        raise ValueError(f"requested {n} devices but only {available} available")
    return WalkerMesh([torch.device("cuda", i) for i in range(n)])


def resolve_mesh(devices: int | None = None, mesh: WalkerMesh | None = None) -> WalkerMesh | None:
    """One-knob mesh resolution for the ``Chain`` sampler front-ends:
    ``mesh`` wins if given; ``devices=N`` builds a mesh over the first N
    CUDA devices; ``devices=-1`` uses all of them; ``None``/0/1 means no
    sharding."""
    if mesh is not None:
        return mesh
    if devices is None or devices in (0, 1):
        return None
    if devices < -1:
        raise ValueError(f"devices must be a positive count or -1 (all), got {devices}")
    return make_mesh(None if devices == -1 else devices)  # raises past the card count


def replicate(mesh: WalkerMesh, tree) -> tuple:
    """One copy of ``tree`` per mesh position, its tensors on that
    position's device; positions on one device share a copy."""
    copies = {}
    for d in mesh.devices:
        if d not in copies:
            copies[d] = to_device(tree, d)
    return tuple(copies[d] for d in mesh.devices)


def check_divisible(mesh: WalkerMesh, n: int, what: str = "walkers") -> None:
    """Sharding a batch axis requires it to divide evenly over the mesh."""
    size = mesh.size
    if n % size:
        raise ValueError(
            f"{what} count {n} is not divisible by the {size}-device mesh; "
            f"choose a multiple of {size}"
        )


def shard_batch(mesh: WalkerMesh, x: torch.Tensor) -> tuple:
    """Split a (batch, ...) tensor along dim 0 into ``mesh.size`` chunks,
    chunk k on device k (``tensor_split``: sizes differ by at most one)."""
    return tuple(c.to(d) for c, d in zip(torch.tensor_split(x, mesh.size), mesh.devices))


def _gather(outs: list, device: torch.device):
    """Concatenate the shards' outputs (tensors, or tuples of tensors) on
    ``device``."""
    if isinstance(outs[0], tuple):
        return tuple(_gather([o[i] for o in outs], device) for i in range(len(outs[0])))
    return torch.cat([o.to(device) for o in outs])


def _run_shard(fn: Callable, chunk: torch.Tensor, args: tuple):
    device = chunk.device
    guard = torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
    with guard:
        return fn(chunk, *args)


def shard_map(mesh: WalkerMesh, shard_fns: Sequence[Callable]) -> Callable:
    """``x, *args -> outputs`` gathered on ``x``'s device, shard k computed
    by ``shard_fns[k](chunk_k, *args)`` on device k, the shards issued one
    after another from the calling thread (every launch is asynchronous,
    so the devices' work overlaps).  A batch smaller than the mesh leaves
    shards empty: those are not run (a kernel takes no empty batch)."""
    if len(shard_fns) != mesh.size:
        raise ValueError(f"{len(shard_fns)} shard functions for a {mesh.size}-device mesh")

    def call(x: torch.Tensor, *args):
        chunks = shard_batch(mesh, x)
        ks = [k for k, c in enumerate(chunks) if c.shape[0]] or [0]
        return _gather([_run_shard(shard_fns[k], chunks[k], args) for k in ks], x.device)

    return call


def replicas(log_prob_fn: Callable, mesh: WalkerMesh, state=None) -> list:
    """``[(fn_k, state_k)]`` per mesh position: the state replicated, and
    the function's own copy for the device where it provides
    ``replica(device)`` (built once per device here: callers make the
    replicas once per run, not per call)."""
    states = replicate(mesh, state)
    provider = getattr(log_prob_fn, "replica", None)
    fns = {}
    for d in mesh.devices:
        if d not in fns:
            fns[d] = provider(d) if provider is not None else log_prob_fn
    return [(fns[d], s) for d, s in zip(mesh.devices, states)]


def _bind(fn, state):
    if state is None:
        return fn
    return lambda x, *args: fn(state, x, *args)


def sharded_log_prob(log_prob_fn: Callable, mesh: WalkerMesh, state=None) -> Callable:
    """Wrap a batched log-prob so each walker shard is evaluated on its own
    device: ``x (m, ndim) -> (m,)`` on ``x``'s device.  Extra positional
    arguments pass through to every shard.  With ``state``, the function
    is called as ``log_prob_fn(state, x, *args)`` with each device's
    replica of ``state``.  Differentiable by autograd (the scatter and
    gather are device copies), which the batched L-BFGS uses.

    The returned callable carries the gradient samplers' twin,
    ``value_and_grad``: ``x -> (value (m,), gradient (m, ndim))``,
    detached, each shard's forward and ``torch.autograd.grad`` run on its
    own device, over the same replicas."""
    bound = [_bind(fn, s) for fn, s in replicas(log_prob_fn, mesh, state)]
    call = shard_map(mesh, bound)
    call.value_and_grad = shard_map(mesh, [value_and_grad(b) for b in bound])
    return call
