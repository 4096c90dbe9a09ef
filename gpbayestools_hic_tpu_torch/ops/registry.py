"""The one table of the port's hand-written kernels and their launch counts.

Every kernel module registers its kernels here when it is imported
(:func:`register`) and its wrapper calls :func:`count_launch` where it
launches the kernel, and nowhere else.  A run can then show that a path
really went through a kernel: reset the counts, drive the path, read them.
:data:`LAUNCHES_BY_DEVICE` splits the same counts by device, so a run
sharded over a walker mesh can show that every card launched its kernels.
Backward kernels launch from autograd's device threads, one per card,
which run at once on a mesh of cards, so the counts are updated under a
lock.
"""

from __future__ import annotations

import threading

#: launches per kernel wrapper (incremented where the kernel is launched)
LAUNCH_COUNTS: dict[str, int] = {}

#: kernel -> {device ("cuda:1"): launches}
LAUNCHES_BY_DEVICE: dict[str, dict[str, int]] = {}

#: kernel -> (kernel source, file:line of the TPU kernel it replaces)
KERNELS: dict[str, tuple[str, str]] = {}


def register(name: str, source: str, replaces: str) -> None:
    KERNELS[name] = (source, replaces)
    LAUNCH_COUNTS.setdefault(name, 0)


_lock = threading.Lock()


def count_launch(name: str, device) -> None:
    with _lock:
        LAUNCH_COUNTS[name] += 1
        per = LAUNCHES_BY_DEVICE.setdefault(name, {})
        per[str(device)] = per.get(str(device), 0) + 1


def reset_launch_counts() -> None:
    with _lock:
        for k in LAUNCH_COUNTS:
            LAUNCH_COUNTS[k] = 0
        LAUNCHES_BY_DEVICE.clear()


def raise_on(err: int, what: str) -> None:
    """Raise when a kernel's C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")
