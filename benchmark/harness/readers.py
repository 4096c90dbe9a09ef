"""What the per-layer metric readers share: the counted work of the traced
window, from the posterior calls the harness counted in it."""

from __future__ import annotations

from benchmark.harness.trace import kernel_seconds
from benchmark.work.counts import Work, least_seconds, posterior_work


def window_work(summary: dict, mode: str, layers=("predict", "mvn", "other")) -> Work:
    """The work of every posterior call in the traced window, summed over
    ``layers``."""
    total = Work()
    for (m, grad), count in summary["calls"].items():
        parts = posterior_work(summary["config"], mode, m, grad)
        for layer in layers:
            total = total + parts[layer].scaled(count)
    return total


def roofline_percent(summary: dict, mode: str, layer: str, patterns) -> float | None:
    """The least time of the window's ``layer`` work over the device time of
    the kernels matching ``patterns``, in percent; None where no such
    kernel ran."""
    _, secs = kernel_seconds(summary, patterns)
    if secs <= 0:
        return None
    work = window_work(summary, mode, (layer,))
    if work.flops <= 0 and work.nbytes <= 0:
        return None
    return 100.0 * least_seconds(work) / secs


def mfu_percent(summary: dict, mode: str) -> float | None:
    """The least time of all of the window's counted work over the window."""
    if summary["window_s"] <= 0:
        return None
    return 100.0 * least_seconds(window_work(summary, mode)) / summary["window_s"]
