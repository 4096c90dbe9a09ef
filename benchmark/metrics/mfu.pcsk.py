"""The whole sampler step's share of the card's peak in the PCSK cell: the
least time of all of the traced window's counted work (the predict and the
Woodbury epilogue, each block at its own PC count:
benchmark/work/counts_pcsk.py) over the window, in percent."""

from benchmark.work.counts import least_seconds
from benchmark.work.counts_pcsk import window_work


def read(summary: dict) -> float | None:
    if summary["window_s"] <= 0:
        return None
    return 100.0 * least_seconds(window_work(summary)) / summary["window_s"]
