"""The whole sampler step's share of the card's peak: the least time of
all of the traced window's counted work (predict, and the Woodbury
epilogue or the covariance assembly and MVN) over the window, in percent;
serves every ``mfu.<cells>`` metric.  A cell without a likelihood
``mode`` in its traffic runs the auto (Woodbury) posterior."""

from benchmark.harness.readers import mfu_percent


def read(summary: dict) -> float | None:
    return mfu_percent(summary, summary["traffic"].get("mode", "auto"))
