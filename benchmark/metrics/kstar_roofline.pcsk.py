"""The Matern k* pre-pass's share of its roofline (csrc/fused_predict.cu,
``kstar_kernel``): the least time of the window's k* builds (operations,
inputs read, k* and the derivative weight written: counts_pcsk.kstar_work)
over the pre-pass's device time, in percent; None where it did not run."""

from benchmark.harness.trace import kernel_seconds
from benchmark.work.counts import least_seconds
from benchmark.work.counts_pcsk import window_work

KERNELS = (r"\bkstar_kernel",)


def read(summary: dict) -> float | None:
    _, secs = kernel_seconds(summary, KERNELS)
    if secs <= 0:
        return None
    return 100.0 * least_seconds(window_work(summary, ("kstar",))) / secs
