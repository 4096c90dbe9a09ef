"""The Matern emulator predict's share of its roofline in the PCSK cell
(ops/fused_predict.py, csrc/fused_predict.cu): the least time of the
window's predict work, forward and backward at each block's PC count
(benchmark/work/counts_pcsk.py), over the device time of the fused
predict's kernels, in percent; None where none of them ran (the plain
route)."""

from benchmark.harness.trace import kernel_seconds
from benchmark.work.counts import least_seconds
from benchmark.work.counts_pcsk import window_work

#: the fused predict's kernels (k* pre-pass, forward, both backwards)
KERNELS = (r"\bkstar_kernel", r"\bfwd_wgmma_kernel", r"\bbwd_wgmma_kernel",
           r"\bbwd_high_kernel")


def read(summary: dict) -> float | None:
    _, secs = kernel_seconds(summary, KERNELS)
    if secs <= 0:
        return None
    return 100.0 * least_seconds(window_work(summary, ("predict",))) / secs
