"""The emulator predict's share of its roofline (ops/fused_predict.py,
csrc/fused_predict.cu): the least time of the window's predict work,
forward and backward (benchmark/work/counts.py), over the device time of
the kernels named below, in percent."""

from benchmark.harness.readers import roofline_percent

#: the fused predict's kernels (k* pre-pass, forward, both backwards)
KERNELS = (r"\bkstar_kernel", r"\bfwd_wgmma_kernel", r"\bbwd_wgmma_kernel",
           r"\bbwd_high_kernel")


def read(summary: dict) -> float | None:
    return roofline_percent(summary, "auto", "predict", KERNELS)
