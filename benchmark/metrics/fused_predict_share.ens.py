"""The share of the traced window's emulator predicts that ran the fused
forward kernel (ops/fused_predict.py, csrc/fused_predict.cu), in percent:
its launches over one predict per emulator block and posterior call."""

from benchmark.harness.trace import kernel_seconds


def read(summary: dict) -> float | None:
    predicts = len(summary["config"]["blocks"]) * sum(summary["calls"].values())
    if not predicts:
        return None
    launches, _ = kernel_seconds(summary, (r"\bfwd_wgmma_kernel",))
    return 100.0 * launches / predicts
