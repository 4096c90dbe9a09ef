"""The share of the traced window's emulator predicts that ran the fused
forward with the Matern-1.5 k* pre-pass (``kstar_kernel<1>``), in percent:
its launches over one predict per emulator block and posterior call (0
where the predicts take the plain route)."""

from benchmark.harness.trace import kernel_seconds


def read(summary: dict) -> float | None:
    predicts = len(summary["config"]["blocks"]) * sum(summary["calls"].values())
    if not predicts:
        return None
    launches, _ = kernel_seconds(summary, (r"\bkstar_kernel<1>",))
    return 100.0 * launches / predicts
