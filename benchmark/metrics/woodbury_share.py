"""The share of the traced window's posterior calls whose Woodbury blocks
ran the fused epilogue (``woodbury_fwd_kernel``, ops/fused_woodbury.py,
csrc/fused_woodbury.cu), in percent: its launches over the window's
posterior calls (0 where the blocks take the library's factor, as before
the kernel); None without calls."""

from benchmark.harness.trace import kernel_seconds


def read(summary: dict) -> float | None:
    calls = sum(summary["calls"].values())
    if not calls:
        return None
    launches, _ = kernel_seconds(summary, (r"\bwoodbury_fwd_kernel\b",))
    return 100.0 * launches / calls
