"""The dense MVN's share of its roofline (ops/fused_mvn.py,
csrc/fused_mvn.cu): the least time of the window's MVN work
(benchmark/work/counts.py) over the device time of the kernels named
below, in percent."""

from benchmark.harness.readers import roofline_percent

#: every route of the MVN kernel (warp, shared memory, cluster, wide)
KERNELS = (r"\bmvn_warp_kernel", r"\bmvn_smem_kernel", r"\bmvn_cluster_kernel",
           r"\bmvn_wide_kernel")


def read(summary: dict) -> float | None:
    return roofline_percent(summary, summary["traffic"]["mode"], "mvn", KERNELS)
