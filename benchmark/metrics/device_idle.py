"""Share of the traced window in which no device activity ran (the union
of the kernels', copies' and fills' intervals), in percent; serves every
``device_idle.<cells>`` metric."""


def read(summary: dict) -> float | None:
    if summary["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
