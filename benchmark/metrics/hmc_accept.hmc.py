"""Mean acceptance statistic of the HMC production steps in the window
(samplers/hmc.py), in percent."""


def read(summary: dict) -> float | None:
    acc = summary.get("acceptance")
    return None if acc is None else 100.0 * acc
