"""Experiment design: maximin / MaxPro Latin hypercubes annealed on the device."""

from .lhd import Design, generate_lhs  # noqa: F401
