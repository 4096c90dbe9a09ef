"""Common runtime: logging, working directories, parameter-file parsing.

Same environment contract as the JAX package's ``runtime`` module:

- ``LOGLEVEL`` env var selects the stdout logging level (default ``info``).
- ``WORKDIR`` env var selects the working directory (default ``.``); a
  ``cache`` subdirectory is created lazily on first use.
- Parameter files are plain text, one parameter per line::

      name: label, min, max   # optional comment

  parsed into ``{name: [label, float(min), float(max)]}``.
"""

from __future__ import annotations

import logging
import os
import sys
from pathlib import Path

_LOG_CONFIGURED = False


def _configure_logging() -> None:
    global _LOG_CONFIGURED
    if _LOG_CONFIGURED:
        return
    logging.basicConfig(
        stream=sys.stdout,
        format="[%(levelname)s][%(module)s] %(message)s",
        level=os.getenv("LOGLEVEL", "info").upper(),
    )
    _LOG_CONFIGURED = True


_configure_logging()

workdir = Path(os.getenv("WORKDIR", "."))


def _cachedir() -> Path:
    """Cache directory under the workdir (created on first use)."""
    path = workdir / "cache"
    path.mkdir(parents=True, exist_ok=True)
    return path


class _LazyCacheDir:
    """Path-like proxy that creates the cache dir on first real use."""

    def __fspath__(self) -> str:
        return str(_cachedir())

    def __truediv__(self, other) -> Path:
        return _cachedir() / other

    def __str__(self) -> str:
        return str(workdir / "cache")

    def __repr__(self) -> str:
        return f"LazyCacheDir({str(self)!r})"


cachedir = _LazyCacheDir()


def parse_model_parameter_file(parfile) -> dict:
    """Parse a model-parameter file into ``{name: [label, min, max]}``.

    ``#`` starts a comment, each non-empty line is ``name: label, min,
    max`` and min/max are converted to float.
    """
    pardict = {}
    with open(parfile, "r") as f:
        for lineno, line in enumerate(f, start=1):
            par = line.split("#")[0]
            if par == "" or par.strip() == "":
                continue
            name, sep, rest = par.partition(":")
            vals = [v.strip() for v in rest.split(",")]
            if not sep or len(vals) < 3:
                raise ValueError(
                    f"{parfile}:{lineno}: expected 'name: label, min, max', "
                    f"got {line.strip()!r}"
                )
            try:
                vals[1] = float(vals[1])
                vals[2] = float(vals[2])
            except ValueError as e:
                raise ValueError(
                    f"{parfile}:{lineno}: min/max must be numbers in "
                    f"{line.strip()!r}"
                ) from e
            pardict[name] = vals
    return pardict
