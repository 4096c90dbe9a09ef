"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/*.cu`` source compiles on its own, with a plain C interface,
into ``gpbayestools_hic_tpu_torch/_build/lib<name>-<digest>.so`` (the
directory is git-ignored; the digest covers the source and the flags, so
an edited source never loads a stale library).  Builds happen at first use
from the sources in the checkout; :func:`build_all` starts one ``nvcc`` per
source, all at once, and waits for them together.

Nothing here runs at import time: the CPU tests import every module of the
port on machines that have no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parents[1]
BUILD_DIR = _PKG_DIR / "_build"

#: kernel library name -> source path relative to the package directory
SOURCES = {
    "fused_predict": "csrc/fused_predict.cu",
    "fused_mvn": "csrc/fused_mvn.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

#: compiler output (ptxas register / shared-memory / spill report) per build
BUILD_LOGS: dict[str, str] = {}
_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the "
            "CUDA kernels are built from source at first use"
        )
    return found


def lib_path(name: str) -> Path:
    src = (_PKG_DIR / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=None) -> dict[str, float]:
    """Compile every listed source whose library is missing, in parallel.

    Returns ``{name: seconds}`` for the sources compiled by this call.
    Raises with the compiler's output if any build fails.
    """
    import time

    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        out = lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_PKG_DIR / SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out)
    seconds, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, building it first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        _LOADED[name] = lib
    return lib
