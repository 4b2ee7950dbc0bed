"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exports a plain C interface: its launch functions
return ``cudaGetLastError()`` as an int, and ``<name>_error_string(int)``
turns a code into text. ``nvcc`` compiles a source into a shared library
in ``_build/`` (git-ignored), keyed by the hash of the source, the
headers beside it (``csrc/*.cuh``) and the flags, at first use; ctypes
loads it. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("roi_align", "roi_align_blocked", "nms", "int8_gemm",
           "roi_align_backward", "bias_act", "rel_attention", "layer_norm")


def nvcc_path() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {path})")
    return path


def build(name: str, defines: tuple = ()) -> dict:
    """Compile ``csrc/<name>.cu`` into ``_build/`` unless a library of the
    same source, headers and flags is there. ``defines``: (macro, value)
    pairs passed as ``-D`` (a variant for measurement, a library of its
    own; the kernels' builds take none). Returns {"path", "seconds",
    "cached", "log"} (``log``: nvcc's output, with ptxas's register and
    spill counts)."""
    source = CSRC / f"{name}.cu"
    flags = (*NVCC_FLAGS, *(f"-D{m}={v}" for m, v in defines))
    key = hashlib.sha256(b"".join(
        p.read_bytes() for p in (source, *sorted(CSRC.glob("*.cuh"))))
        + " ".join(flags).encode()).hexdigest()
    variant = "".join(f"_{m.lower()}{v}" for m, v in defines)
    lib = BUILD_DIR / f"{name}{variant}_{key[:16]}.so"
    if lib.exists():
        return {"path": str(lib), "seconds": 0.0, "cached": True, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc_path(), *flags, "-o", str(tmp),
                           str(source)], capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode})"
                           f":\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return {"path": str(lib), "seconds": seconds, "cached": False,
            "log": proc.stdout + proc.stderr}


@functools.lru_cache(maxsize=None)
def library(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (with ``defines``, see
    :func:`build`), built on first use."""
    lib = ctypes.CDLL(build(name, defines)["path"])
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def check(name: str, rc: int, what: str):
    """Raise if a launch function of ``csrc/<name>.cu`` returned an
    error."""
    if rc != 0:
        text = getattr(library(name), f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {text}")
