"""ctypes bindings of the host C++ of the port: the boundary tracer of
the detection host stage (``csrc/trace_mask.cpp``) and the polygon fill
of the training loader (``csrc/rasterize.cpp``), both copies of the
reference's C++ core.

The host C++ compiler builds each source into ``_build/`` (git-ignored),
keyed by the hash of the source and the flags, at first use; nothing runs
at import time. A library is written to a temporary file and moved into
place, so processes that build it at once do not read a half-written file.
A failed build raises: there is no fallback to the Python tracer, whose
rings start at other vertices (geom/vectorize.py), nor to another fill.
"""

from __future__ import annotations

import ctypes as C
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")

_f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_load_lock = threading.Lock()


def build(name: str = "trace_mask") -> str:
    """Compile ``csrc/<name>.cpp`` unless a library of the same source and
    flags is in ``_build/``; returns its path."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (c++ or g++) on PATH")
    source = CSRC / f"{name}.cpp"
    key = hashlib.sha256(source.read_bytes()
                         + " ".join(CXX_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"{name}_{key[:16]}.so"
    if lib.exists():
        return str(lib)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed on {source.name} "
                               f"({proc.returncode}):\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return str(lib)


@functools.lru_cache(maxsize=None)
def _library_once() -> C.CDLL:
    lib = C.CDLL(build("trace_mask"))
    lib.geom_trace_mask.restype = C.c_void_p
    lib.geom_trace_mask.argtypes = [_u8p, C.c_int, C.c_int]
    lib.geom_result_num_coords.restype = C.c_int64
    lib.geom_result_num_coords.argtypes = [C.c_void_p]
    lib.geom_result_num_rings.restype = C.c_int32
    lib.geom_result_num_rings.argtypes = [C.c_void_p]
    lib.geom_result_num_polys.restype = C.c_int32
    lib.geom_result_num_polys.argtypes = [C.c_void_p]
    lib.geom_result_copy.restype = None
    lib.geom_result_copy.argtypes = [C.c_void_p, _f64p, _i32p, _i32p]
    lib.geom_result_free.restype = None
    lib.geom_result_free.argtypes = [C.c_void_p]
    return lib


def library() -> C.CDLL:
    """The loaded tracer, built on first use (one build however many
    threads of the host stage ask at once)."""
    with _load_lock:
        return _library_once()


@functools.lru_cache(maxsize=None)
def _raster_once() -> C.CDLL:
    lib = C.CDLL(build("rasterize"))
    lib.geom_rasterize.restype = None
    lib.geom_rasterize.argtypes = [_f64p, _i32p, C.c_int, _i32p, C.c_int,
                                   C.c_double, C.c_double, C.c_double,
                                   C.c_double, C.c_int, C.c_int, _u8p,
                                   C.c_uint8]
    return lib


FlatPolySet = tuple[np.ndarray, np.ndarray, np.ndarray]  # xy, sizes, rings


def pack(rings_per_poly: list[list[np.ndarray]]) -> FlatPolySet:
    """Pack [[shell, hole, ...], ...] (each ring an (N, 2) float64 array)
    into the flat arrays :func:`rasterize` takes (the reference's
    ``geom/_native.py:pack``)."""
    xs, sizes, prs = [], [], []
    for rings in rings_per_poly:
        prs.append(len(rings))
        for r in rings:
            r = np.ascontiguousarray(r, dtype=np.float64)
            sizes.append(len(r))
            xs.append(r.reshape(-1))
    if not xs:
        return (np.zeros((0,), np.float64), np.zeros((0,), np.int32),
                np.zeros((0,), np.int32))
    return (np.concatenate(xs), np.asarray(sizes, dtype=np.int32),
            np.asarray(prs, dtype=np.int32))


def rasterize(flat: FlatPolySet, x0: float, dx: float, y0: float, dy: float,
              height: int, width: int, out: np.ndarray | None = None,
              value: int = 1) -> np.ndarray:
    """Even-odd fill of the packed rings at pixel centres x = x0 + (col +
    0.5)·dx, y = y0 + (row + 0.5)·dy into ``out`` (height, width) uint8
    (new when None); returns it."""
    with _load_lock:
        lib = _raster_once()
    if out is None:
        out = np.zeros((height, width), dtype=np.uint8)
    if out.shape != (height, width) or out.dtype != np.uint8 \
            or not out.flags.c_contiguous:
        raise ValueError("out must be a C-contiguous (height, width) uint8 "
                         "array")
    xy, rs, pr = flat
    lib.geom_rasterize(xy, rs, len(rs), pr, len(pr), x0, dx, y0, dy,
                       height, width, out, value)
    return out


def trace_mask(mask: np.ndarray) -> list[np.ndarray]:
    """Boundary rings of a binary (H, W) mask as closed (N, 2) float64
    pixel-corner arrays, in the tracer's order."""
    lib = library()
    m = np.ascontiguousarray(mask, dtype=np.uint8)
    if m.ndim != 2:
        raise ValueError(f"trace_mask takes a 2-d mask, got {m.shape}")
    handle = lib.geom_trace_mask(m, m.shape[0], m.shape[1])
    try:
        ncoords = lib.geom_result_num_coords(handle)
        nrings = lib.geom_result_num_rings(handle)
        xy = np.empty(2 * ncoords, dtype=np.float64)
        sizes = np.empty(max(nrings, 1), dtype=np.int32)
        prs = np.empty(max(lib.geom_result_num_polys(handle), 1),
                       dtype=np.int32)
        lib.geom_result_copy(handle, xy, sizes, prs)
    finally:
        lib.geom_result_free(handle)
    rings, off = [], 0
    for n in sizes[:nrings]:
        rings.append(xy[off:off + 2 * n].reshape(-1, 2).copy())
        off += 2 * int(n)
    return rings
