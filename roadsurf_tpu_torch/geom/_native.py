"""ctypes bindings of the port's host geometry core (``csrc/geomcore.cpp``,
a copy of the reference's C++ core with one repair): the sweep-line
boolean operations, the cascaded union, line and polygon buffers, the
point-in-polygon-set and polygon-set intersection tests, the polygon fill
of the training loader and the boundary tracer of the detection host stage.

All polygon data crosses the boundary in a flat format:
    xy          float64[2*npts]   ring coordinates, concatenated
    ring_sizes  int32[nrings]     points per ring
    poly_rings  int32[npolys]     rings per polygon (shell first, then holes)

The host C++ compiler builds the source into ``_build/`` (git-ignored),
keyed by the hash of the source and the flags, at first use; nothing runs
at import time. The library is written to a temporary file and moved into
place, so processes that build it at once do not read a half-written file.
A failed build raises: there is no Python fallback (the Python tracer of
geom/vectorize.py starts its rings at other vertices, and nothing else
computes the boolean operations).
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

OP_INTERSECTION, OP_UNION, OP_DIFFERENCE, OP_XOR = 0, 1, 2, 3

FlatPolySet = tuple[np.ndarray, np.ndarray, np.ndarray]  # xy, sizes, rings


def build(name: str = "geomcore") -> str:
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


_POLYSET = [_f64p, _i32p, C.c_int, _i32p, C.c_int]


@functools.lru_cache(maxsize=None)
def _library_once() -> C.CDLL:
    lib = C.CDLL(build("geomcore"))
    signatures = {
        "geom_boolean_op": (C.c_void_p, [C.c_int, *_POLYSET, *_POLYSET]),
        "geom_union_many": (C.c_void_p, _POLYSET),
        "geom_buffer_line": (C.c_void_p, [_f64p, C.c_int, C.c_double,
                                          C.c_int, C.c_int]),
        "geom_buffer_polygon": (C.c_void_p, [*_POLYSET, C.c_double,
                                             C.c_int]),
        "geom_result_num_coords": (C.c_int64, [C.c_void_p]),
        "geom_result_num_rings": (C.c_int32, [C.c_void_p]),
        "geom_result_num_polys": (C.c_int32, [C.c_void_p]),
        "geom_result_copy": (None, [C.c_void_p, _f64p, _i32p, _i32p]),
        "geom_result_free": (None, [C.c_void_p]),
        "geom_points_in_polyset": (None, [_f64p, C.c_int, *_POLYSET, _u8p]),
        "geom_polyset_intersects": (C.c_int, [*_POLYSET, *_POLYSET]),
        "geom_rasterize": (None, [*_POLYSET, C.c_double, C.c_double,
                                  C.c_double, C.c_double, C.c_int, C.c_int,
                                  _u8p, C.c_uint8]),
        "geom_trace_mask": (C.c_void_p, [_u8p, C.c_int, C.c_int]),
    }
    for fn, (restype, argtypes) in signatures.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def library() -> C.CDLL:
    """The loaded core, built on first use (one build however many threads
    ask at once)."""
    with _load_lock:
        return _library_once()


_EMPTY_XY = np.zeros((0,), dtype=np.float64)
_EMPTY_I32 = np.zeros((0,), dtype=np.int32)


def empty_flat() -> FlatPolySet:
    return (_EMPTY_XY, _EMPTY_I32, _EMPTY_I32)


def pack(rings_per_poly: list[list[np.ndarray]]) -> FlatPolySet:
    """Pack [[shell, hole, ...], ...] (each ring an (N, 2) float64 array)
    into the flat arrays the core takes."""
    xs, sizes, prs = [], [], []
    for rings in rings_per_poly:
        prs.append(len(rings))
        for r in rings:
            r = np.ascontiguousarray(r, dtype=np.float64)
            sizes.append(len(r))
            xs.append(r.reshape(-1))
    if not xs:
        return empty_flat()
    return (np.concatenate(xs), np.asarray(sizes, dtype=np.int32),
            np.asarray(prs, dtype=np.int32))


def _collect(handle) -> list[list[np.ndarray]]:
    """Copy a result out of the core and free it: [[shell, hole, ...], ...]."""
    lib = library()
    try:
        ncoords = lib.geom_result_num_coords(handle)
        nrings = lib.geom_result_num_rings(handle)
        npolys = lib.geom_result_num_polys(handle)
        xy = np.empty(2 * ncoords, dtype=np.float64)
        sizes = np.empty(max(nrings, 1), dtype=np.int32)
        prs = np.empty(max(npolys, 1), dtype=np.int32)
        lib.geom_result_copy(handle, xy, sizes, prs)
    finally:
        lib.geom_result_free(handle)
    polys: list[list[np.ndarray]] = []
    off = ri = 0
    for pi in range(npolys):
        rings = []
        for _ in range(prs[pi]):
            n = int(sizes[ri])
            rings.append(xy[off:off + 2 * n].reshape(-1, 2).copy())
            off += 2 * n
            ri += 1
        polys.append(rings)
    return polys


def boolean_op(op: int, subj: FlatPolySet, clip: FlatPolySet):
    sxy, srs, spr = subj
    cxy, crs_, cpr = clip
    h = library().geom_boolean_op(op, sxy, srs, len(srs), spr, len(spr),
                                  cxy, crs_, len(crs_), cpr, len(cpr))
    return _collect(h)


def union_many(flat: FlatPolySet):
    xy, rs, pr = flat
    if len(pr) == 0:
        return []
    return _collect(library().geom_union_many(xy, rs, len(rs), pr, len(pr)))


def buffer_line(coords: np.ndarray, dist: float, cap_style: int = 1,
                quad_segs: int = 8):
    coords = np.ascontiguousarray(coords, dtype=np.float64)
    h = library().geom_buffer_line(coords.reshape(-1), len(coords), dist,
                                   cap_style, quad_segs)
    return _collect(h)


def buffer_polygon(flat: FlatPolySet, dist: float, quad_segs: int = 8):
    xy, rs, pr = flat
    h = library().geom_buffer_polygon(xy, rs, len(rs), pr, len(pr), dist,
                                      quad_segs)
    return _collect(h)


def points_in_polyset(points: np.ndarray, flat: FlatPolySet) -> np.ndarray:
    points = np.ascontiguousarray(points, dtype=np.float64)
    n = len(points)
    out = np.zeros(n, dtype=np.uint8)
    if n:
        xy, rs, pr = flat
        library().geom_points_in_polyset(points.reshape(-1), n, xy, rs,
                                         len(rs), pr, len(pr), out)
    return out.astype(bool)


def polyset_intersects(a: FlatPolySet, b: FlatPolySet) -> bool:
    axy, ars, apr = a
    bxy, brs, bpr = b
    return bool(library().geom_polyset_intersects(
        axy, ars, len(ars), apr, len(apr), bxy, brs, len(brs), bpr, len(bpr)))


def rasterize(flat: FlatPolySet, x0: float, dx: float, y0: float, dy: float,
              height: int, width: int, out: np.ndarray | None = None,
              value: int = 1) -> np.ndarray:
    """Even-odd fill of the packed rings at pixel centres x = x0 + (col +
    0.5)·dx, y = y0 + (row + 0.5)·dy into ``out`` (height, width) uint8
    (new when None); returns it."""
    lib = library()
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
    m = np.ascontiguousarray(mask, dtype=np.uint8)
    if m.ndim != 2:
        raise ValueError(f"trace_mask takes a 2-d mask, got {m.shape}")
    polys = _collect(library().geom_trace_mask(m, m.shape[0], m.shape[1]))
    return [rings[0] for rings in polys]
