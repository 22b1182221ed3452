"""ctypes binding for the native C++ mesh preprocessor (native/*.cpp).

The library is not committed: it is built from native/mesh_preprocess.cpp
on first use with g++ -O3 and cached next to the source (git-ignored),
and rebuilt when the source is newer. Every entry point has a NumPy
fallback in ops/mesh.py, so the framework works even if no compiler is
available. Equality of the two paths is covered by tests/test_native.py.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_HERE), "native", "mesh_preprocess.cpp")
_LIB = os.path.join(os.path.dirname(_HERE), "native", "libcftmesh.so")
_lock = threading.Lock()
_lib = None
_build_failed = False


def _load():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            if (not os.path.exists(_LIB)) or (
                os.path.getmtime(_LIB) < os.path.getmtime(_SRC)
            ):
                # build beside the target and rename: processes that
                # load concurrently never see a half-written library
                tmp = f"{_LIB}.{os.getpid()}.tmp"
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                     "-o", tmp, _SRC],
                    check=True, capture_output=True,
                )
                os.replace(tmp, _LIB)
            lib = ctypes.CDLL(_LIB)
            lib.cft_preprocess_mesh.restype = ctypes.c_int
            lib.cft_preprocess_mesh.argtypes = [
                ctypes.c_int64, ctypes.c_int64,
                np.ctypeslib.ndpointer(np.int32, flags="C"),
                np.ctypeslib.ndpointer(np.uint8, flags="C"),
                np.ctypeslib.ndpointer(np.int64, flags="C"),
                np.ctypeslib.ndpointer(np.int32, flags="C"),
                ctypes.c_int64,
                np.ctypeslib.ndpointer(np.int64, flags="C"),
                np.ctypeslib.ndpointer(np.int32, flags="C"),
            ]
            lib.cft_structured_rectangle.restype = None
            lib.cft_structured_rectangle.argtypes = [
                ctypes.c_int64, ctypes.c_int64,
                ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
                np.ctypeslib.ndpointer(np.float64, flags="C"),
                np.ctypeslib.ndpointer(np.int32, flags="C"),
            ]
            _lib = lib
        except Exception:
            _build_failed = True
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def preprocess_mesh(n_nodes: int, cells: np.ndarray):
    """Returns (boundary_mask bool(N,), rowptr i64(N+1,), cols i32(nnz,),
    rcm_perm i32(N,) old->new) — or None if the native lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    cells = np.ascontiguousarray(cells, dtype=np.int32)
    n_cells = cells.shape[0]
    boundary = np.zeros(n_nodes, dtype=np.uint8)
    rowptr = np.zeros(n_nodes + 1, dtype=np.int64)
    cap = n_cells * 9 + n_nodes
    cols = np.zeros(cap, dtype=np.int32)
    nnz = np.zeros(1, dtype=np.int64)
    rcm = np.zeros(n_nodes, dtype=np.int32)
    rc = lib.cft_preprocess_mesh(
        n_nodes, n_cells, cells, boundary, rowptr, cols, cap, nnz, rcm
    )
    if rc != 0:
        return None
    return boundary.astype(bool), rowptr, cols[: int(nnz[0])].copy(), rcm


def structured_rectangle(nx: int, ny: int, x0=0.0, y0=0.0, x1=1.0, y1=1.0):
    """Native structured triangulation (right diagonal); None if no lib."""
    lib = _load()
    if lib is None:
        return None
    n_pts = (nx + 1) * (ny + 1)
    points = np.zeros((n_pts, 2), dtype=np.float64)
    cells = np.zeros((2 * nx * ny, 3), dtype=np.int32)
    lib.cft_structured_rectangle(nx, ny, x0, y0, x1, y1, points, cells)
    return points, cells.astype(np.int64)
