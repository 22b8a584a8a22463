"""The pathfinder in C++: A* and string-pulling on an occupancy grid.

``csrc/astar.cpp`` is built with ``g++`` at first use into ``_build/``
beside the package (the name carries a hash of the source and flags, so an
edited source rebuilds) and bound by ctypes. ``NavGrid.find_path`` goes
through it; where it cannot build, the call raises: the Python A*
(``NavGrid.find_path_plain``) breaks ties between equal-cost cells in
another order, so on grids with obstacles it gives other paths than the
JAX package, whose pathfinder is this one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "astar.cpp"
BUILD_DIR = _PKG / "_build"
# The JAX package's flags (sonicsim_tpu/_native_src/Makefile): the same
# floating-point code, so the same line-of-sight rounding.
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-march=native")

_lib = None


def build() -> Path:
    """Compile ``csrc/astar.cpp`` (once per source and flags) and return the
    shared library's path."""
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libastar_{key}.so"
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the pathfinder (csrc/astar.cpp) cannot build")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True,
                       text=True)
    if r.returncode != 0:
        raise RuntimeError(f"{cxx} failed ({r.returncode}):\n{r.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builds race harmlessly
    return out


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ip, up = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint8)
        lib.astar.restype = ctypes.c_int
        lib.astar.argtypes = [up] + [ctypes.c_int] * 6 + [ip, ctypes.c_int]
        lib.simplify_path.restype = ctypes.c_int
        lib.simplify_path.argtypes = [up, ctypes.c_int, ctypes.c_int, ip, ctypes.c_int]
        _lib = lib
    return _lib


def astar_path(occupancy: np.ndarray, start, goal, simplify: bool = True):
    """A* (8-connected) over a (nx, nz) bool grid from cell ``start`` to
    ``goal``, then string-pulled where ``simplify``: (n, 2) int cells, or
    None where the goal is unreachable."""
    lib = _library()
    occ = np.ascontiguousarray(occupancy, dtype=np.uint8)
    nx, nz = occ.shape
    buf = np.zeros(nx * nz * 2, np.int32)
    occ_p = occ.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    buf_p = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
    n = lib.astar(occ_p, nx, nz, int(start[0]), int(start[1]), int(goal[0]), int(goal[1]),
                  buf_p, nx * nz)
    if n < 0:
        return None
    if simplify and n > 2:
        n = lib.simplify_path(occ_p, nx, nz, buf_p, n)
    return buf[: 2 * n].reshape(n, 2).copy()
