"""ctypes loader for the native host-precompute library.

Compiles ``topology.cpp`` on first use (g++ -O3 -shared -fPIC) into
``build/libeqlbtopo-<hash>.so`` next to the source, where ``<hash>`` is the
SHA-256 of the source: an edited source always gets a fresh build, and a
checkout never loads a library built from other code.  The build directory
is ignored by git.  All entry points have NumPy fallbacks in
``mesh.topology`` and ``eqlb.patches``, so the package works without a
toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(__file__)
_SRC = os.path.join(_HERE, "topology.cpp")
_BUILD = os.path.join(_HERE, "build")
_lock = threading.Lock()
_lib = None
_tried = False

_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def library_path() -> str:
    """Path of the library built from the current ``topology.cpp``."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD, f"libeqlbtopo-{digest}.so")


def _build(path: str):
    """Compile into a temporary file of the build directory and rename it
    into place, so concurrent first uses never load a half-written file."""
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
             "-o", tmp, _SRC],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            path = library_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
            lib.build_facets.restype = ctypes.c_int64
            lib.build_facets.argtypes = [
                ctypes.c_int64, _i32, ctypes.c_int64, _i32, _i32, _i32, _i32,
            ]
            lib.walk_patches.restype = ctypes.c_int
            lib.walk_patches.argtypes = [
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                _i32, _i32, _i32, _i64, _i32, _u8, _i64,
                _i32, _i32, _i32, _i32, _i32,
            ]
            lib.combine_fill.restype = ctypes.c_int
            lib.combine_fill.argtypes = [
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, _i32, _i32, _u8,
            ]
            lib.perm_signs_fill.restype = ctypes.c_int
            lib.perm_signs_fill.argtypes = [
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, _i32, _i32, _i32,
                _f64, _i32, _f64,
            ]
            _lib = lib
        except (OSError, subprocess.CalledProcessError):
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def build_facets(cells: np.ndarray, nv: int):
    """Native facet extraction; returns (facet_vertices, cell_facets,
    facet_cells, facet_local) or None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    nc = len(cells)
    cells = np.ascontiguousarray(cells, dtype=np.int32)
    cap = 3 * nc
    fv = np.empty((cap, 2), dtype=np.int32)
    cf = np.empty((nc, 3), dtype=np.int32)
    fc = np.empty((cap, 2), dtype=np.int32)
    fl = np.empty((cap, 2), dtype=np.int32)
    nf = lib.build_facets(nc, cells, nv, fv, cf, fc, fl)
    if nf < 0:
        raise ValueError("non-manifold mesh: facet shared by > 2 cells")
    return fv[:nf].copy(), cf, fc[:nf].copy(), fl[:nf].copy()


def combine_fill(ndofs: int, off: int, gdofs: np.ndarray,
                 src: np.ndarray, cur: np.ndarray) -> bool:
    """Native combine-table fill for one bucket (see topology.cpp); returns
    False when the library is unavailable (caller falls back to NumPy)."""
    lib = _load()
    if lib is None:
        return False
    Ppad, nflux = gdofs.shape
    rc = lib.combine_fill(
        ndofs, Ppad, nflux, off,
        np.ascontiguousarray(gdofs, dtype=np.int32), src, cur,
    )
    if rc != 0:
        raise RuntimeError("dof with more than 3 patch contributions")
    return True


def perm_signs(cells, entry_loc, exit_loc, dof_signs, k, kk1):
    """Native canonical-permutation + signs fill (see topology.cpp);
    returns (perm (P, n, nkeep) int32, signs (P, n, nkeep) f64) or None."""
    lib = _load()
    if lib is None:
        return None
    P, n = cells.shape
    nkeep = 2 * k + kk1
    perm = np.empty((P, n, nkeep), dtype=np.int32)
    signs = np.empty((P, n, nkeep), dtype=np.float64)
    lib.perm_signs_fill(
        P, n, k, kk1, dof_signs.shape[1],
        np.ascontiguousarray(cells, dtype=np.int32),
        np.ascontiguousarray(entry_loc, dtype=np.int32),
        np.ascontiguousarray(exit_loc, dtype=np.int32),
        np.ascontiguousarray(dof_signs, dtype=np.float64), perm, signs,
    )
    return perm, signs


def walk_patches(msh, counts: np.ndarray, nmax: int):
    """Native vertex-patch walk; returns the dense walk tables or None."""
    lib = _load()
    if lib is None:
        return None
    nv = msh.num_vertices
    cells_w = np.full((nv, nmax), -1, dtype=np.int32)
    lnode_w = np.zeros((nv, nmax), dtype=np.int32)
    entry_w = np.zeros((nv, nmax), dtype=np.int32)
    exit_w = np.zeros((nv, nmax), dtype=np.int32)
    spokes_w = np.full((nv, nmax + 1), -1, dtype=np.int32)
    lib.walk_patches(
        nv,
        msh.num_facets,
        nmax,
        np.ascontiguousarray(msh.cells, dtype=np.int32),
        np.ascontiguousarray(msh.cell_facets, dtype=np.int32),
        np.ascontiguousarray(msh.facet_cells, dtype=np.int32),
        np.ascontiguousarray(msh.v2f_offsets, dtype=np.int64),
        np.ascontiguousarray(msh.v2f_data, dtype=np.int32),
        np.ascontiguousarray(msh.is_boundary_facet.astype(np.uint8)),
        np.ascontiguousarray(counts, dtype=np.int64),
        cells_w, lnode_w, entry_w, exit_w, spokes_w,
    )
    return cells_w, lnode_w, entry_w, exit_w, spokes_w
