"""ctypes bindings for the native C++ setup core (native/setup_core.cpp).

Builds the shared library on first use with g++ (kept next to the source,
not tracked by git);
every entry point has a NumPy fallback in the Python setup layer, so the
framework works without a compiler — the native path is the default when
available, mirroring the reference's all-C++ setup (SURVEY.md §2a).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_HERE, "native", "setup_core.cpp")
_LIB = os.path.join(_HERE, "native", "libsetup_core.so")

_lib = None


def _build() -> bool:
    """Compile the library into a private file, then rename it into place:
    concurrent first users (test workers) never load a half-written file.
    Portable code generation (no -march=native): a checkout may be copied
    to a host with another CPU."""
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", _SRC, "-o", tmp],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SRC):
        return None
    if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_LIB)
    except OSError:
        return None
    d = ctypes.POINTER(ctypes.c_double)
    lib.assemble_global_1d.argtypes = [d, d, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_double, ctypes.c_int, d, d]
    lib.fdm_1d_matrices.argtypes = [d, d, ctypes.c_int, ctypes.c_int, d,
                                    ctypes.c_int, ctypes.c_int, d, d]
    lib.generalized_eigh.argtypes = [ctypes.c_int, d, d, d, d]
    lib.generalized_eigh.restype = ctypes.c_int
    lib.fdm_direction_transform.argtypes = [d, ctypes.c_int, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_int, d]
    _lib = lib
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def assemble_global_1d(M_ref, K_ref, p, n_cells, h, periodic):
    lib = get_lib()
    if lib is None:
        return None
    N = p * n_cells if periodic else p * n_cells + 1
    M = np.zeros((N, N))
    K = np.zeros((N, N))
    Mr = np.ascontiguousarray(M_ref)
    Kr = np.ascontiguousarray(K_ref)
    lib.assemble_global_1d(_ptr(Mr), _ptr(Kr), p, n_cells, float(h),
                           int(periodic), _ptr(M), _ptr(K))
    return M, K


def fdm_1d_matrices(M_ref, K_ref, p, overlap, extents, bc_left, bc_right):
    lib = get_lib()
    if lib is None:
        return None
    m = p - 1 + 2 * overlap
    Mw = np.zeros((m, m))
    Kw = np.zeros((m, m))
    bc = {"dirichlet": 0, "neumann": 1, "internal": 2}
    ext = np.ascontiguousarray(np.asarray(extents, dtype=np.float64))
    Mr = np.ascontiguousarray(M_ref)
    Kr = np.ascontiguousarray(K_ref)
    lib.fdm_1d_matrices(_ptr(Mr), _ptr(Kr), p, overlap, _ptr(ext),
                        bc[bc_left], bc[bc_right], _ptr(Mw), _ptr(Kw))
    return Mw, Kw


def generalized_eigh(K, M):
    lib = get_lib()
    if lib is None:
        return None
    n = K.shape[0]
    lam = np.zeros(n)
    V = np.zeros((n, n))
    Kc = np.ascontiguousarray(K)
    Mc = np.ascontiguousarray(M)
    if lib.generalized_eigh(n, _ptr(Kc), _ptr(Mc), _ptr(lam), _ptr(V)) != 0:
        return None
    return lam, V


def fdm_direction_transform(V, n_nodes, p, overlap, periodic):
    lib = get_lib()
    if lib is None:
        return None
    C, m, _ = V.shape
    G = np.zeros((C * m, n_nodes))
    Vc = np.ascontiguousarray(V)
    lib.fdm_direction_transform(_ptr(Vc), C, m, n_nodes, p, overlap,
                                int(periodic), _ptr(G))
    return G
