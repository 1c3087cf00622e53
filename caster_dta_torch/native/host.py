"""ctypes loader and wrappers for the port's native host library
(``caster_dta_torch/csrc/caster_host.cpp``; counterpart of
caster_dta_tpu/native/host.py).

The C++ library fuses protein edge thresholding with featurization, emitting
COO edges directly instead of the reference's dense n*n NaN-marked tensors
(utils/create_protein_features.py:201-357 + utils/create_graphs.py:6-62). It
is built with ``g++`` at first use into ``caster_dta_torch/_build/`` (beside
the CUDA builds of ops/build.py), under a name keyed by a hash of the source
and the flags, and bound with ctypes. Nothing falls back: a failed build
raises. The numpy path runs only where a caller asks for it by argument
(``data/build.py``, ``sort_edges_by_dst(native=False)``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(PACKAGE_DIR, "csrc", "caster_host.cpp")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_MODES = {"dist": 0, "num": 1, "prop": 2}
_lock = threading.Lock()
_lib = None


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"caster_host_{key}.so")


def _build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = ["g++", *GXX_FLAGS, "-o", tmp, SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}) on {SOURCE}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)   # atomic: a concurrent loader sees all or nothing


def load_library() -> ctypes.CDLL:
    """Load the native library, building it first when needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.isfile(path):
            _build(path)
        lib = ctypes.CDLL(path)
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.cdt_protein_edges.restype = ctypes.c_int64
        lib.cdt_protein_edges.argtypes = [
            f32p, ctypes.c_int64, ctypes.c_double, ctypes.c_int,
            ctypes.c_int, i32p, i32p, f32p, f32p, ctypes.c_int64]
        lib.cdt_sort_edges_by_dst.restype = ctypes.c_int64
        lib.cdt_sort_edges_by_dst.argtypes = [i32p, ctypes.c_int64, i32p]
        _lib = lib
        return _lib


def protein_edges(alpha: np.ndarray, edge_thresh: float, thresh_type: str,
                  keep_self_loops: bool):
    """Fused threshold+featurize of residue edges.

    alpha: [n, 3] float32 CA coordinates. Returns (src i32 [E], dst i32 [E],
    edge_s f32 [E, 32], edge_v f32 [E, 1, 3]) in row-major (src-major) order —
    the same order np.nonzero gives the dense path.
    """
    lib = load_library()
    alpha = np.ascontiguousarray(alpha, np.float32)
    n = alpha.shape[0]
    mode = _MODES[thresh_type]
    dummy_i = np.empty(0, np.int32)
    dummy_f = np.empty(0, np.float32)
    e = lib.cdt_protein_edges(alpha, n, float(edge_thresh), mode,
                              int(keep_self_loops), dummy_i, dummy_i,
                              dummy_f, dummy_f, 0)
    src = np.empty(e, np.int32)
    dst = np.empty(e, np.int32)
    edge_s = np.empty((e, 32), np.float32)
    edge_v = np.empty((e, 3), np.float32)
    e2 = lib.cdt_protein_edges(alpha, n, float(edge_thresh), mode,
                               int(keep_self_loops), src, dst,
                               edge_s.reshape(-1), edge_v.reshape(-1), e)
    if e2 != e:
        raise RuntimeError("edge count changed between the sizing and fill passes")
    return src, dst, edge_s, edge_v.reshape(e, 1, 3)


def sort_edges_by_dst(dst: np.ndarray, native: bool = True) -> np.ndarray:
    """Stable-by-dst permutation of edge indices: the native counting sort, or
    ``np.argsort(kind='stable')`` with ``native=False``."""
    dst = np.ascontiguousarray(dst, np.int32)
    if not native:
        return np.argsort(dst, kind="stable").astype(np.int32)
    perm = np.empty(len(dst), np.int32)
    load_library().cdt_sort_edges_by_dst(dst, len(dst), perm)
    return perm
