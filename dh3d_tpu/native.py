"""ctypes bindings for the native host data-path library.

`native/dh3d_native.cpp` provides C++ versions of the host hot loop
(FPS + 1-NN pair generation, `core/datasets.py:143-150`) and the open3d
preprocessing (`core/utils.py:165-177`).  The first call builds the
shared library from source (`make -C native`, also the one command to
build it ahead of time); every function falls back to the numpy
implementation where it cannot be built.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_LIB = None
_TRIED = False
_LOCK = threading.Lock()


def _build():
    """`make -C native` (a no-op when the library is up to date)."""
    if shutil.which("make") is None:
        return
    try:
        subprocess.run(["make", "-s", "-C", _NATIVE_DIR], check=True,
                       capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        pass  # no compiler: the numpy fallbacks serve


def _load():
    global _LIB, _TRIED
    with _LOCK:
        if not _TRIED:
            _TRIED = True
            _build()
            _LIB = _open(os.path.join(_NATIVE_DIR, "libdh3d_native.so"))
        return _LIB


def _open(path):
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.dh3d_fps.argtypes = [f32p, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int, i32p]
    lib.dh3d_nn1.argtypes = [f32p, ctypes.c_int, f32p, ctypes.c_int,
                             ctypes.c_float, i32p, ctypes.c_void_p]
    lib.dh3d_knn.argtypes = [f32p, ctypes.c_int, ctypes.c_int, i32p,
                             ctypes.c_void_p]
    lib.dh3d_voxel_downsample.argtypes = [f32p, ctypes.c_int,
                                          ctypes.c_float, f32p]
    lib.dh3d_voxel_downsample.restype = ctypes.c_int
    lib.dh3d_radius_outlier.argtypes = [f32p, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_float, i32p]
    lib.dh3d_radius_outlier.restype = ctypes.c_int
    return lib


def available() -> bool:
    return _load() is not None


def _c3(x):
    return np.ascontiguousarray(np.asarray(x, np.float32).reshape(-1, 3))


def fps(points, m, seed_idx=0):
    """[N, 3] -> [m] int32 FPS indices (seeded at seed_idx)."""
    lib = _load()
    pts = _c3(points)
    if lib is None:
        from dh3d_tpu.data.io import FarthestSampler

        # numpy fallback has a random seed point; force the given seed
        sampler = FarthestSampler()

        class _Rng:
            def randint(self, _n):
                return seed_idx

        return sampler.sample(pts, m, _Rng()).astype(np.int32)
    out = np.empty(m, np.int32)
    lib.dh3d_fps(pts, pts.shape[0], m, int(seed_idx), out)
    return out


def nn1(query, ref, cell=1.0):
    """Nearest ref index for each query point; [Nq] int32."""
    lib = _load()
    q, r = _c3(query), _c3(ref)
    if lib is None:
        from scipy.spatial import cKDTree

        _, idx = cKDTree(r).query(q, k=1)
        return idx.astype(np.int32)
    out = np.empty(q.shape[0], np.int32)
    lib.dh3d_nn1(q, q.shape[0], r, r.shape[0], float(cell), out, None)
    return out


def knn(points, k):
    """Self-kNN [N, k] int32 ascending (self at slot 0) — host fallback for
    the precomputed-knn input path (`core/model.py:84-96`)."""
    lib = _load()
    pts = _c3(points)
    n = pts.shape[0]
    if lib is None:
        from scipy.spatial import cKDTree

        _, idx = cKDTree(pts).query(pts, k=k)
        return idx.astype(np.int32)
    out = np.empty((n, k), np.int32)
    lib.dh3d_knn(pts, n, k, out, None)
    return out


def voxel_downsample(points, voxel_size=0.2):
    lib = _load()
    pts = _c3(points)
    if lib is None:
        from dh3d_tpu.data.io import voxel_downsample as np_impl

        return np_impl(pts, voxel_size)
    out = np.empty_like(pts)
    m = lib.dh3d_voxel_downsample(pts, pts.shape[0], float(voxel_size), out)
    return out[:m].copy()


def remove_radius_outlier(points, nb_points=4, radius=1.0):
    lib = _load()
    pts = _c3(points)
    if lib is None:
        from dh3d_tpu.data.io import remove_radius_outlier as np_impl

        return np_impl(pts, nb_points, radius)
    keep = np.empty(pts.shape[0], np.int32)
    m = lib.dh3d_radius_outlier(pts, pts.shape[0], int(nb_points),
                                float(radius), keep)
    return keep[:m].copy()
