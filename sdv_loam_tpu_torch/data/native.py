"""ctypes bindings for the native C++ data-staging runtime (native/staging.cpp).

Provides the C++ path for velodyne parsing, multithreaded undistortion
remap, and the background prefetch pipeline — the TPU build's counterpart
to the reference's C++ IO stack (DatasetReader.h, Undistort.cpp remap, ROS
callback queues). Falls back to pure NumPy when the shared library has not
been built (`make -C native`).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_LIB_PATHS = [
    os.path.join(os.path.dirname(__file__), "..", "..", "native",
                 "libsdv_staging.so"),
]


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    for p in _LIB_PATHS:
        p = os.path.abspath(p)
        if os.path.exists(p):
            lib = ctypes.CDLL(p)
            lib.sdv_read_velodyne.restype = ctypes.c_int
            lib.sdv_read_velodyne.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int]
            lib.sdv_undistort_remap.restype = None
            lib.sdv_undistort_remap.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                ctypes.c_int]
            lib.sdv_prefetcher_create.restype = ctypes.c_void_p
            lib.sdv_prefetcher_create.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_int]
            lib.sdv_prefetcher_next.restype = ctypes.c_int
            lib.sdv_prefetcher_next.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int)]
            lib.sdv_prefetcher_destroy.restype = None
            lib.sdv_prefetcher_destroy.argtypes = [ctypes.c_void_p]
            _LIB = lib
            return lib
    return None


def available() -> bool:
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def read_velodyne(path: str, max_points: int = 200000) -> np.ndarray:
    """(N, 3) float32 points; native fast path with NumPy fallback."""
    lib = _load()
    if lib is None:
        raw = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
        pts = raw[:, :3]
        return pts[np.isfinite(pts).all(axis=1)][:max_points]
    buf = np.empty((max_points, 3), np.float32)
    n = lib.sdv_read_velodyne(path.encode(), _fptr(buf), max_points)
    if n < 0:
        raise IOError(f"cannot read {path}")
    return buf[:n].copy()


def undistort_remap(src: np.ndarray, remap_x: np.ndarray, remap_y: np.ndarray,
                    n_threads: int = 4) -> np.ndarray:
    """Bilinear remap via the native multithreaded kernel."""
    lib = _load()
    in_h, in_w = src.shape
    out_h, out_w = remap_x.shape
    src = np.ascontiguousarray(src, np.float32)
    rx = np.ascontiguousarray(remap_x, np.float32)
    ry = np.ascontiguousarray(remap_y, np.float32)
    if lib is None:
        # NumPy fallback — same math as data.calib.Undistorter.undistort
        valid = rx >= 0
        x0 = np.clip(np.floor(rx).astype(np.int32), 0, in_w - 2)
        y0 = np.clip(np.floor(ry).astype(np.int32), 0, in_h - 2)
        ax = rx - x0
        ay = ry - y0
        out = (src[y0, x0] * (1 - ax) * (1 - ay)
               + src[y0, x0 + 1] * ax * (1 - ay)
               + src[y0 + 1, x0] * (1 - ax) * ay
               + src[y0 + 1, x0 + 1] * ax * ay)
        return np.where(valid, out, 0.0).astype(np.float32)
    dst = np.empty((out_h, out_w), np.float32)
    lib.sdv_undistort_remap(_fptr(src), in_w, in_h, _fptr(rx), _fptr(ry),
                            _fptr(dst), out_w, out_h, n_threads)
    return dst


class CloudPrefetcher:
    """Background prefetch of a velodyne sequence (native worker thread)."""

    def __init__(self, paths: list[str], max_points: int = 200000,
                 depth: int = 2):
        self.max_points = max_points
        lib = _load()
        self._lib = lib
        self._paths = list(paths)
        self._i = 0
        if lib is not None:
            arr = (ctypes.c_char_p * len(paths))(
                *[p.encode() for p in paths])
            self._h = lib.sdv_prefetcher_create(arr, len(paths), max_points,
                                                depth)
        else:
            self._h = None

    def next(self):
        """Returns (index, (N,3) cloud) or None at end of sequence."""
        if self._h is not None:
            buf = np.empty((self.max_points, 3), np.float32)
            idx = ctypes.c_int(-1)
            n = self._lib.sdv_prefetcher_next(self._h, _fptr(buf),
                                              ctypes.byref(idx))
            if n == -2:
                raise IOError(
                    f"cannot read {self._paths[int(idx.value)]}")
            if n < 0:
                return None
            return int(idx.value), buf[:n].copy()
        if self._i >= len(self._paths):
            return None
        i = self._i
        self._i += 1
        return i, read_velodyne(self._paths[i], self.max_points)

    def close(self):
        if self._h is not None:
            self._lib.sdv_prefetcher_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
