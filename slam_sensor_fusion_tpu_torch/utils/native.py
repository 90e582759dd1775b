"""ctypes bindings for the native IO library (csrc/libsfio.so).

Loads the C++ fast paths for binary PCD parsing, loader Morton pre-sort
and approximate-time alignment; every entry point transparently falls back
to the NumPy implementation when the library is absent (it is built with
`make -C csrc`, and the package works without it). A copy of the JAX
package's `utils/native.py` whose fallbacks are the port's own NumPy
modules; host file I/O, not the device.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _find_lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for cand in (
        os.path.join(here, "csrc", "libsfio.so"),
        os.path.join(here, "libsfio.so"),
    ):
        if os.path.exists(cand):
            try:
                lib = ctypes.CDLL(cand)
            except OSError:
                continue
            lib.sfio_read_pcd.restype = ctypes.c_longlong
            lib.sfio_read_pcd.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_longlong,
            ]
            lib.sfio_write_pcd.restype = ctypes.c_int
            lib.sfio_write_pcd.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_longlong,
            ]
            lib.sfio_morton_sort.restype = None
            lib.sfio_morton_sort.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_longlong,
                ctypes.POINTER(ctypes.c_float),
            ]
            lib.sfio_page_frame.restype = ctypes.c_longlong
            lib.sfio_page_frame.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_longlong,
                ctypes.c_longlong,
                ctypes.c_float,
                ctypes.c_longlong,
                ctypes.c_longlong,
                ctypes.c_float,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.sfio_nearest_within.restype = None
            lib.sfio_nearest_within.argtypes = [
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_longlong,
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_longlong,
                ctypes.c_double,
                ctypes.POINTER(ctypes.c_longlong),
                ctypes.POINTER(ctypes.c_uint8),
            ]
            _LIB = lib
            break
    return _LIB


def available() -> bool:
    return _find_lib() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def read_pcd(path: str) -> np.ndarray:
    lib = _find_lib()
    if lib is None:
        from slam_sensor_fusion_tpu_torch.utils import pcdio

        return pcdio.read_pcd(path)
    n = lib.sfio_read_pcd(path.encode(), None, 0)
    if n < 0:
        raise IOError(f"failed to parse PCD: {path}")
    out = np.empty((n, 3), np.float32)
    got = lib.sfio_read_pcd(path.encode(), _fptr(out), n)
    if got != n:
        raise IOError(f"short PCD read: {path}")
    return out


def write_pcd(path: str, points: np.ndarray) -> None:
    lib = _find_lib()
    points = np.ascontiguousarray(np.asarray(points, np.float32).reshape(-1, 3))
    if lib is None:
        from slam_sensor_fusion_tpu_torch.utils import pcdio

        pcdio.write_pcd(path, points)
        return
    if lib.sfio_write_pcd(path.encode(), _fptr(points), points.shape[0]) != 0:
        raise IOError(f"failed to write PCD: {path}")


def morton_sort(points: np.ndarray) -> np.ndarray:
    lib = _find_lib()
    points = np.ascontiguousarray(np.asarray(points, np.float32).reshape(-1, 3))
    if lib is None or points.shape[0] == 0:
        from slam_sensor_fusion_tpu_torch.ops.morton import sort_points_numpy

        return sort_points_numpy(points)
    out = np.empty_like(points)
    lib.sfio_morton_sort(_fptr(points), points.shape[0], _fptr(out))
    return out


def nearest_within(query_t: np.ndarray, stream_t: np.ndarray, slop: float):
    lib = _find_lib()
    if lib is None:
        from slam_sensor_fusion_tpu_torch.utils.timesync import (
            nearest_within as np_impl,
        )

        return np_impl(query_t, stream_t, slop)
    q = np.ascontiguousarray(np.asarray(query_t, np.float64))
    s = np.ascontiguousarray(np.asarray(stream_t, np.float64))
    idx = np.empty(len(q), np.int64)
    ok = np.empty(len(q), np.uint8)
    lib.sfio_nearest_within(
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(q),
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(s),
        slop,
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return idx, ok.astype(bool)


def page_frame(
    scan: np.ndarray,
    subsample_step: int,
    crop_radius: float,
    capacity: int,
    tile: int,
    sentinel: float,
):
    """Whole per-frame host staging (subsample -> crop -> Morton sort ->
    page pack -> tile bboxes) via the native loader; returns
    (pages (nSt, 3, TM), lo (nSt, 3), hi (nSt, 3), cnt (nSt,)) or None
    when the library is not built (callers fall back to NumPy)."""
    lib = _find_lib()
    if lib is None:
        return None
    scan = np.ascontiguousarray(np.asarray(scan, np.float32).reshape(-1, 3))
    nSt = capacity // tile
    pages = np.empty((nSt, 3, tile), np.float32)
    lo = np.empty((nSt, 3), np.float32)
    hi = np.empty((nSt, 3), np.float32)
    cnt = np.empty((nSt,), np.int32)
    got = lib.sfio_page_frame(
        _fptr(scan), scan.shape[0], subsample_step, crop_radius,
        capacity, tile, sentinel, _fptr(pages), _fptr(lo), _fptr(hi),
        cnt.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    if got < 0:
        return None
    return pages, lo, hi, cnt
