"""ctypes wrapper for the native BAL parser (``bal_loader.cpp``)."""

from __future__ import annotations

import ctypes

import numpy as np

from skeres.native import build_shared

_lib = ctypes.CDLL(build_shared("bal_loader", ["bal_loader.cpp"]))
_lib.bal_sizes.restype = ctypes.c_int
_lib.bal_sizes.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
_lib.bal_load.restype = ctypes.c_int
_lib.bal_load.argtypes = [
    ctypes.c_char_p,
    ctypes.POINTER(ctypes.c_int32),
    ctypes.POINTER(ctypes.c_int32),
    ctypes.POINTER(ctypes.c_double),
    ctypes.POINTER(ctypes.c_double),
    ctypes.POINTER(ctypes.c_double),
]


def load(path: str):
    """Returns (cameras, points, camera_index, point_index, observations)."""
    sizes = (ctypes.c_int64 * 3)()
    rc = _lib.bal_sizes(path.encode(), sizes)
    if rc != 0:
        raise IOError(f"bal_sizes({path}) failed with code {rc}")
    nc, npts, nobs = int(sizes[0]), int(sizes[1]), int(sizes[2])

    cam_idx = np.empty(nobs, dtype=np.int32)
    pt_idx = np.empty(nobs, dtype=np.int32)
    obs = np.empty((nobs, 2), dtype=np.float64)
    cameras = np.empty((nc, 9), dtype=np.float64)
    points = np.empty((npts, 3), dtype=np.float64)

    rc = _lib.bal_load(
        path.encode(),
        cam_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        pt_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        obs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        cameras.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        points.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if rc != 0:
        raise IOError(f"bal_load({path}) failed with code {rc}")
    return cameras, points, cam_idx, pt_idx, obs
