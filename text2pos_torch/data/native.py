"""ctypes bindings for the port's C++ host library for data preparation
(``text2pos_torch/native/t2p_native.cpp``; counterpart of
``text2pos_tpu/data/native.py``).

The library is compiled by ``g++`` at first use (``ops/_build.py``
``host_library``) and loaded. It replaces the reference's third-party
native code (Open3D's voxel grid, sklearn's DBSCAN) with first-party C++,
and adds host-side farthest-point sampling. A failed build raises with the
compiler's message: nothing falls back to the NumPy versions on its own.
Those are the plain twins, reached only when a caller asks for them
(``voxel.voxel_downsample_indices(force_numpy=True)``,
``cluster.dbscan_labels(backend="numpy")``).
"""

from __future__ import annotations

import ctypes

import numpy as np

from text2pos_torch.ops import _build

_I64P = ctypes.POINTER(ctypes.c_int64)
_F64P = ctypes.POINTER(ctypes.c_double)
_SIGNATURES = {
    "t2p_voxel_downsample": (ctypes.c_int64,
                             [_F64P, ctypes.c_int64, ctypes.c_double, _I64P]),
    "t2p_dbscan": (None, [_F64P, ctypes.c_int64, ctypes.c_double,
                          ctypes.c_int32, _I64P]),
    "t2p_fps": (None, [_F64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       _I64P]),
}


def get_lib() -> ctypes.CDLL:
    """The loaded host library (built first if needed); raises if it
    cannot be built or loaded."""
    lib = _build.host_library("t2p_native")
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.restype, fn.argtypes = restype, argtypes
    return lib


def _as_f64(points: np.ndarray) -> np.ndarray:
    pts = np.ascontiguousarray(points, dtype=np.float64)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"points must be [N, 3], got {pts.shape}")
    return pts


def voxel_downsample_indices(points: np.ndarray, voxel_size: float
                             ) -> np.ndarray:
    """Indices of the first point in each occupied voxel, ascending."""
    pts = _as_f64(points)
    out = np.empty(pts.shape[0], np.int64)
    kept = get_lib().t2p_voxel_downsample(
        pts.ctypes.data_as(_F64P), pts.shape[0], float(voxel_size),
        out.ctypes.data_as(_I64P))
    return np.sort(out[:kept])


def dbscan_labels(points: np.ndarray, eps: float, min_samples: int
                  ) -> np.ndarray:
    """DBSCAN labels per point: 0..K-1 numbered by the first core point of
    each cluster, −1 for noise."""
    pts = _as_f64(points)
    labels = np.empty(pts.shape[0], np.int64)
    get_lib().t2p_dbscan(pts.ctypes.data_as(_F64P), pts.shape[0], float(eps),
                         int(min_samples), labels.ctypes.data_as(_I64P))
    return labels


def fps_indices(points: np.ndarray, num_samples: int, start: int = 0
                ) -> np.ndarray:
    """Host-side farthest-point sampling from ``start``: ``num_samples``
    indices, the first index on ties."""
    pts = _as_f64(points)
    out = np.empty(num_samples, np.int64)
    get_lib().t2p_fps(pts.ctypes.data_as(_F64P), pts.shape[0],
                      int(num_samples), int(start), out.ctypes.data_as(_I64P))
    return out


def fps_indices_numpy(points: np.ndarray, num_samples: int, start: int = 0
                      ) -> np.ndarray:
    """The plain twin of ``fps_indices``: the same loop in NumPy, the same
    f64 arithmetic and the first index on ties."""
    pts = _as_f64(points)
    out = np.empty(num_samples, np.int64)
    if pts.shape[0] == 0 or num_samples <= 0:
        return out
    min_dist = np.full(pts.shape[0], 1e300)
    last = int(start)
    out[0] = last
    for s in range(1, num_samples):
        d = pts - pts[last]
        d = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
        np.minimum(min_dist, d, out=min_dist)
        last = int(np.argmax(min_dist))
        out[s] = last
    return out
