"""Voxel-grid downsampling keeping the first point per voxel (counterpart
of ``text2pos_tpu/data/voxel.py``).

Replaces Open3D's ``voxel_down_sample_and_trace`` as the reference uses it
(the Text2Pos reference code, datapreparation/kitti360pose/prepare.py:70-84):
per voxel, the *first* point index of the trace. The port's C++ host
library computes it (``data/native.py``); the NumPy hash below is its plain
twin, taken only with ``force_numpy``.
"""

from __future__ import annotations

import numpy as np


def voxel_downsample_indices(points: np.ndarray, voxel_size: float,
                             force_numpy: bool = False) -> np.ndarray:
    """Indices of the first point in each occupied voxel, ascending (the
    order of first occurrence)."""
    assert voxel_size > 0
    if not force_numpy:
        from text2pos_torch.data import native

        return native.voxel_downsample_indices(points, voxel_size)
    coords = np.floor(points / voxel_size).astype(np.int64)
    coords -= coords.min(axis=0)
    # Collision-free linear key.
    dims = coords.max(axis=0) + 1
    key = (coords[:, 0] * dims[1] + coords[:, 1]) * dims[2] + coords[:, 2]
    _, first_idx = np.unique(key, return_index=True)
    return np.sort(first_idx)
