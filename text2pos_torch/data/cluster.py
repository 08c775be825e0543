"""DBSCAN clustering for stuff-object splitting (host-side data prep).

The reference calls sklearn's DBSCAN with eps=0.75 and default
min_samples=5 (the Text2Pos reference code, datapreparation/kitti360pose/descriptions.py:43).
We prefer sklearn when present and otherwise fall back to a grid-bucketed
union-find implementation with identical cluster semantics (label ≥ 0 per
cluster, −1 for noise). The JAX package's C++ backend (its
``data/native.py``) is not carried over; the bench map has no stuff
objects and never clusters.
"""

from __future__ import annotations

import numpy as np

try:  # pragma: no cover - environment probe
    from sklearn.cluster import DBSCAN as _SkDBSCAN

    _HAVE_SKLEARN = True
except Exception:  # pragma: no cover
    _HAVE_SKLEARN = False


def dbscan_labels(points: np.ndarray, eps: float = 0.75, min_samples: int = 5,
                  force_numpy: bool = False, backend: str = "auto") -> np.ndarray:
    """Cluster labels per point: 0..K-1 for clusters, −1 for noise.

    Backends, in order of preference under ``auto``: sklearn, pure NumPy.
    """
    points = np.asarray(points, dtype=np.float64)
    if points.shape[0] == 0:
        return np.zeros((0,), dtype=np.int64)
    if force_numpy:
        backend = "numpy"
    if backend in ("auto", "sklearn") and _HAVE_SKLEARN:
        return _SkDBSCAN(eps=eps, min_samples=min_samples, n_jobs=-1).fit(points).labels_
    return _dbscan_numpy(points, eps, min_samples)


class _UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)

    def find(self, x: int) -> int:
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:  # path compression
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def _dbscan_numpy(points: np.ndarray, eps: float, min_samples: int) -> np.ndarray:
    """Grid-bucketed DBSCAN: hash points to eps-sized voxels, probe the
    3×3×3 neighborhood for range queries, then union core points."""
    n = points.shape[0]
    cell = np.floor(points / eps).astype(np.int64)
    buckets: dict = {}
    for i in range(n):
        buckets.setdefault(tuple(cell[i]), []).append(i)
    for k in buckets:
        buckets[k] = np.array(buckets[k], dtype=np.int64)

    offsets = [
        (dx, dy, dz)
        for dx in (-1, 0, 1)
        for dy in (-1, 0, 1)
        for dz in (-1, 0, 1)
    ]
    eps2 = eps * eps

    neighbor_lists = [None] * n
    counts = np.zeros(n, dtype=np.int64)
    for i in range(n):
        c = cell[i]
        cand = []
        for off in offsets:
            key = (c[0] + off[0], c[1] + off[1], c[2] + off[2])
            got = buckets.get(key)
            if got is not None:
                cand.append(got)
        cand = np.concatenate(cand)
        d2 = np.sum((points[cand] - points[i]) ** 2, axis=1)
        nb = cand[d2 <= eps2]
        neighbor_lists[i] = nb
        counts[i] = nb.size

    core = counts >= min_samples
    uf = _UnionFind(n)
    for i in range(n):
        if not core[i]:
            continue
        for j in neighbor_lists[i]:
            if core[j]:
                uf.union(i, int(j))

    labels = np.full(n, -1, dtype=np.int64)
    root_to_label: dict = {}
    for i in range(n):
        if core[i]:
            root = uf.find(i)
            if root not in root_to_label:
                root_to_label[root] = len(root_to_label)
            labels[i] = root_to_label[root]
    # Border points adopt the cluster of any core neighbor.
    for i in range(n):
        if labels[i] == -1:
            for j in neighbor_lists[i]:
                if core[j]:
                    labels[i] = labels[uf.find(int(j))]
                    break
    return labels
