"""Localization accuracy (copies of ``text2pos_tpu/evaluation/metrics.py``'s
``calc_accuracies`` and ``print_accuracies``): predictions in the retrieved
cells are mapped to world coordinates, cross-scene retrievals count as
infinitely far, and top-k / threshold accuracies are averaged over the
queries."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from text2pos_torch.config import ServeConfig


def calc_accuracies(
    pose_w: np.ndarray,        # [Q, 2] ground-truth world positions
    cell_bbox_lo: np.ndarray,  # [Q, K, 2] retrieved cells' bbox minima
    cell_sizes: np.ndarray,    # [Q, K]
    pos_in_cells: np.ndarray,  # [Q, K, 2] predicted in-cell positions
    same_scene: np.ndarray,    # [Q, K] bool
    top_k: Sequence[int],
    threshs: Sequence[float],
) -> Dict[int, Dict[float, float]]:
    """Mean accuracy per (k, threshold) over all queries."""
    pred_w = cell_bbox_lo + pos_in_cells * cell_sizes[..., None]
    dists = np.linalg.norm(pose_w[:, None, :] - pred_w, axis=2)
    dists = np.where(same_scene, dists, np.inf)
    accs: Dict[int, Dict[float, float]] = {}
    for k in top_k:
        best = np.min(dists[:, :min(k, dists.shape[1])], axis=1)
        accs[k] = {t: float(np.mean(best <= t)) for t in threshs}
    return accs


def print_accuracies(accs: Dict, name: str = "", log=print) -> str:
    """Render the reference's accuracy table (evaluation/utils.py:57-69)."""
    lines = []
    if name:
        lines.append(f"\t\t{name}:")
    top_k = list(accs.keys())
    threshs = list(accs[top_k[0]].keys())
    lines.append("".join(f"\t\t\t\t{k}" for k in top_k))
    row = "/".join(str(t) for t in threshs) + ":"
    for k in top_k:
        row += "\t" + "/".join(f"{accs[k][t]:0.2f}" for t in threshs)
    lines.append(row)
    out = "\n".join(lines)
    log(out)
    return out


def served_accuracies(db: Dict[str, np.ndarray], top_idx: np.ndarray,
                      pos_in_cells: np.ndarray,
                      top_k: Sequence[int] = ServeConfig.top_k,
                      threshs: Sequence[float] = ServeConfig.threshs
                      ) -> Dict[int, Dict[float, float]]:
    """``calc_accuracies`` of served results [Q, K] against per-query
    ``pose_xy``/``pose_scene`` and per-cell ``cell_bbox_xy``/``cell_size``/
    ``cell_scene`` arrays (the bench-query fixture's fields)."""
    top_idx = np.asarray(top_idx, np.int64)
    return calc_accuracies(
        db["pose_xy"], db["cell_bbox_xy"][top_idx], db["cell_size"][top_idx],
        np.asarray(pos_in_cells, np.float32),
        db["cell_scene"][top_idx] == db["pose_scene"][:, None], top_k,
        threshs)
