"""Top-down debug renderings of cells, poses and matches (counterpart of
``text2pos_tpu/utils/drawing.py``).

Rebuild of the reference's cv2 debug plots (the Text2Pos reference code,
datapreparation/kitti360pose/drawing.py:72-238): cells as
scatter of object points colored per object, the pose as a circle, match
arrows green (correct) / red (incorrect). The interactive pptk viewer is
intentionally not reproduced (headless environment). ``cv2`` is imported
when a function draws; where it is missing that call raises an
``ImportError`` naming ``cv2``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from text2pos_torch.data.structs import Cell, Pose


def require_cv2():
    """The ``cv2`` module, or an ``ImportError`` that names it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("drawing needs cv2 (OpenCV), which is not "
                          "installed") from e
    return cv2


def _canvas(size: int):
    return np.full((size, size, 3), 255, np.uint8)


def _to_px(xy: np.ndarray, size: int) -> np.ndarray:
    """Cell-normalized (x, y) → pixel (col, row) with y up."""
    xy = np.asarray(xy, np.float64)
    px = np.clip((xy * (size - 1)).astype(np.int64), 0, size - 1)
    px[..., 1] = size - 1 - px[..., 1]
    return px


def plot_cell(cell: Cell, size: int = 640,
              pose: Optional[np.ndarray] = None) -> np.ndarray:
    """Render a cell's objects (point scatter, mean color) to an RGB image
    (reference drawing.py:72-99)."""
    cv2 = require_cv2()
    img = _canvas(size)
    for obj in cell.objects:
        color = tuple(int(c * 255) for c in obj.get_color_rgb()[::-1])
        pts = _to_px(obj.xyz[:, 0:2], size)
        for x, y in pts[:: max(1, len(pts) // 400)]:
            cv2.circle(img, (int(x), int(y)), 1, color, -1)
        cx, cy = _to_px(obj.get_center()[0:2], size)
        cv2.putText(img, obj.label[:6], (int(cx), int(cy)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.35, (40, 40, 40), 1)
    if pose is not None:
        px, py = _to_px(np.asarray(pose)[0:2], size)
        cv2.circle(img, (int(px), int(py)), 7, (0, 0, 255), 2)
    return img


def plot_pose_in_best_cell(cell: Cell, pose: Pose, size: int = 640) -> np.ndarray:
    """Cell + pose + per-description closest points (drawing.py:199-236)."""
    cv2 = require_cv2()
    img = plot_cell(cell, size, pose=pose.pose)
    for d in pose.descriptions:
        x, y = _to_px(np.asarray(d.closest_point)[0:2], size)
        color = (0, 160, 0) if d.is_matched else (0, 0, 200)
        cv2.drawMarker(img, (int(x), int(y)), color,
                       cv2.MARKER_TILTED_CROSS, 10, 2)
    return img


def plot_matches_in_best_cell(cell: Cell, pose: Pose, matches0: np.ndarray,
                              size: int = 640) -> np.ndarray:
    """Match arrows object-center → pose; green if the object is a gt match
    (drawing.py:101-150)."""
    cv2 = require_cv2()
    img = plot_cell(cell, size, pose=pose.pose)
    gt_ids = {d.object_id for d in pose.descriptions if d.is_matched}
    px = _to_px(pose.pose[0:2], size)
    for obj_idx, hint_idx in enumerate(np.asarray(matches0)):
        if hint_idx < 0 or obj_idx >= len(cell.objects):
            continue
        obj = cell.objects[obj_idx]
        c = _to_px(obj.get_center()[0:2], size)
        color = (0, 180, 0) if obj.id in gt_ids else (0, 0, 220)
        cv2.arrowedLine(img, (int(c[0]), int(c[1])), (int(px[0]), int(px[1])),
                        color, 2, tipLength=0.06)
    return img


def plot_cells_and_poses(cells, poses, size: int = 900) -> np.ndarray:
    """Scene overview: all cell bboxes + pose positions in world coords
    (reference drawing.py:238+)."""
    cv2 = require_cv2()
    img = _canvas(size)
    boxes = np.array([c.bbox_w for c in cells])
    lo = boxes[:, 0:2].min(axis=0)
    hi = boxes[:, 3:5].max(axis=0)
    span = max(float((hi - lo).max()), 1e-6)

    def w2px(xy):
        p = (np.asarray(xy) - lo) / span * (size - 1)
        return int(p[0]), size - 1 - int(p[1])

    for c in cells:
        cv2.rectangle(img, w2px(c.bbox_w[0:2]), w2px(c.bbox_w[3:5]),
                      (180, 180, 180), 1)
    for p in poses:
        cv2.circle(img, w2px(p.pose_w[0:2]), 3, (0, 0, 220), -1)
    return img


def plot_retrievals(retrievals, cells, poses, count: int = 3,
                    size: int = 640):
    """Success/failure retrieval examples (reference training/utils.py:36):
    for each sampled pose, render its best cell and the top-1 retrieved
    cell side by side. Returns a list of (is_success, image) tuples."""
    cells_dict = {c.id: c for c in cells}
    out = []
    successes = [i for i in range(len(poses))
                 if retrievals[i][0] == poses[i].cell_id]
    failures = [i for i in range(len(poses))
                if retrievals[i][0] != poses[i].cell_id]
    for group, flag in ((successes[:count], True), (failures[:count], False)):
        for qi in group:
            pose = poses[qi]
            gt = plot_pose_in_best_cell(cells_dict[pose.cell_id], pose,
                                        size=size)
            top = plot_cell(cells_dict[retrievals[qi][0]], size=size)
            out.append((flag, np.concatenate([gt, top], axis=1)))
    return out
