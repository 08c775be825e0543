"""Image datasets + headless scene renderer for the visloc side experiment
(counterpart of ``text2pos_tpu/data/images.py``).

Equivalents of the reference's PIL datasets (the Text2Pos reference code,
dataloading/kitti360pose/images.py:16-113) and its pptk-based scene
renderer (datapreparation/kitti360pose/rendering.py).
The datasets keep the exact directory/pickle layout so prepared visloc
folders are interchangeable; images come back as numpy arrays (the NetVLAD
feature extractor in this environment is external — evaluation/visloc.py
consumes pickled features).

The renderer replaces pptk (interactive OpenGL, unusable headless) with a
pinhole projection + z-buffer point splat in numpy/cv2 — enough to produce
the "rendered" db/query images Kitti360ImageDataset pairs with real ones.
``cv2`` is imported where an image is read or written; where it is missing
that call raises an ``ImportError`` naming ``cv2``. Pose pickles are read
through the restricted unpickler of ``data/legacy.py``.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from text2pos_torch.data.legacy import load_pickle
from text2pos_torch.utils.drawing import require_cv2


def _load_image(path: str) -> np.ndarray:
    cv2 = require_cv2()
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class Kitti360ImageCompareDataset:
    """{base}/visloc/{scene}/{db|query}/ → (pose, image) samples
    (reference images.py:16-45)."""

    def __init__(self, base_path: str, scene_name: str, db_or_query: str,
                 transform=None):
        assert db_or_query in ("db", "query")
        self.transform = transform
        root = osp.join(base_path, "visloc", scene_name, db_or_query)
        self.poses = load_pickle(osp.join(root, "poses.pkl"))
        self.image_paths = np.array(sorted(
            osp.join(root, f) for f in os.listdir(root) if f.endswith(".png")))
        assert len(self.poses) == len(self.image_paths)

    def __len__(self):
        return len(self.poses)

    def __getitem__(self, idx: int) -> Dict:
        img = _load_image(self.image_paths[idx])
        if self.transform:
            img = self.transform(img)
        return {"poses": self.poses[idx], "images": img}


class Kitti360ImageDataset:
    """{base}/{scene}/real/{split}/ (+ optional rendered/) paired with
    poses_{split}.pkl (reference images.py:48-113)."""

    def __init__(self, base_path: str, scene_name: str, split: str,
                 transform=None):
        assert split in ("db", "query")
        self.transform = transform
        self.poses = load_pickle(osp.join(base_path, scene_name,
                                          f"poses_{split}.pkl"))
        real_dir = osp.join(base_path, scene_name, "real", split)
        self.image_paths = np.array(sorted(
            osp.join(real_dir, f) for f in os.listdir(real_dir)
            if f.endswith(".png")))
        rend_dir = osp.join(base_path, scene_name, "rendered", split)
        self.image_paths_rendered: Optional[np.ndarray] = None
        if osp.isdir(rend_dir):
            self.image_paths_rendered = np.array(sorted(
                osp.join(rend_dir, f) for f in os.listdir(rend_dir)
                if f.endswith(".png")))
            assert len(self.image_paths) == len(self.image_paths_rendered)
        assert len(self.poses) == len(self.image_paths)

    def __len__(self):
        return len(self.poses)

    def __getitem__(self, idx: int) -> Dict:
        img = _load_image(self.image_paths[idx])
        if self.transform:
            img = self.transform(img)
        data = {"poses": self.poses[idx], "images": img}
        if self.image_paths_rendered is not None:
            rend = _load_image(self.image_paths_rendered[idx])
            if self.transform:
                rend = self.transform(rend)
            data["images_rendered"] = rend
        return data


# ----------------------------------------------------------------------
# Headless point-cloud rendering (pptk stand-in)
# ----------------------------------------------------------------------
def concat_objects(objects) -> Tuple[np.ndarray, np.ndarray]:
    """(reference rendering.py:18-21)"""
    xyz = np.vstack([o.xyz for o in objects])
    rgb = np.vstack([o.rgb for o in objects])
    return xyz, rgb


def render_view(xyz: np.ndarray, rgb: np.ndarray, eye: np.ndarray,
                look_dir: np.ndarray, up=(0.0, 0.0, 1.0),
                size: Tuple[int, int] = (256, 256), fov_deg: float = 90.0,
                point_px: int = 2) -> np.ndarray:
    """Pinhole projection + z-buffered point splat.

    Args:
        xyz/rgb: [N, 3] scene points and colors in [0, 1]
        eye:     camera position (world)
        look_dir: viewing direction (world)

    Returns:
        [H, W, 3] uint8 RGB image.
    """
    H, W = size
    fwd = np.asarray(look_dir, np.float64)
    fwd = fwd / max(np.linalg.norm(fwd), 1e-9)
    upv = np.asarray(up, np.float64)
    right = np.cross(fwd, upv)
    nr = np.linalg.norm(right)
    if nr < 1e-6:  # looking straight along up — pick any right vector
        right = np.array([1.0, 0.0, 0.0])
        nr = 1.0
    right = right / nr
    cam_up = np.cross(right, fwd)

    rel = xyz - np.asarray(eye, np.float64)
    z = rel @ fwd
    in_front = z > 0.1
    rel, z, col = rel[in_front], z[in_front], rgb[in_front]
    f = 0.5 * W / np.tan(np.deg2rad(fov_deg) / 2)
    u = (rel @ right) / z * f + W / 2
    v = -(rel @ cam_up) / z * f + H / 2
    ok = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    u, v, z, col = u[ok].astype(np.int32), v[ok].astype(np.int32), z[ok], col[ok]

    # z-buffer: nearest point wins per pixel (paint far → near).
    order = np.argsort(-z)
    img = np.zeros((H, W, 3), np.uint8)
    colors = (np.clip(col[order], 0, 1) * 255).astype(np.uint8)
    uu, vv = u[order], v[order]
    r = max(0, point_px // 2)
    for du in range(-r, r + 1):
        for dv in range(-r, r + 1):
            ui = np.clip(uu + du, 0, W - 1)
            vi = np.clip(vv + dv, 0, H - 1)
            img[vi, ui] = colors
    return img


def render_poses(objects: Sequence, poses_w: np.ndarray, out_dir: str,
                 orientations: Optional[np.ndarray] = None,
                 size: Tuple[int, int] = (256, 256)) -> List[str]:
    """Render one view per pose into ``out_dir`` (pptk capture-loop
    replacement, reference rendering.py:43-80). ``orientations``: [Q, 3]
    per-pose viewing directions (defaults to +x)."""
    cv2 = require_cv2()
    os.makedirs(out_dir, exist_ok=True)
    xyz, rgb = concat_objects(objects)
    paths = []
    for i, pose in enumerate(np.asarray(poses_w, np.float64)):
        d = (orientations[i] if orientations is not None
             else np.array([1.0, 0.0, 0.0]))
        img = render_view(xyz, rgb, eye=pose + np.array([0, 0, 1.7]),
                          look_dir=d, size=size)
        path = osp.join(out_dir, f"{i:05d}.png")
        cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        paths.append(path)
    return paths
