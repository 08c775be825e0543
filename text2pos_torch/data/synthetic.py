"""Synthetic KITTI360Pose-like data generation.

Generates random scenes of blob objects and drives them through the *real*
cell / description / grounding pipeline, producing `Cell` and `Pose`
structures indistinguishable (format-wise) from prepared KITTI360Pose data.
Used by the test-suite, benchmarks and demo training runs — this environment
has no raw KITTI360 data.

The reference's synthetic path (create_synthetic_cell and the deprecated
Kitti360FineSyntheticDataset, the Text2Pos reference code, dataloading/kitti360pose/
synthetic.py:50-202) only mocked the fine stage; this generator covers the
full coarse+fine data model.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from text2pos_torch.constants import COLORS, STUFF_CLASSES
from text2pos_torch.data.descriptions import (
    create_cell,
    create_synthetic_cell,
    describe_pose_in_pose_cell,
    ground_pose_to_best_cell,
)
from text2pos_torch.data.structs import Cell, Object3d, Pose

# Instance classes only: keeps generation fast (no DBSCAN) by default.
_INSTANCE_LABELS = [
    "building", "pole", "traffic light", "traffic sign", "garage",
    "stop", "smallpole", "lamp", "trash bin", "vending machine", "box",
]

# Class-conditioned geometry/appearance so classes are *learnable* and the
# text ↔ geometry correlation transfers across synthetic scenes:
# (xy-spread, z-spread, point count, preferred color-center indices).
_CLASS_PROFILES = {
    "building":        (6.0, 4.0, 320, (1, 2, 4)),
    "garage":          (4.0, 2.0, 220, (2, 4)),
    "pole":            (0.15, 3.5, 80, (5, 6)),
    "smallpole":       (0.1, 1.5, 60, (5, 6)),
    "traffic light":   (0.3, 2.5, 70, (5, 0)),
    "traffic sign":    (0.4, 2.0, 70, (3, 7)),
    "stop":            (0.3, 1.5, 60, (3,)),
    "lamp":            (0.2, 3.0, 60, (7, 3)),
    "trash bin":       (0.5, 0.8, 80, (0, 6)),
    "vending machine": (0.6, 1.2, 80, (1, 4)),
    "box":             (0.8, 0.8, 80, (2, 1)),
}


def make_blob_object(rng: np.random.Generator, obj_id: int, instance_id: int,
                     center: np.ndarray, label: str,
                     num_points: int = 0, spread: float = 0.0) -> Object3d:
    """A synthetic object with class-characteristic shape and color."""
    xy_spread, z_spread, n_pts, color_choices = _CLASS_PROFILES.get(
        label, (2.0, 2.0, 120, tuple(range(len(COLORS)))))
    if num_points:
        n_pts = num_points
    scale = np.array([xy_spread, xy_spread, z_spread])
    xyz = center + rng.normal(size=(n_pts, 3)) * scale
    base_rgb = COLORS[color_choices[rng.integers(0, len(color_choices))]]
    rgb = np.clip(base_rgb + rng.normal(scale=0.03, size=(n_pts, 3)), 0.0, 1.0)
    return Object3d(obj_id, instance_id, xyz, rgb, label)


def make_synthetic_scene(rng: np.random.Generator, extent: float = 120.0,
                         objects_per_cell_area: int = 12, cell_size: float = 30.0,
                         include_stuff: bool = False) -> List[Object3d]:
    """Scatter blob objects over an extent×extent world at z∈[0, cell_size]."""
    objects: List[Object3d] = []
    instance_id = 0
    num_areas = max(1, int(extent // cell_size))
    for gx in range(num_areas):
        for gy in range(num_areas):
            lo = np.array([gx * cell_size, gy * cell_size, 0.0])
            for _ in range(objects_per_cell_area):
                center = lo + rng.random(3) * np.array([cell_size, cell_size, cell_size / 3])
                label = _INSTANCE_LABELS[rng.integers(0, len(_INSTANCE_LABELS))]
                objects.append(
                    make_blob_object(rng, obj_id=instance_id, instance_id=instance_id,
                                     center=center, label=label)
                )
                instance_id += 1
            if include_stuff:
                label = STUFF_CLASSES[rng.integers(0, len(STUFF_CLASSES))]
                pts = rng.random((1200, 3)) * np.array([cell_size, cell_size, 0.5]) + lo
                rgb = np.clip(
                    COLORS[rng.integers(0, len(COLORS))]
                    + rng.normal(scale=0.02, size=(1200, 3)),
                    0, 1,
                )
                objects.append(Object3d(instance_id, instance_id, pts, rgb, label))
                instance_id += 1
    return objects


def make_synthetic_dataset(
    seed: int = 0,
    scene_name: str = "9999",
    extent: float = 120.0,
    cell_size: float = 30.0,
    num_mentioned: int = 6,
    poses_per_cell: int = 2,
    objects_per_cell_area: int = 12,
    include_stuff: bool = False,
    describe_by: str = "closest",
) -> Tuple[List[Cell], List[Pose]]:
    """Full synthetic dataset: grid cells plus grounded, described poses.

    Mirrors the structure of prepare.py's create_cells/create_poses
    (the Text2Pos reference code, datapreparation/kitti360pose/prepare.py:216-427) on a
    synthetic scene: non-overlapping grid cells, poses randomly placed in
    cells, descriptions made in an ego-centered pose cell and grounded to
    the nearest database cell.
    """
    rng = np.random.default_rng(seed)
    scene_objects = make_synthetic_scene(
        rng, extent=extent, objects_per_cell_area=objects_per_cell_area,
        cell_size=cell_size, include_stuff=include_stuff,
    )

    # Spatial prefilter: create_cell scans every candidate object's points,
    # which is quadratic in scene size. An object whose center is farther
    # than `margin` outside a cell's bbox cannot reach the
    # ≥1/3-points-inside keep criterion, so only near objects are passed.
    # Cuts generation from O(cells·all_objects) to O(cells·local). The
    # margin is derived from the largest class blob spread (4σ covers
    # >99.99% of a Gaussian blob's points) rather than hard-coding one
    # cell_size, so the "identical output" invariant holds for nondefault
    # small cell sizes too.
    obj_centers = np.array([o.get_center()[0:2] for o in scene_objects])
    max_xy_spread = max(p[0] for p in _CLASS_PROFILES.values())
    margin = max(cell_size, 4.0 * max_xy_spread)

    def near_objects(bbox):
        m = ((obj_centers[:, 0] >= bbox[0] - margin)
             & (obj_centers[:, 0] <= bbox[3] + margin)
             & (obj_centers[:, 1] >= bbox[1] - margin)
             & (obj_centers[:, 1] <= bbox[4] + margin))
        return [scene_objects[i] for i in np.flatnonzero(m)]

    # Database cells on a grid.
    cells: List[Cell] = []
    num_areas = max(1, int(extent // cell_size))
    idx = 0
    for gx in range(num_areas):
        for gy in range(num_areas):
            lo = np.array([gx * cell_size, gy * cell_size, 0.0])
            bbox = np.hstack((lo, lo + cell_size))
            cell = create_cell(idx, scene_name, bbox, near_objects(bbox),
                               num_mentioned=num_mentioned)
            if cell is not None:
                cells.append(cell)
                idx += 1

    cell_centers = np.array([c.get_center() for c in cells])

    poses: List[Pose] = []
    for cell in cells:
        for _ in range(poses_per_cell):
            # Keep the pose inside the central region so the pose-cell has
            # enough candidates and grounding asserts hold.
            frac = 0.25 + 0.5 * rng.random(3)
            location = cell.bbox_w[0:3] + frac * (cell.bbox_w[3:6] - cell.bbox_w[0:3])

            dists = np.linalg.norm(location - cell_centers, axis=1)
            best_cell = cells[int(np.argmin(dists))]

            pose_cell_bbox = np.hstack((location - cell_size / 2, location + cell_size / 2))
            pose_cell = create_cell(-1, "pose", pose_cell_bbox,
                                    near_objects(pose_cell_bbox),
                                    num_mentioned=num_mentioned)
            if pose_cell is None:
                continue
            descriptions = describe_pose_in_pose_cell(
                location, pose_cell, describe_by, num_mentioned
            )
            if descriptions is None:
                continue
            best_descriptions, pose_in_cell, _ = ground_pose_to_best_cell(
                location, descriptions, best_cell
            )
            poses.append(
                Pose(pose_in_cell, location, best_cell.id, best_cell.scene_name,
                     best_descriptions, described_by=describe_by)
            )

    assert len(cells) > 0 and len(poses) > 0
    return cells, poses


def make_synthetic_fine_cell_and_pose(
    rng: np.random.Generator,
    num_mentioned: int = 6,
    pad_size: int = 16,
    num_distractors="all",
    describe_by: str = "closest",
    cell_idx: int = 0,
    scene_name: str = "synt",
) -> Tuple[Cell, Pose]:
    """One synthetic fine-stage training sample in the unit cell.

    Mirrors the reference's Kitti360FineSyntheticDataset generation
    (the Text2Pos reference code, dataloading/kitti360pose/synthetic.py:77-140):
    ``num_mentioned + num_distractors`` objects placed in [0,1]², described
    from a random pose, then up to num_mentioned/2 of the matched objects
    deleted so grounding produces dustbin (unmatched) pairs.

    ``num_distractors`` follows the reference's --num_distractors flag
    (training/args.py:13,82; synthetic.py:91-96): the string "all" draws a
    random count in [0, pad_size - num_mentioned) per sample, an int fixes
    the count.
    """
    if num_distractors == "all":
        n_extra = (int(rng.integers(0, pad_size - num_mentioned))
                   if pad_size > num_mentioned else 0)
    else:
        n_extra = int(num_distractors)

    pose_w = rng.random(3)

    objects: List[Object3d] = []
    for i in range(num_mentioned + n_extra):
        label = _INSTANCE_LABELS[rng.integers(0, len(_INSTANCE_LABELS))]
        center = np.concatenate([rng.random(2), [0.3 * rng.random()]])
        obj = make_blob_object(rng, obj_id=i, instance_id=i, center=center,
                               label=label)
        obj.xyz /= 30.0  # cell-normalized scale for the world-scale blobs
        obj.xyz[:, 0:2] += center[0:2] - np.mean(obj.xyz[:, 0:2], axis=0)
        objects.append(obj)

    unit_bbox = np.array([0, 0, 0, 1, 1, 1], np.float64)
    pose_cell = create_synthetic_cell(unit_bbox, objects,
                                      min_objects=num_mentioned)
    assert pose_cell is not None

    # max_dist=inf: pose-cell and best-cell share the same bbox here
    # (reference synthetic.py:113-116).
    descriptions = describe_pose_in_pose_cell(
        pose_w, pose_cell, describe_by, num_mentioned, max_dist=np.inf)
    assert descriptions is not None

    num_delete = int(rng.integers(0, num_mentioned // 2 + 1))
    num_delete = min(num_delete, len(objects) - num_mentioned)
    mentioned_ids = [d.object_id for d in descriptions]
    delete_ids = set(
        rng.choice(mentioned_ids, size=num_delete, replace=False).tolist()
        if num_delete else [])
    kept = [o for o in objects if o.id not in delete_ids]

    best_cell = create_synthetic_cell(unit_bbox, kept,
                                      min_objects=num_mentioned - num_delete)
    assert best_cell is not None
    best_cell.id = f"{scene_name}_{cell_idx:05d}"

    best_descriptions, pose_in_cell, _ = ground_pose_to_best_cell(
        pose_w, descriptions, best_cell)
    pose = Pose(pose_in_cell, pose_w, best_cell.id, scene_name,
                best_descriptions, described_by=describe_by)
    return best_cell, pose


def make_synthetic_fine_dataset(
    seed: int = 0,
    length: int = 64,
    num_mentioned: int = 6,
    pad_size: int = 16,
    num_distractors="all",
    describe_by: str = "closest",
) -> Tuple[List[Cell], List[Pose]]:
    """A list of (cell, pose) fine samples for FineLoader (reference C16)."""
    rng = np.random.default_rng(seed)
    cells, poses = [], []
    for i in range(length):
        cell, pose = make_synthetic_fine_cell_and_pose(
            rng, num_mentioned=num_mentioned, pad_size=pad_size,
            num_distractors=num_distractors, describe_by=describe_by,
            cell_idx=i)
        cells.append(cell)
        poses.append(pose)
    return cells, poses
