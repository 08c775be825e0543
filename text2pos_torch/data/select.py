"""Object-selection strategies and direction naming for pose descriptions.

Behaviour mirrors the Text2Pos reference code, datapreparation/kitti360pose/select.py:13-95.
"""

from __future__ import annotations

from typing import List

import numpy as np

from text2pos_torch.data.structs import Object3d


def get_direction(obj: Object3d, pose: np.ndarray) -> str:
    """Direction word from closest object point to the pose (select.py:13-27).

    "on-top" when the planar offset is < 0.05 cell units; ties on the
    axis comparison resolve to the *last* matching branch, exactly like the
    reference's cascaded ifs.
    """
    closest_point = obj.get_closest_point(pose)
    obj2pose = pose - closest_point
    if np.linalg.norm(obj2pose[0:2]) < 0.05:
        return "on-top"
    direction = None
    if abs(obj2pose[0]) >= abs(obj2pose[1]) and obj2pose[0] >= 0:
        direction = "east"
    if abs(obj2pose[0]) >= abs(obj2pose[1]) and obj2pose[0] <= 0:
        direction = "west"
    if abs(obj2pose[0]) <= abs(obj2pose[1]) and obj2pose[1] >= 0:
        direction = "north"
    if abs(obj2pose[0]) <= abs(obj2pose[1]) and obj2pose[1] <= 0:
        direction = "south"
    return direction


def get_direction_no_ontop(obj: Object3d, pose: np.ndarray) -> str:
    """Direction from the object *center*, never "on-top" (select.py:30-40)."""
    obj2pose = pose[0:2] - obj.get_center()[0:2]
    direction = None
    if abs(obj2pose[0]) >= abs(obj2pose[1]) and obj2pose[0] >= 0:
        direction = "east"
    if abs(obj2pose[0]) >= abs(obj2pose[1]) and obj2pose[0] <= 0:
        direction = "west"
    if abs(obj2pose[0]) <= abs(obj2pose[1]) and obj2pose[1] >= 0:
        direction = "north"
    if abs(obj2pose[0]) <= abs(obj2pose[1]) and obj2pose[1] <= 0:
        direction = "south"
    return direction


def select_objects_closest(objects: List[Object3d], pose, num_mentioned: int) -> List[Object3d]:
    dists = np.linalg.norm([obj.get_closest_point(pose) - pose for obj in objects], axis=1)
    indices = np.argsort(dists)[0:num_mentioned]
    return [objects[i] for i in indices]


def _round_robin(bucket_indices: dict, num_mentioned: int) -> List[int]:
    keys = list(bucket_indices.keys())
    offset = 0
    out: List[int] = []
    while len(out) < num_mentioned:
        for key in keys:
            vals = bucket_indices[key]
            if len(vals) > offset:
                out.append(vals[offset])
        offset += 1
    return out[0:num_mentioned]


def select_objects_direction(objects: List[Object3d], pose, num_mentioned: int) -> List[Object3d]:
    """Round-robin over direction buckets (select.py:50-69)."""
    directions = [get_direction(obj, pose) for obj in objects]
    buckets = {d: [] for d in directions}
    for idx, d in enumerate(directions):
        buckets[d].append(idx)
    return [objects[i] for i in _round_robin(buckets, num_mentioned)]


def select_objects_class(objects: List[Object3d], pose, num_mentioned: int) -> List[Object3d]:
    """Round-robin over class buckets (select.py:72-90)."""
    buckets = {obj.label: [] for obj in objects}
    for idx, obj in enumerate(objects):
        buckets[obj.label].append(idx)
    return [objects[i] for i in _round_robin(buckets, num_mentioned)]


def select_objects_random(objects: List[Object3d], pose, num_mentioned: int,
                          rng: np.random.Generator = None) -> List[Object3d]:
    if rng is None:
        idx = np.random.choice(len(objects), size=num_mentioned, replace=False)
    else:
        idx = rng.choice(len(objects), size=num_mentioned, replace=False)
    return [objects[i] for i in idx]
