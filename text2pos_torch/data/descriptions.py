"""Cell construction, pose description and best-cell grounding (host side).

Behaviour mirrors the Text2Pos reference code, datapreparation/kitti360pose/descriptions.py:
 - create_cell:               descriptions.py:85-149
 - describe_pose_in_pose_cell descriptions.py:152-210
 - ground_pose_to_best_cell   descriptions.py:213-298

This is offline preparation code, so it stays NumPy; only its dense outputs
(see text2pos_torch.data.dense) touch the accelerator.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from text2pos_torch.constants import STUFF_CLASSES
from text2pos_torch.data.cluster import dbscan_labels
from text2pos_torch.data.select import (
    get_direction,
    get_direction_no_ontop,
    select_objects_class,
    select_objects_closest,
    select_objects_direction,
    select_objects_random,
)
from text2pos_torch.data.structs import (
    Cell,
    DescriptionBestCell,
    DescriptionPoseCell,
    Object3d,
)


def get_mask(points: np.ndarray, cell_bbox: np.ndarray) -> np.ndarray:
    """Boolean mask of points inside [x0,y0,z0,x1,y1,z1] (descriptions.py:26-37)."""
    return (
        (points[:, 0] >= cell_bbox[0])
        & (points[:, 1] >= cell_bbox[1])
        & (points[:, 2] >= cell_bbox[2])
        & (points[:, 0] <= cell_bbox[3])
        & (points[:, 1] <= cell_bbox[4])
        & (points[:, 2] <= cell_bbox[5])
    )


def cluster_stuff_object(obj: Object3d, stuff_min: int, eps: float = 0.75) -> List[Object3d]:
    """DBSCAN-cluster a stuff object, keep clusters ≥ stuff_min points
    (descriptions.py:40-54)."""
    labels = dbscan_labels(obj.xyz, eps=eps, min_samples=5)
    clustered = []
    if labels.size == 0:
        return clustered
    for label_value in range(0, int(np.max(labels)) + 1):
        mask = labels == label_value
        if np.sum(mask) < stuff_min:
            continue
        clustered.append(obj.mask_points(mask))
    return clustered


def create_cell(
    cell_idx: int,
    scene_name: str,
    bbox_w: np.ndarray,
    scene_objects: List[Object3d],
    num_mentioned: int = 6,
    inside_fraction: float = 1 / 3,
    stuff_min: int = 250,
    all_cells: bool = False,
) -> Optional[Cell]:
    """Crop scene objects into a cell and normalize to the unit cube.

    Stuff objects are masked to the bbox then DBSCAN-clustered; instance
    objects are kept whole if ≥ inside_fraction of their points fall inside.
    XYZ is normalized by the *largest* bbox edge so instance objects can
    exceed [0,1] slightly (descriptions.py:85-149).
    """
    bbox_w = np.asarray(bbox_w, dtype=np.float64)
    cell_objects: List[Object3d] = []
    for obj in scene_objects:
        assert obj.id < 1e7
        mask = get_mask(obj.xyz, bbox_w)
        if obj.label in STUFF_CLASSES:
            if np.sum(mask) < stuff_min:
                continue
            cell_obj = obj.mask_points(mask)
            cell_objects.extend(cluster_stuff_object(cell_obj, stuff_min))
        else:
            if np.sum(mask) / len(mask) < inside_fraction:
                continue
            cell_objects.append(obj.copy())

    cell_size = float(np.max(bbox_w[3:6] - bbox_w[0:3]))
    for obj in cell_objects:
        obj.xyz = (obj.xyz - bbox_w[0:3]) / cell_size

    if len(cell_objects) < num_mentioned and not all_cells:
        return None
    if len(cell_objects) < 1:
        return None

    for oid, obj in enumerate(cell_objects):
        obj.id = oid

    return Cell(cell_idx, scene_name, cell_objects, cell_size, bbox_w)


def create_synthetic_cell(bbox_w, area_objects: List[Object3d],
                          min_objects: int = 6) -> Optional[Cell]:
    """Synthetic cell: objects are taken as-is, no crop/normalization
    (descriptions.py:57-82)."""
    cell_objects = list(area_objects)
    bbox_w = np.asarray(bbox_w, dtype=np.float64)
    cell_size = float(np.max(bbox_w[3:6] - bbox_w[0:3]))
    if len(cell_objects) < min_objects:
        return None
    return Cell(-1, "mock", cell_objects, cell_size, bbox_w)


def describe_pose_in_pose_cell(
    pose_w: np.ndarray,
    cell: Cell,
    select_by: str,
    num_mentioned: int,
    max_dist: float = 0.5,
    no_ontop: bool = False,
) -> Optional[List[DescriptionPoseCell]]:
    """Select objects near the (cell-normalized) pose and describe it
    relative to each (descriptions.py:152-210)."""
    assert len(cell.objects) >= num_mentioned, (
        f"Only {len(cell.objects)} objects, expected at least {num_mentioned}"
    )

    pose = (np.asarray(pose_w) - cell.bbox_w[0:3]) / cell.cell_size
    assert np.all(pose >= 0) and np.all(pose <= 1.0), f"{pose} {pose_w} {cell.bbox_w}"

    dists = np.linalg.norm(
        [obj.get_closest_point(pose) - pose for obj in cell.objects], axis=1
    )
    candidates = [cell.objects[i] for i in range(len(dists)) if dists[i] <= max_dist]
    if len(candidates) < num_mentioned:
        return None

    if select_by == "closest":
        selected = select_objects_closest(candidates, pose, num_mentioned)
    elif select_by == "direction":
        selected = select_objects_direction(candidates, pose, num_mentioned)
    elif select_by == "class":
        selected = select_objects_class(candidates, pose, num_mentioned)
    elif select_by == "random":
        selected = select_objects_random(candidates, pose, num_mentioned)
    else:
        raise ValueError(f"Invalid selection method: {select_by}.")

    descriptions = []
    for obj in selected:
        direction = get_direction_no_ontop(obj, pose) if no_ontop else get_direction(obj, pose)
        closest_point = obj.get_closest_point(pose)
        descriptions.append(
            DescriptionPoseCell.from_object(
                obj, direction, pose - obj.get_center(), pose - closest_point, closest_point
            )
        )
    return descriptions


def ground_pose_to_best_cell(
    pose_w: np.ndarray,
    pose_cell_descriptions: List[DescriptionPoseCell],
    cell: Cell,
    all_cells: bool = False,
) -> Tuple[List[DescriptionBestCell], np.ndarray, int]:
    """Re-match pose-cell descriptions to objects of the best database cell.

    Candidates must share the instance_id and are chosen by
    closest-offset similarity with a √2/2 tolerance; objects cannot be
    matched twice (descriptions.py:213-298).
    """
    pose_w = np.asarray(pose_w)
    assert np.all(pose_w >= cell.bbox_w[0:3]) and np.all(pose_w <= cell.bbox_w[3:6]), (
        f"{pose_w}, {cell.bbox_w}"
    )
    if all_cells:
        assert len(cell.objects) >= 1
    else:
        assert len(cell.objects) >= len(pose_cell_descriptions)

    pose = (pose_w - cell.bbox_w[0:3]) / cell.cell_size
    assert np.all(pose >= 0) and np.all(pose <= 1.0)

    best_cell_descriptions: List[DescriptionBestCell] = []
    num_unmatched = 0
    matched_object_ids: List[int] = []

    for descr in pose_cell_descriptions:
        candidates = [
            obj
            for obj in cell.objects
            if obj.instance_id == descr.object_instance_id and obj.id not in matched_object_ids
        ]
        if len(candidates) == 0:
            best_cell_descriptions.append(DescriptionBestCell.from_unmatched(descr))
            num_unmatched += 1
            continue

        closest_offsets = np.array(
            [pose - cand.get_closest_point(pose) for cand in candidates]
        )[:, 0:2]
        best_idx = int(np.argmin(np.linalg.norm(closest_offsets - descr.offset_closest, axis=1)))
        best_obj = candidates[best_idx]
        best_closest_offset = closest_offsets[best_idx]

        if np.linalg.norm(descr.offset_closest - best_closest_offset) > np.sqrt(2) / 2:
            best_cell_descriptions.append(DescriptionBestCell.from_unmatched(descr))
            num_unmatched += 1
        else:
            matched_object_ids.append(best_obj.id)
            closest_point = best_obj.get_closest_point(pose)
            best_cell_descriptions.append(
                DescriptionBestCell.from_matched(
                    descr,
                    best_obj.id,
                    closest_point,
                    pose - best_obj.get_center(),
                    pose - closest_point,
                )
            )

    return best_cell_descriptions, pose, num_unmatched
