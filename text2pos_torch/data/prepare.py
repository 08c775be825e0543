"""KITTI360Pose dataset preparation, host-side and offline
(counterpart of ``text2pos_tpu/data/prepare.py``).

Rebuild of the Text2Pos reference code's
datapreparation/kitti360pose/prepare.py:
 - scene ingestion: ply files → per-instance objects, merged across files,
   voxel-downsampled per class, thresholded by per-class min points
   (prepare.py:86-152)
 - location sampling along the drive trajectories (prepare.py:189-213)
 - cell creation on a grid / shifted locations (prepare.py:216-307)
 - pose creation: random shift, nearest "best" cell, ego-centered pose-cell
   description, grounding to the best cell, dedup (prepare.py:310-427)
 - pickled outputs {out}/cells/{scene}.pkl, {out}/poses/{scene}.pkl with
   the same seed-4096 default (prepare.py:435,499-503)

Voxelling and the stuff objects' DBSCAN run in the port's C++ host library
(``data/native.py``), which is built at first use; a scene's cells and poses
equal JAX's on the same input. A cached ``objects_{scene}.pkl`` (either
package's) is read through the restricted unpickler of ``data/legacy.py``.

Run:  python -m text2pos_torch.data.prepare --scene_name ... --path_in ...
"""

from __future__ import annotations

import os
import os.path as osp
import pickle
import time
from typing import List, Tuple

import numpy as np

from text2pos_torch.config import PrepareConfig, parse_config
from text2pos_torch.constants import (
    CLASS_TO_LABEL,
    CLASS_TO_MINPOINTS,
    CLASS_TO_VOXELSIZE,
    STUFF_CLASSES,
)
from text2pos_torch.data.descriptions import (
    create_cell,
    describe_pose_in_pose_cell,
    ground_pose_to_best_cell,
)
from text2pos_torch.data.legacy import load_pickle
from text2pos_torch.data.ply import load_points
from text2pos_torch.data.structs import Cell, Object3d, Pose
from text2pos_torch.data.voxel import voxel_downsample_indices


def extract_objects(xyz, rgb, lbl, iid) -> List[Object3d]:
    """Split a file's points into per-(class, instance) objects
    (reference prepare.py:86-104). rgb is already scaled to [0,1]."""
    objects = []
    for label_name, label_idx in CLASS_TO_LABEL.items():
        mask = lbl == label_idx
        if not np.any(mask):
            continue
        label_xyz, label_rgb, label_iid = xyz[mask], rgb[mask], iid[mask]
        for obj_iid in np.unique(label_iid):
            m = label_iid == obj_iid
            objects.append(
                Object3d(int(obj_iid), int(obj_iid), label_xyz[m], label_rgb[m],
                         label_name)
            )
    return objects


def gather_objects(path_input: str, folder_name: str) -> List[Object3d]:
    """Load, merge, downsample and threshold a scene's objects
    (reference prepare.py:107-152)."""
    path = osp.join(path_input, "data_3d_semantics", folder_name, "static")
    assert osp.isdir(path), path
    file_names = [f for f in sorted(os.listdir(path)) if not f.startswith("._")]

    scene_objects = {}
    for file_name in file_names:
        xyz, rgb, lbl, iid = load_points(osp.join(path, file_name))
        for obj in extract_objects(xyz, rgb, lbl, iid):
            key = (obj.label, obj.id)
            if key in scene_objects:
                scene_objects[key] = Object3d.merge(scene_objects[key], obj)
            else:
                scene_objects[key] = obj
            voxel_size = CLASS_TO_VOXELSIZE[obj.label]
            if voxel_size is not None:
                indices = voxel_downsample_indices(
                    scene_objects[key].xyz, voxel_size)
                scene_objects[key].apply_downsampling(indices)

    objects_threshed = [
        obj for obj in scene_objects.values()
        if len(obj.xyz) >= CLASS_TO_MINPOINTS[obj.label]
    ]
    print(f"{folder_name}: {len(objects_threshed)} objects "
          f"({len(scene_objects) - len(objects_threshed)} below threshold)")
    return objects_threshed


def create_locations(path_input: str, folder_name: str,
                     location_distance: float) -> List[np.ndarray]:
    """Greedy ≥distance sampling along the trajectory (prepare.py:189-213)."""
    path = osp.join(path_input, "data_poses", folder_name, "poses.txt")
    poses = np.loadtxt(path)
    poses = poses[:, 1:].reshape((-1, 3, 4))[:, :, -1]
    sampled = [poses[0]]
    for pose in poses:
        dists = np.linalg.norm(pose - np.array(sampled), axis=1)
        if np.min(dists) >= location_distance:
            sampled.append(pose)
    print(f"{folder_name}: sampled {len(sampled)} locations")
    return sampled


def get_close_locations(locations, scene_objects: List[Object3d],
                        cell_size: float) -> List[np.ndarray]:
    """Keep locations within cell_size/2 of an instance object
    (prepare.py:155-186)."""
    instance_objects = [o for o in scene_objects if o.label not in STUFF_CLASSES]
    close = []
    for location in locations:
        for obj in instance_objects:
            closest = obj.get_closest_point(location)
            if np.linalg.norm(location - closest) < cell_size / 2:
                close.append(location)
                break
    assert len(close) > len(locations) * 2 / 5, (
        f"Too few locations retained ({len(close)} of {len(locations)}), "
        "are all objects loaded?"
    )
    print(f"close locations: {len(close)} of {len(locations)}")
    return close


def create_cells(objects, locations, scene_name: str, cfg: PrepareConfig
                 ) -> List[Cell]:
    """Grid / shifted cell placement (prepare.py:216-307)."""
    cells: List[Cell] = []
    locations = np.array(locations)
    scene_name_short = scene_name.split("_")[-2]
    cell_size = cfg.cell_size

    if cfg.shift_cells:
        shifts = np.array([
            [0, 0],
            [-cfg.cell_dist * 1.05, 0], [cfg.cell_dist * 1.05, 0],
            [0, -cfg.cell_dist * 1.05], [0, cfg.cell_dist * 1.05],
        ])
        shifts = np.tile(shifts.T, len(locations)).T
        locations = np.repeat(locations, 5, axis=0)
        locations[:, 0:2] += shifts
        cell_locations = np.ones_like(locations) * np.inf
    elif cfg.grid_cells:
        from scipy.spatial.distance import cdist

        x0, y0 = np.floor(np.min(locations[:, 0:2], axis=0)).astype(int)
        x1, y1 = np.floor(np.max(locations[:, 0:2], axis=0)).astype(int)
        step = int(cfg.cell_dist)
        grid = np.mgrid[x0:x1:step, y0:y1:step]
        centers = np.vstack((grid[0].flatten(), grid[1].flatten())).T
        distances = cdist(centers, locations[:, 0:2])
        keep = np.min(distances, axis=1) <= cell_size
        closest = np.argmin(distances, axis=1)[keep]
        centers = centers[keep]
        locations = np.hstack((centers, locations[closest, 2:3]))

    none_count = 0
    for i_location, location in enumerate(locations):
        if cfg.shift_cells:
            dists = np.linalg.norm(cell_locations - location, axis=1)
            if np.min(dists) < cfg.cell_dist:
                continue
        bbox = np.hstack((location - cell_size / 2, location + cell_size / 2))
        cell = create_cell(i_location, scene_name_short, bbox, objects,
                           num_mentioned=cfg.num_mentioned,
                           all_cells=cfg.all_cells)
        if cell is not None:
            cells.append(cell)
            if cfg.shift_cells:
                cell_locations[i_location] = location
        else:
            none_count += 1
    print(f"None cells: {none_count} / {len(locations)}")
    return cells


def create_poses(objects, locations, cells: List[Cell], cfg: PrepareConfig
                 ) -> List[Pose]:
    """Pose sampling + description + best-cell grounding (prepare.py:310-427)."""
    poses: List[Pose] = []
    cell_centers = np.array([c.bbox_w for c in cells])
    cell_centers = 0.5 * (cell_centers[:, 0:3] + cell_centers[:, 3:6])

    locations = np.array(locations, dtype=np.float64)
    if cfg.pose_count > 1:
        assert cfg.shift_poses, "pose_count > 1 requires shift_poses"
        locations = np.repeat(locations, cfg.pose_count, axis=0)

    unmatched_counts = []
    num_duplicates = 0
    num_none = 0
    for location in locations:
        location = location.copy()
        if cfg.shift_poses:
            location[0:2] += np.floor(
                np.random.rand(2) * cfg.cell_size / 2.1)

        dists = np.linalg.norm(location - cell_centers, axis=1)
        best_cell = cells[int(np.argmin(dists))]
        if np.min(dists) > cfg.cell_size / 2:
            num_none += 1
            continue

        pose_cell_bbox = np.hstack(
            (location - cfg.cell_size / 2, location + cfg.cell_size / 2))
        pose_cell = create_cell(-1, "pose", pose_cell_bbox, objects,
                                num_mentioned=cfg.num_mentioned)
        if pose_cell is None:
            num_none += 1
            continue

        if cfg.describe_by == "all":
            description_methods = ("closest", "class", "direction")
        else:
            description_methods = (cfg.describe_by,)

        mentioned_object_ids = []
        for method in description_methods:
            describe_cell = best_cell if cfg.describe_best_cell else pose_cell
            descriptions = describe_pose_in_pose_cell(
                location, describe_cell, method, cfg.num_mentioned,
                no_ontop=cfg.no_ontop)
            if descriptions is None or len(descriptions) < cfg.num_mentioned:
                num_none += 1
                break

            descriptions, pose_in_cell, num_unmatched = ground_pose_to_best_cell(
                location, descriptions, best_cell, all_cells=cfg.all_cells)
            unmatched_counts.append(num_unmatched)
            if cfg.describe_best_cell:
                assert num_unmatched == 0

            mentioned_ids = sorted(
                [d.object_id for d in descriptions if d.is_matched])
            if mentioned_ids in mentioned_object_ids:
                num_duplicates += 1
            else:
                poses.append(Pose(pose_in_cell, location, best_cell.id,
                                  best_cell.scene_name, descriptions,
                                  described_by=method))
                mentioned_object_ids.append(mentioned_ids)

    mean_unmatched = np.mean(unmatched_counts) if unmatched_counts else 0.0
    print(f"{len(poses)} poses, duplicates {num_duplicates}, "
          f"none {num_none}, avg unmatched {mean_unmatched:0.1f}")
    return poses


def prepare_scene(cfg: PrepareConfig) -> Tuple[List[Cell], List[Pose]]:
    np.random.seed(cfg.seed)  # reference prepare.py:435

    cell_locations = create_locations(cfg.path_in, cfg.scene_name,
                                      cfg.cell_dist)
    pose_locations = create_locations(cfg.path_in, cfg.scene_name,
                                      cfg.pose_dist)

    cache = osp.join(cfg.path_in, f"objects_{cfg.scene_name}.pkl")
    if osp.isfile(cache):
        objects = load_pickle(cache)
        print(f"loaded cached objects: {len(objects)}")
    else:
        objects = gather_objects(cfg.path_in, cfg.scene_name)
        with open(cache, "wb") as f:
            pickle.dump(objects, f)

    cell_locations = get_close_locations(cell_locations, objects, cfg.cell_size)
    pose_locations = get_close_locations(pose_locations, objects, cfg.cell_size)

    t0 = time.time()
    cells = create_cells(objects, cell_locations, cfg.scene_name, cfg)
    print(f"created {len(cells)} cells in {time.time()-t0:0.1f}s")

    t0 = time.time()
    poses = create_poses(objects, pose_locations, cells, cfg)
    print(f"created {len(poses)} poses in {time.time()-t0:0.1f}s")
    return cells, poses


def save_dataset(cells: List[Cell], poses: List[Pose], out_dir: str,
                 scene_name: str) -> None:
    os.makedirs(osp.join(out_dir, "cells"), exist_ok=True)
    os.makedirs(osp.join(out_dir, "poses"), exist_ok=True)
    with open(osp.join(out_dir, "cells", f"{scene_name}.pkl"), "wb") as f:
        pickle.dump(cells, f)
    with open(osp.join(out_dir, "poses", f"{scene_name}.pkl"), "wb") as f:
        pickle.dump(poses, f)


def main(argv=None) -> str:
    """``python -m text2pos_torch.data.prepare``: JAX's flags; writes
    ``{path_out}/{dirname}/{cells,poses}/{scene}.pkl`` and returns that
    directory."""
    cfg = parse_config(PrepareConfig, argv)
    cells, poses = prepare_scene(cfg)
    out_dir = osp.join(cfg.path_out, cfg.dirname)
    save_dataset(cells, poses, out_dir, cfg.scene_name)
    print(f"saved to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
