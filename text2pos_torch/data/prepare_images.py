"""Visloc side-experiment preparation: database/query pose-image splits
(counterpart of ``text2pos_tpu/data/prepare_images.py``).

Rebuild of the Text2Pos reference code's
datapreparation/kitti360pose/prepare_images.py:
 - sample_poses (prepare_images.py:18): greedy ≥distance trajectory
   sampling with per-pose image association
 - create_poses_and_images (prepare_images.py:49): split sampled poses into
   a database set and an offset query set, recording image paths

The reference's pptk-based scene *rendering* (rendering.py) is interactive
and display-bound; it is intentionally not reproduced (a headless
environment) — this module covers the data-side capability so the visloc
evaluator (evaluation/visloc.py) has inputs.
"""

from __future__ import annotations

import os
import os.path as osp
import pickle
from typing import Dict, Tuple

import numpy as np


def load_trajectory(path_input: str, scene_name: str
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(frame_indices [N], positions [N, 3]) from poses.txt."""
    path = osp.join(path_input, "data_poses", scene_name, "poses.txt")
    raw = np.loadtxt(path)
    frames = raw[:, 0].astype(np.int64)
    positions = raw[:, 1:].reshape((-1, 3, 4))[:, :, -1]
    return frames, positions


def sample_poses(positions: np.ndarray, frames: np.ndarray,
                 min_distance: float) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy ≥min_distance sampling, keeping frame ids
    (reference prepare_images.py:18-46)."""
    keep = [0]
    for i in range(1, len(positions)):
        dists = np.linalg.norm(positions[i] - positions[keep], axis=1)
        if np.min(dists) >= min_distance:
            keep.append(i)
    keep = np.array(keep)
    return frames[keep], positions[keep]


def create_poses_and_images(path_input: str, scene_name: str,
                            db_distance: float = 10.0,
                            query_offset: float = 5.0,
                            camera: str = "image_00") -> Dict:
    """Build db/query splits: database poses every ``db_distance`` meters,
    queries offset between database poses (reference prepare_images.py:49+).

    Returns {"db": {frames, poses, images}, "query": {...}}. Image paths
    follow the KITTI360 2D layout and are recorded whether or not the files
    exist (the reference assumes a full KITTI360 download).
    """
    frames, positions = load_trajectory(path_input, scene_name)
    db_frames, db_poses = sample_poses(positions, frames, db_distance)

    # Query poses: midpoints of the trajectory between database samples.
    query_frames, query_poses = [], []
    db_set = set(db_frames.tolist())
    last_db_pos = None
    for f, p in zip(frames, positions):
        if f in db_set:
            last_db_pos = p
            continue
        if last_db_pos is not None and np.linalg.norm(p - last_db_pos) >= query_offset:
            query_frames.append(f)
            query_poses.append(p)
            last_db_pos = None
    query_frames = np.array(query_frames, np.int64)
    query_poses = (np.array(query_poses)
                   if query_poses else np.zeros((0, 3)))

    def image_paths(frame_ids):
        return [
            osp.join(path_input, "data_2d_raw", scene_name, camera,
                     "data_rect", f"{int(f):010d}.png")
            for f in frame_ids
        ]

    return {
        "db": {"frames": db_frames, "poses": db_poses,
               "images": image_paths(db_frames)},
        "query": {"frames": query_frames, "poses": query_poses,
                  "images": image_paths(query_frames)},
    }


def save_splits(splits: Dict, out_dir: str, scene_name: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(osp.join(out_dir, f"{scene_name}_visloc.pkl"), "wb") as f:
        pickle.dump(splits, f)


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--path_in", required=True)
    parser.add_argument("--path_out", required=True)
    parser.add_argument("--scene_name", required=True)
    parser.add_argument("--db_distance", type=float, default=10.0)
    parser.add_argument("--query_offset", type=float, default=5.0)
    args = parser.parse_args()
    splits = create_poses_and_images(args.path_in, args.scene_name,
                                     args.db_distance, args.query_offset)
    save_splits(splits, args.path_out, args.scene_name)
    print(f"db {len(splits['db']['frames'])} / "
          f"query {len(splits['query']['frames'])} poses")
