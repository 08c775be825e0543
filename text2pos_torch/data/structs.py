"""Core host-side data model: objects, cells, poses, descriptions.

Behaviourally equivalent to the reference structs
(the Text2Pos reference code, datapreparation/kitti360pose/imports.py:8-247) but written
as plain numpy dataclasses. These exist only on the host — the accelerator
path consumes the dense tensor format produced by `text2pos_torch.data.dense`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from text2pos_torch.constants import COLORS, COLOR_NAMES, PAD_LABEL


class Object3d:
    """A single 3D object inside a scene or cell.

    ``id`` is unique only within one cell; ``instance_id`` is the original
    scene-level instance id (repeats across cells, and within a cell for
    clustered stuff objects). Reference imports.py:8-83.
    """

    __slots__ = ("id", "instance_id", "xyz", "rgb", "label")

    def __init__(self, id: int, instance_id: int, xyz: np.ndarray, rgb: np.ndarray, label: str):
        self.id = id
        self.instance_id = instance_id
        self.xyz = np.asarray(xyz, dtype=np.float64)
        self.rgb = np.asarray(rgb, dtype=np.float64)
        self.label = label

    # -- geometry ----------------------------------------------------------
    def get_center(self) -> np.ndarray:
        return np.mean(self.xyz, axis=0)

    def get_closest_point(self, anchor) -> np.ndarray:
        dists = np.linalg.norm(self.xyz - np.asarray(anchor), axis=1)
        return self.xyz[np.argmin(dists)]

    # -- color -------------------------------------------------------------
    def get_color_rgb(self) -> np.ndarray:
        return np.mean(self.rgb, axis=0)

    def get_color_text(self) -> str:
        """Name of the L2-closest of the 8 fixed color centers (imports.py:33-38)."""
        dists = np.linalg.norm(self.get_color_rgb() - COLORS, axis=1)
        return COLOR_NAMES[int(np.argmin(dists))]

    # -- editing -----------------------------------------------------------
    def apply_downsampling(self, indices) -> None:
        self.xyz = self.xyz[indices]
        self.rgb = self.rgb[indices]

    def mask_points(self, mask) -> "Object3d":
        assert len(mask) > 6  # guard against accidentally passing a bbox
        return Object3d(self.id, self.instance_id, self.xyz[mask], self.rgb[mask], self.label)

    def copy(self) -> "Object3d":
        return Object3d(self.id, self.instance_id, self.xyz.copy(), self.rgb.copy(), self.label)

    @classmethod
    def merge(cls, obj1: "Object3d", obj2: "Object3d") -> "Object3d":
        assert obj1.label == obj2.label and obj1.id == obj2.id
        return Object3d(
            obj1.id,
            obj1.instance_id,
            np.vstack((obj1.xyz, obj2.xyz)),
            np.vstack((obj1.rgb, obj2.rgb)),
            obj1.label,
        )

    @classmethod
    def create_padding(cls, rng: Optional[np.random.Generator] = None) -> "Object3d":
        """Padding object: 8 near-zero points, black, label "pad" (imports.py:75-83)."""
        rand = (rng.random((8, 3)) if rng is not None else np.random.rand(8, 3)) * 0.001
        return Object3d(-1, -1, rand, np.zeros((8, 3)), PAD_LABEL)

    def __repr__(self):
        return f"Object3d: {self.label}"


@dataclass
class DescriptionPoseCell:
    """One hint about a pose, expressed in the ego-centered "pose cell".

    Reference imports.py:86-115. Offsets are 2D (x, y) vectors from the
    object to the pose.
    """

    object_id: int
    object_instance_id: int
    object_label: str
    object_color_rgb: np.ndarray
    object_color_text: str
    direction: str
    offset_center: np.ndarray   # pose − object center, [2]
    offset_closest: np.ndarray  # pose − closest object point, [2]
    closest_point: np.ndarray   # [2], valid only in the pose cell

    @classmethod
    def from_object(cls, obj: Object3d, direction: str, offset_center, offset_closest,
                    closest_point) -> "DescriptionPoseCell":
        return cls(
            object_id=obj.id,
            object_instance_id=obj.instance_id,
            object_label=obj.label,
            object_color_rgb=obj.get_color_rgb(),
            object_color_text=obj.get_color_text(),
            direction=direction,
            offset_center=np.asarray(offset_center)[0:2],
            offset_closest=np.asarray(offset_closest)[0:2],
            closest_point=np.asarray(closest_point)[0:2],
        )

    def __repr__(self):
        return f"Pose is {self.direction} of a {self.object_color_text} {self.object_label}"


@dataclass
class DescriptionBestCell:
    """A hint re-grounded into the database cell nearest the pose.

    ``is_matched`` indicates whether the described object was re-identified
    in the best cell (imports.py:119-175). Unmatched hints map to the
    Sinkhorn dustbin during fine training.
    """

    object_instance_id: int
    object_label: str
    object_color_rgb: np.ndarray
    object_color_text: str
    direction: str
    offset_center: np.ndarray
    offset_closest: np.ndarray
    closest_point: np.ndarray
    is_matched: bool
    object_id: int = -1
    best_offset_center: Optional[np.ndarray] = None
    best_offset_closest: Optional[np.ndarray] = None

    @classmethod
    def from_matched(cls, descr: DescriptionPoseCell, object_id: int, best_closest_point,
                     best_offset_center, best_offset_closest) -> "DescriptionBestCell":
        return cls(
            object_instance_id=descr.object_instance_id,
            object_label=descr.object_label,
            object_color_rgb=descr.object_color_rgb,
            object_color_text=descr.object_color_text,
            direction=descr.direction,
            offset_center=descr.offset_center,
            offset_closest=descr.offset_closest,
            closest_point=np.asarray(best_closest_point)[0:2],
            is_matched=True,
            object_id=object_id,
            best_offset_center=np.asarray(best_offset_center)[0:2],
            best_offset_closest=np.asarray(best_offset_closest)[0:2],
        )

    @classmethod
    def from_unmatched(cls, descr: DescriptionPoseCell) -> "DescriptionBestCell":
        return cls(
            object_instance_id=descr.object_instance_id,
            object_label=descr.object_label,
            object_color_rgb=descr.object_color_rgb,
            object_color_text=descr.object_color_text,
            direction=descr.direction,
            offset_center=descr.offset_center,
            offset_closest=descr.offset_closest,
            closest_point=descr.closest_point,  # debug only
            is_matched=False,
        )

    def __repr__(self):
        mark = " (✓)" if self.is_matched else " (☓)"
        return f"Pose is {self.direction} of a {self.object_color_text} {self.object_label}" + mark


class Cell:
    """A map cell: cropped, [0,1]-normalized objects plus its world bbox.

    ``id`` format "XXXX_XXXXX" (scene short name + running index), total
    length 10 (imports.py:221-247).
    """

    __slots__ = ("scene_name", "id", "objects", "cell_size", "bbox_w")

    def __init__(self, idx: int, scene_name: str, objects: List[Object3d], cell_size: float,
                 bbox_w: np.ndarray):
        self.scene_name = scene_name
        self.id = f"{scene_name}_{idx:05.0f}"
        assert len(self.id) == 10, self.id
        self.objects = objects
        self.cell_size = float(cell_size)
        self.bbox_w = np.asarray(bbox_w, dtype=np.float64)

    def get_center(self) -> np.ndarray:
        return 0.5 * (self.bbox_w[0:3] + self.bbox_w[3:6])

    def __repr__(self):
        return f"Cell {self.id}: {len(self.objects)} objects"


class Pose:
    """A query pose with its best-cell grounding (imports.py:178-219)."""

    __slots__ = ("pose", "pose_w", "cell_id", "scene_name", "descriptions", "described_by")

    def __init__(self, pose_in_cell: np.ndarray, pose_w: np.ndarray, cell_id: str,
                 scene_name: str, descriptions: List[DescriptionBestCell],
                 described_by: Optional[str] = None):
        assert isinstance(descriptions[0], DescriptionBestCell)
        self.pose = np.asarray(pose_in_cell, dtype=np.float64)  # ∈ [0,1]³ in best cell
        self.pose_w = np.asarray(pose_w, dtype=np.float64)
        self.cell_id = cell_id
        self.scene_name = scene_name
        self.descriptions = descriptions
        self.described_by = described_by

    def get_text(self) -> str:
        return "".join(str(d) + ". " for d in self.descriptions)

    def get_number_unmatched(self) -> int:
        return sum(1 for d in self.descriptions if not d.is_matched)

    def __repr__(self):
        return f"Pose at {self.pose_w} in {self.cell_id}"
