"""Dense tensor format: the bridge between host structs and the device.

The single most important architectural change vs the reference: instead of
Python object lists + ragged PyG batches with per-batch host↔device
round-trips, every cell becomes a fixed-shape record

    points_xyz [O, P, 3], points_rgb [O, P, 3], point_count [O],
    centers [O, 3], colors [O, 3], class_idx [O], color_idx [O], mask [O]

and every text a ``(token_ids [T], length)`` pair, produced once on the
host. Coarse encoding, retrieval, fine matching and accuracy computation
all consume these buffers inside jitted programs.

Class/color index conventions follow the reference encoders:
 - class_idx: 0 = <unk>, known classes at CLASS_TO_INDEX[label] + 1
   (reference object_encoder.py:32-34)
 - color_idx: first COLOR_NAMES index of the object's color text
   (reference cells.py:94)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from text2pos_torch.constants import CLASS_TO_INDEX, COLOR_NAMES
from text2pos_torch.data.structs import Cell, Object3d


def class_index(label: str) -> int:
    """Embedding index of a class label: 0 = unknown, else CLASS_TO_INDEX+1."""
    idx = CLASS_TO_INDEX.get(label)
    return 0 if idx is None else idx + 1


NUM_CLASS_INDICES = len(CLASS_TO_INDEX) + 1  # + <unk>
NUM_COLOR_INDICES = len(COLOR_NAMES) + 1


def color_index(color_text: str) -> int:
    try:
        return COLOR_NAMES.index(color_text)
    except ValueError:
        return 0


def sample_points(obj: Object3d, num: int, rng: np.random.Generator
                  ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Store up to ``num`` points; objects with fewer keep all + a count.

    The on-device FixedPoints op resamples ``pointnet_numpoints`` points
    with replacement from the first ``count`` entries.
    """
    n = len(obj.xyz)
    if n > num:
        idx = rng.choice(n, size=num, replace=False)
        return obj.xyz[idx].astype(np.float32), obj.rgb[idx].astype(np.float32), num
    xyz = np.zeros((num, 3), np.float32)
    rgb = np.zeros((num, 3), np.float32)
    xyz[:n] = obj.xyz
    rgb[:n] = obj.rgb
    return xyz, rgb, n


@dataclass
class ObjectArrays:
    """Dense arrays for a list of object slots (one cell or one pad group)."""

    points_xyz: np.ndarray   # [O, P, 3]
    points_rgb: np.ndarray   # [O, P, 3]
    point_count: np.ndarray  # [O]
    centers: np.ndarray      # [O, 3]
    colors: np.ndarray       # [O, 3]
    class_idx: np.ndarray    # [O]
    color_idx: np.ndarray    # [O]
    mask: np.ndarray         # [O] bool


def encode_objects(objects: Sequence[Object3d], max_objects: int,
                   points_per_object: int, rng: np.random.Generator
                   ) -> ObjectArrays:
    """Encode up to ``max_objects`` objects into dense arrays (cut + mask)."""
    O, P = max_objects, points_per_object
    out = ObjectArrays(
        points_xyz=np.zeros((O, P, 3), np.float32),
        points_rgb=np.zeros((O, P, 3), np.float32),
        point_count=np.ones(O, np.int32),
        centers=np.zeros((O, 3), np.float32),
        colors=np.zeros((O, 3), np.float32),
        class_idx=np.zeros(O, np.int32),
        color_idx=np.zeros(O, np.int32),
        mask=np.zeros(O, bool),
    )
    for i, obj in enumerate(objects[:O]):
        xyz, rgb, count = sample_points(obj, P, rng)
        out.points_xyz[i] = xyz
        out.points_rgb[i] = rgb
        out.point_count[i] = count
        out.centers[i] = obj.get_center()
        out.colors[i] = obj.get_color_rgb()
        out.class_idx[i] = class_index(obj.label)
        out.color_idx[i] = color_index(obj.get_color_text())
        out.mask[i] = True
    return out


@dataclass
class CellBank:
    """Dense database of cells, built once per dataset.

    Feeds coarse DB-side encoding and the fine stage's on-device gather of
    retrieved cells (no per-query host work, unlike reference
    evaluation/pipeline.py:190-202).
    """

    points_xyz: np.ndarray   # [C, O, P, 3]
    points_rgb: np.ndarray   # [C, O, P, 3]
    point_count: np.ndarray  # [C, O]
    centers: np.ndarray      # [C, O, 3]
    colors: np.ndarray       # [C, O, 3]
    class_idx: np.ndarray    # [C, O]
    color_idx: np.ndarray    # [C, O]
    mask: np.ndarray         # [C, O] bool
    bbox_w: np.ndarray       # [C, 6]
    cell_size: np.ndarray    # [C]
    cell_ids: List[str]
    scene_names: List[str]

    @property
    def num_cells(self) -> int:
        return self.points_xyz.shape[0]

    @property
    def max_objects(self) -> int:
        return self.points_xyz.shape[1]

    def id_to_index(self) -> Dict[str, int]:
        return {cid: i for i, cid in enumerate(self.cell_ids)}


def build_cell_bank(cells: Sequence[Cell], max_objects: int,
                    points_per_object: int, seed: int = 0) -> CellBank:
    rng = np.random.default_rng(seed)
    per_cell = [
        encode_objects(c.objects, max_objects, points_per_object, rng)
        for c in cells
    ]
    stack = lambda attr: np.stack([getattr(p, attr) for p in per_cell])
    return CellBank(
        points_xyz=stack("points_xyz"),
        points_rgb=stack("points_rgb"),
        point_count=stack("point_count"),
        centers=stack("centers"),
        colors=stack("colors"),
        class_idx=stack("class_idx"),
        color_idx=stack("color_idx"),
        mask=stack("mask"),
        bbox_w=np.stack([c.bbox_w for c in cells]).astype(np.float32),
        cell_size=np.array([c.cell_size for c in cells], np.float32),
        cell_ids=[c.id for c in cells],
        scene_names=[c.scene_name for c in cells],
    )


def pad_cell_objects(cell: Cell, pad_size: int,
                     rng: np.random.Generator) -> List[Object3d]:
    """Cut/pad a cell's object list to ``pad_size`` with padding objects
    (reference poses.py:107-112, eval.py:152-158)."""
    objects = list(cell.objects[:pad_size])
    while len(objects) < pad_size:
        objects.append(Object3d.create_padding(rng))
    return objects


def flatten_object_batch(per_cell: Sequence[ObjectArrays], flat_cap: int
                         ) -> Dict[str, np.ndarray]:
    """Pack valid objects of a batch of cells into flat fixed-cap buffers.

    Returns flat arrays plus (cell_idx, slot_idx) for scattering embeddings
    back into the dense [B, O, E] layout inside the model.
    """
    P = per_cell[0].points_xyz.shape[1]
    out = {
        "points_xyz": np.zeros((flat_cap, P, 3), np.float32),
        "points_rgb": np.zeros((flat_cap, P, 3), np.float32),
        "point_count": np.ones(flat_cap, np.int32),
        "centers": np.zeros((flat_cap, 3), np.float32),
        "colors": np.zeros((flat_cap, 3), np.float32),
        "class_idx": np.zeros(flat_cap, np.int32),
        "color_idx": np.zeros(flat_cap, np.int32),
        "flat_valid": np.zeros(flat_cap, bool),
        "cell_idx": np.zeros(flat_cap, np.int32),
        "slot_idx": np.zeros(flat_cap, np.int32),
    }
    f = 0
    for b, arrs in enumerate(per_cell):
        valid_slots = np.where(arrs.mask)[0]
        n = len(valid_slots)
        assert f + n <= flat_cap, (
            f"flat object buffer overflow: {f + n} > {flat_cap}; raise "
            f"flat_object_cap or coarse_max_objects"
        )
        sl = slice(f, f + n)
        out["points_xyz"][sl] = arrs.points_xyz[valid_slots]
        out["points_rgb"][sl] = arrs.points_rgb[valid_slots]
        out["point_count"][sl] = arrs.point_count[valid_slots]
        out["centers"][sl] = arrs.centers[valid_slots]
        out["colors"][sl] = arrs.colors[valid_slots]
        out["class_idx"][sl] = arrs.class_idx[valid_slots]
        out["color_idx"][sl] = arrs.color_idx[valid_slots]
        out["flat_valid"][sl] = True
        out["cell_idx"][sl] = b
        out["slot_idx"][sl] = valid_slots
        f += n
    return out


def flatten_bank_slice(bank: CellBank, indices: np.ndarray, flat_cap: int
                       ) -> Dict[str, np.ndarray]:
    """Flat-pack a slice of the cell bank (for DB-side coarse encoding)."""
    per_cell = [
        ObjectArrays(
            points_xyz=bank.points_xyz[i], points_rgb=bank.points_rgb[i],
            point_count=bank.point_count[i], centers=bank.centers[i],
            colors=bank.colors[i], class_idx=bank.class_idx[i],
            color_idx=bank.color_idx[i], mask=bank.mask[i],
        )
        for i in indices
    ]
    return flatten_object_batch(per_cell, flat_cap)
