"""Loader for prepared KITTI360Pose pickles (counterpart of
``text2pos_tpu/data/legacy.py``).

Three kinds of pickle hold a prepared scene's ``cells/{scene}.pkl`` and
``poses/{scene}.pkl``: the reference's (its own
``datapreparation.kitti360pose.imports`` classes, and the older
``datapreparation.kitti360`` alias), the JAX package's
(``text2pos_tpu.data.structs``) and the port's. ``StructUnpickler`` reads
all three without importing either the reference or the JAX package: its
``find_class`` maps the JAX package's structs to the port's, the
reference's classes to attribute-bag shims (converted to the port's structs
afterwards), numpy's array machinery to numpy, and refuses every other
global. Nothing is installed into ``sys.modules``.
"""

from __future__ import annotations

import io
import os.path as osp
import pickle
from typing import Any, List, Tuple

import numpy as np

from text2pos_torch.data import structs
from text2pos_torch.data.structs import (
    Cell,
    DescriptionBestCell,
    Object3d,
    Pose,
)

_STRUCTS = ("Object3d", "Cell", "Pose", "DescriptionPoseCell",
            "DescriptionBestCell")
_PACKAGES = ("text2pos_tpu.data.structs", "text2pos_torch.data.structs")
# The reference's module paths, the legacy alias included (the reference's
# dataloading/__init__.py:8-10).
_REFERENCE = ("datapreparation.kitti360pose.imports",
              "datapreparation.kitti360.imports")
_NUMPY = {("numpy", "ndarray"), ("numpy", "dtype"),
          ("numpy.core.multiarray", "_reconstruct"),
          ("numpy._core.multiarray", "_reconstruct"),
          ("numpy.core.multiarray", "scalar"),
          ("numpy._core.multiarray", "scalar")}


class _Shim:
    """Attribute bag standing in for a reference class during unpickling."""

    def __setstate__(self, state):
        self.__dict__.update(state)


_SHIMS = {name: type(name, (_Shim,), {}) for name in _STRUCTS}


class StructUnpickler(pickle.Unpickler):
    """Restricted unpickler for prepared scenes: either package's data
    structs resolve to ``text2pos_torch.data.structs``, the reference's to
    shims, numpy arrays to numpy; any other global is refused."""

    def find_class(self, module: str, name: str):
        if module in _PACKAGES and name in _STRUCTS:
            return getattr(structs, name)
        if module in _REFERENCE and name in _STRUCTS:
            return _SHIMS[name]
        if (module, name) in _NUMPY:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"refusing to load {module}.{name} "
                                     "from a prepared-data pickle")


def load_pickle(path: str) -> Any:
    """The object pickled at ``path``, through ``StructUnpickler``."""
    with open(path, "rb") as f:
        return StructUnpickler(io.BytesIO(f.read())).load()


def _convert_object(o) -> Object3d:
    return Object3d(int(o.id), int(o.instance_id), np.asarray(o.xyz),
                    np.asarray(o.rgb), str(o.label))


def _convert_cell(c) -> Cell:
    idx = int(c.id.split("_")[-1])
    scene_short = c.id.split("_")[0]
    cell = Cell(idx, scene_short, [_convert_object(o) for o in c.objects],
                float(c.cell_size), np.asarray(c.bbox_w))
    assert cell.id == c.id, (cell.id, c.id)
    return cell


def _convert_description(d) -> DescriptionBestCell:
    def opt(name):
        v = getattr(d, name, None)
        return None if v is None else np.asarray(v)

    return DescriptionBestCell(
        object_instance_id=int(d.object_instance_id),
        object_label=str(d.object_label),
        object_color_rgb=np.asarray(d.object_color_rgb),
        object_color_text=str(d.object_color_text),
        direction=str(d.direction),
        offset_center=np.asarray(d.offset_center),
        offset_closest=np.asarray(d.offset_closest),
        closest_point=np.asarray(d.closest_point),
        is_matched=bool(d.is_matched),
        object_id=int(getattr(d, "object_id", -1)),
        best_offset_center=opt("best_offset_center"),
        best_offset_closest=opt("best_offset_closest"),
    )


def _convert_pose(p) -> Pose:
    return Pose(
        np.asarray(p.pose), np.asarray(p.pose_w), str(p.cell_id),
        str(getattr(p, "scene_name", p.cell_id.split("_")[0])),
        [_convert_description(d) for d in p.descriptions],
        described_by=getattr(p, "described_by", None),
    )


def load_reference_scene(base_path: str, scene_name: str
                         ) -> Tuple[List[Cell], List[Pose]]:
    """``{base}/cells/{scene}.pkl`` and ``{base}/poses/{scene}.pkl`` in the
    reference's format or either package's, as the port's structs."""
    raw_cells = load_pickle(osp.join(base_path, "cells", f"{scene_name}.pkl"))
    raw_poses = load_pickle(osp.join(base_path, "poses", f"{scene_name}.pkl"))
    if raw_cells and isinstance(raw_cells[0], Cell):
        return raw_cells, raw_poses
    return ([_convert_cell(c) for c in raw_cells],
            [_convert_pose(p) for p in raw_poses])


def load_scenes(base_path: str, scene_names: List[str]
                ) -> Tuple[List[Cell], List[Pose]]:
    """Several scenes concatenated (the reference's cells.py:113-152);
    cell ids must not repeat across them."""
    all_cells: List[Cell] = []
    all_poses: List[Pose] = []
    for scene in scene_names:
        cells, poses = load_reference_scene(base_path, scene)
        all_cells.extend(cells)
        all_poses.extend(poses)
    ids = [c.id for c in all_cells]
    assert len(np.unique(ids)) == len(ids), "cell ids repeat across scenes"
    return all_cells, all_poses
