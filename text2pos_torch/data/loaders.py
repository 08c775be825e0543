"""Host-side batch builders for training and evaluation: a copy of
``text2pos_tpu/data/loaders.py``.

Iterators that emit dense numpy batches from the same ``numpy`` random
streams as the JAX package's, so both packages build the same batches from
the same seed. Augmentations that touch *text* or *object identity* (hint
shuffling, horizontal/vertical flips) happen here; geometric point
augmentations (resampling, rotation, normalize-scale) happen on the device
(``text2pos_torch.ops.transforms``) inside the training step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from text2pos_torch.data.dense import (
    ObjectArrays,
    build_cell_bank,
    encode_objects,
    flatten_object_batch,
)
from text2pos_torch.data.hints import Vocabulary, create_hint_description, flip_text
from text2pos_torch.data.structs import Cell, Pose


def _flip_arrays(arrs: ObjectArrays, axis: int) -> ObjectArrays:
    """Flip object geometry along x (axis=0) or y (axis=1): v → 1 − v."""
    xyz = arrs.points_xyz.copy()
    xyz[..., axis] = 1.0 - xyz[..., axis]
    centers = arrs.centers.copy()
    centers[:, axis] = 1.0 - centers[:, axis]
    # Only the stored (valid) points are meaningful; flipped padding is fine.
    return ObjectArrays(
        points_xyz=xyz, points_rgb=arrs.points_rgb,
        point_count=arrs.point_count, centers=centers, colors=arrs.colors,
        class_idx=arrs.class_idx, color_idx=arrs.color_idx, mask=arrs.mask,
    )


class CoarseLoader:
    """Batches for the coarse retrieval stage.

    One item per pose: the pose's best cell (optionally a close-by cell),
    joined hint text with optional shuffle + flip augmentation, and the
    cell's flat-packed object arrays (the reference's cells.py:36-110).
    """

    def __init__(self, cells: Sequence[Cell], poses: Sequence[Pose],
                 vocab: Vocabulary, batch_size: int, max_objects: int,
                 points_per_object: int, max_text_len: int,
                 shuffle_hints: bool = False, flip_poses: bool = False,
                 sample_close_cell: bool = False,
                 flat_cap: Optional[int] = None, seed: int = 0):
        self.bank = build_cell_bank(cells, max_objects, points_per_object, seed)
        self.id2idx = self.bank.id_to_index()
        self.poses = list(poses)
        self.vocab = vocab
        self.batch_size = batch_size
        self.max_text_len = max_text_len
        self.shuffle_hints = shuffle_hints
        self.flip_poses = flip_poses
        self.sample_close_cell = sample_close_cell
        self.flat_cap = flat_cap or batch_size * max_objects
        self.hints = [create_hint_description(p) for p in self.poses]
        self.pose_cell_idx = np.array(
            [self.id2idx[p.cell_id] for p in self.poses], np.int32
        )
        # For --sample_close_cell: any cell whose center is within
        # cell_size/2 of the pose may substitute the best cell
        # (reference cells.py:69-74).
        self.cell_centers_xy = 0.5 * (
            self.bank.bbox_w[:, 0:2] + self.bank.bbox_w[:, 3:5])

    def __len__(self) -> int:
        return len(self.poses)

    def num_batches(self, drop_last: bool) -> int:
        n = len(self.poses) // self.batch_size
        if not drop_last and len(self.poses) % self.batch_size:
            n += 1
        return n

    def _cell_arrays(self, cell_index: int) -> ObjectArrays:
        b = self.bank
        return ObjectArrays(
            points_xyz=b.points_xyz[cell_index], points_rgb=b.points_rgb[cell_index],
            point_count=b.point_count[cell_index], centers=b.centers[cell_index],
            colors=b.colors[cell_index], class_idx=b.class_idx[cell_index],
            color_idx=b.color_idx[cell_index], mask=b.mask[cell_index],
        )

    def epoch(self, seed: int, shuffle: bool = True, drop_last: bool = True
              ) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(seed)
        order = np.arange(len(self.poses))
        if shuffle:
            rng.shuffle(order)
        B = self.batch_size
        nb = self.num_batches(drop_last)
        for bi in range(nb):
            idx = order[bi * B : (bi + 1) * B]
            real = len(idx)
            if real < B:  # pad the tail batch by repetition
                idx = np.concatenate([idx, order[: B - real]])
            yield self._make_batch(idx, real, rng)

    def _make_batch(self, pose_idx: np.ndarray, real: int,
                    rng: np.random.Generator) -> Dict[str, np.ndarray]:
        """Each pose's draws from ``rng``, in the JAX package's order (its
        hint order, its close-by cell, its x and its y flip), then the
        batch ``batch_with`` builds from them."""
        orders: List[np.ndarray] = []
        cell_idx = self.pose_cell_idx[pose_idx].astype(np.int64)
        flips = np.zeros((len(pose_idx), 2), bool)
        for b, pi in enumerate(pose_idx):
            order = np.arange(len(self.hints[pi]))
            if self.shuffle_hints:
                rng.shuffle(order)  # the permutation a shuffled list takes
            orders.append(order)
            if self.sample_close_cell:
                cell_size = float(self.bank.cell_size[cell_idx[b]])
                dists = np.linalg.norm(
                    self.cell_centers_xy - self.poses[pi].pose_w[0:2], axis=1)
                close = np.flatnonzero(dists <= cell_size / 2)
                if len(close) > 0:
                    cell_idx[b] = int(rng.choice(close))
            if self.flip_poses:
                flips[b] = rng.choice((True, False)), rng.choice((True, False))
        return self.batch_with(pose_idx, orders, flips, cell_idx, real)

    def batch_with(self, pose_idx: np.ndarray, hint_orders: Sequence,
                   flips: np.ndarray, cell_idx: Optional[np.ndarray] = None,
                   real: Optional[int] = None) -> Dict[str, np.ndarray]:
        """The batch of ``pose_idx`` for given draws: pose b's hints in the
        order ``hint_orders[b]``, its cell ``cell_idx[b]`` (default its
        best cell), flipped along x and y where ``flips[b]`` says so; the
        first ``real`` poses (default all) are real. ``_make_batch`` builds
        every batch through here, and the device-side assembly of
        ``train/fused_coarse.py`` is held against it."""
        if cell_idx is None:
            cell_idx = self.pose_cell_idx[pose_idx]
        texts: List[str] = []
        per_cell: List[ObjectArrays] = []
        for pi, order, ci, (fx, fy) in zip(pose_idx, hint_orders, cell_idx,
                                           flips):
            text = " ".join(self.hints[pi][h] for h in order)
            arrs = self._cell_arrays(int(ci))
            if fx:
                arrs = _flip_arrays(arrs, 0)
                text = flip_text(text, 1)
            if fy:
                arrs = _flip_arrays(arrs, 1)
                text = flip_text(text, -1)
            texts.append(text)
            per_cell.append(arrs)
        tokens, lengths = self.vocab.encode_batch(texts, self.max_text_len)
        batch = flatten_object_batch(per_cell, self.flat_cap)
        batch.update(tokens=tokens, lengths=lengths,
                     num_real=np.int32(len(pose_idx) if real is None
                                       else real),
                     pose_idx=np.asarray(pose_idx, np.int32))
        return batch

    def all_query_tokens(self) -> Tuple[np.ndarray, np.ndarray]:
        """Tokens for every pose's un-augmented joined text (eval side)."""
        texts = [" ".join(h) for h in self.hints]
        return self.vocab.encode_batch(texts, self.max_text_len)


@dataclass
class FineSample:
    """Dense fine-stage supervision for one pose (reference poses.py:32-174)."""

    objects: ObjectArrays          # pad_size slots, all "valid" (incl. pad objects)
    hint_tokens: np.ndarray        # [H, T]
    hint_lengths: np.ndarray       # [H]
    gt_obj_for_hint: np.ndarray    # [H] object index or −1 (unmatched)
    all_matches: np.ndarray        # [L, 2] incl. dustbin rows
    all_matches_count: int
    offsets: np.ndarray            # [H, 2] regression targets
    offsets_best_center: np.ndarray
    pose_in_cell: np.ndarray       # [3]
    pose_w: np.ndarray             # [3]


class FineLoader:
    """Batches for the fine matching stage (reference poses.py:177-286)."""

    def __init__(self, cells: Sequence[Cell], poses: Sequence[Pose],
                 vocab: Vocabulary, batch_size: int, pad_size: int,
                 num_mentioned: int, points_per_object: int, max_hint_len: int,
                 regressor_cell: str = "pose", regressor_learn: str = "center",
                 seed: int = 0):
        self.cells_dict = {c.id: c for c in cells}
        self.poses = list(poses)
        self.vocab = vocab
        self.batch_size = batch_size
        self.pad_size = pad_size
        self.num_mentioned = num_mentioned
        self.points_per_object = points_per_object
        self.max_hint_len = max_hint_len
        self.regressor_cell = regressor_cell
        self.regressor_learn = regressor_learn
        self.hints = [create_hint_description(p) for p in self.poses]
        self.seed = seed

    def __len__(self) -> int:
        return len(self.poses)

    def num_batches(self, drop_last: bool) -> int:
        n = len(self.poses) // self.batch_size
        if not drop_last and len(self.poses) % self.batch_size:
            n += 1
        return n

    def _gather_offsets(self, descriptions) -> np.ndarray:
        """Offset targets by (regressor_cell, regressor_learn)
        (reference poses.py:48-70)."""
        offsets = []
        for d in descriptions:
            if self.regressor_cell == "best" and d.is_matched:
                off = (d.best_offset_closest if self.regressor_learn == "closest"
                       else d.best_offset_center)
            else:
                off = (d.offset_closest if self.regressor_learn == "closest"
                       else d.offset_center)
            offsets.append(np.asarray(off)[0:2])
        return np.array(offsets, np.float32)

    def make_sample(self, pose_idx: int, rng: np.random.Generator) -> FineSample:
        pose = self.poses[pose_idx]
        cell = self.cells_dict[pose.cell_id]
        hints = self.hints[pose_idx]
        descriptions = pose.descriptions
        assert len(descriptions) == self.num_mentioned

        cell_objects_dict = {o.id: o for o in cell.objects}
        matched_ids = [d.object_id for d in descriptions if d.is_matched]

        offsets = self._gather_offsets(descriptions)
        offsets_best_center = np.array(
            [
                (d.best_offset_center if d.is_matched else d.offset_center)[0:2]
                for d in descriptions
            ],
            np.float32,
        )

        # Matched objects first, then distractors (reference poses.py:83-104).
        objects = []
        matches = []  # (obj_idx, hint_idx)
        for i_descr, d in enumerate(descriptions):
            if d.is_matched:
                objects.append(cell_objects_dict[d.object_id])
                matches.append((len(objects) - 1, i_descr))
        for obj in cell.objects:
            if obj.id not in matched_ids:
                objects.append(obj)
        assert len(objects) == len(cell.objects)

        # Cut/pad to pad_size (poses.py:107-112). Matched objects sit first,
        # so cutting only ever drops distractors.
        objects = objects[: self.pad_size]
        from text2pos_torch.data.structs import Object3d

        while len(objects) < self.pad_size:
            objects.append(Object3d.create_padding(rng))

        # all_matches incl. dustbins (poses.py:114-139).
        all_matches = list(matches)
        for i_descr, d in enumerate(descriptions):
            if not d.is_matched:
                all_matches.append((len(objects), i_descr))        # objects-side bin
        for obj_idx, obj in enumerate(objects):
            if obj.id not in matched_ids:
                all_matches.append((obj_idx, len(descriptions)))   # hints-side bin

        H = self.num_mentioned
        L = self.pad_size + H
        am = np.zeros((L, 2), np.int32)
        count = len(all_matches)
        assert count <= L
        am[:count] = np.array(all_matches, np.int32)
        if count < L:
            am[count:] = am[0]  # repeat a valid pair; masked out by count

        gt_obj_for_hint = np.full(H, -1, np.int32)
        for obj_idx, hint_idx in matches:
            gt_obj_for_hint[hint_idx] = obj_idx

        arrs = encode_objects(objects, self.pad_size, self.points_per_object, rng)
        arrs.mask[:] = True  # padding objects are real model inputs

        hint_tokens, hint_lengths = self.vocab.encode_batch(hints, self.max_hint_len)

        return FineSample(
            objects=arrs,
            hint_tokens=hint_tokens,
            hint_lengths=hint_lengths,
            gt_obj_for_hint=gt_obj_for_hint,
            all_matches=am,
            all_matches_count=count,
            offsets=offsets,
            offsets_best_center=offsets_best_center,
            pose_in_cell=pose.pose.astype(np.float32),
            pose_w=pose.pose_w.astype(np.float32),
        )

    def epoch(self, seed: int, shuffle: bool = True, drop_last: bool = True
              ) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(seed)
        order = np.arange(len(self.poses))
        if shuffle:
            rng.shuffle(order)
        B = self.batch_size
        for bi in range(self.num_batches(drop_last)):
            idx = order[bi * B : (bi + 1) * B]
            real = len(idx)
            if real < B:
                idx = np.concatenate([idx, order[: B - real]])
            samples = [self.make_sample(int(i), rng) for i in idx]
            yield self._collate(samples, real, idx)

    def _collate(self, samples: List[FineSample], real: int,
                 pose_idx: np.ndarray) -> Dict[str, np.ndarray]:
        stack_obj = lambda attr: np.stack([getattr(s.objects, attr) for s in samples])
        return {
            "points_xyz": stack_obj("points_xyz"),
            "points_rgb": stack_obj("points_rgb"),
            "point_count": stack_obj("point_count"),
            "centers": stack_obj("centers"),
            "colors": stack_obj("colors"),
            "class_idx": stack_obj("class_idx"),
            "color_idx": stack_obj("color_idx"),
            "hint_tokens": np.stack([s.hint_tokens for s in samples]),
            "hint_lengths": np.stack([s.hint_lengths for s in samples]),
            "gt_obj_for_hint": np.stack([s.gt_obj_for_hint for s in samples]),
            "all_matches": np.stack([s.all_matches for s in samples]),
            "all_matches_count": np.array(
                [s.all_matches_count for s in samples], np.int32
            ),
            "offsets": np.stack([s.offsets for s in samples]),
            "offsets_best_center": np.stack(
                [s.offsets_best_center for s in samples]
            ),
            "pose_in_cell": np.stack([s.pose_in_cell for s in samples]),
            "pose_w": np.stack([s.pose_w for s in samples]),
            "num_real": np.int32(real),
            "pose_idx": pose_idx.astype(np.int32),
        }
