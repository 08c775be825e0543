"""Device-resident coarse training (counterpart of
``text2pos_tpu/train/fused_coarse.py``): the cell bank, every pose's hint
tokens and the direction-word swap tables live on the device, and a step
takes only a device tensor of pose indices and its draws. It gathers the
poses' cells, flips their geometry (v → 1 − v on the xy of points and
centres) and their text (east ↔ west, north ↔ south on token ids, the
string rewrite of ``data/hints.flip_text``), shuffles each pose's hints,
packs them into one sequence (hint h starts at the summed lengths of the
hints before it; padding parks in column T of a T+1 buffer, which is cut
off), keeps the valid objects and runs the contrastive update of
``CoarseTrainer``. A step makes no host copy, no ``.item()`` and no
synchronization: the number of valid objects, a shape, comes with the pose
indices from the host, which knows the bank's mask and the epoch's order;
the valid rows are found by a cumulative sum and a scatter on the device.

``--neg_bank`` adds the global-negative memory bank: the eval-mode
embeddings of every training cell (``refresh_neg_bank``: the PointConv
kernel, chunks of ``batch_size`` cells, each on the same fixed draws), and
a hinge of each anchor against its ``neg_bank_hardest`` hardest bank cells,
leaving out its own cell and the same scene's cells whose centre lies
within one cell size of the pose. It weighs ``neg_bank_weight`` from the
epoch after ``neg_bank_warmup`` (0 before), refreshed at the start of each
such epoch and every ``num_segs // neg_bank_refresh`` segments.

Draws: JAX draws inside its step; here a step takes them as arguments
(``draws``: ``flips`` [B, 2] bool, ``perm`` [B, H] hint order, ``idx`` [B,
O, P] point-sample indices, ``angles`` [B, O] degrees, or the prepared
``points`` of the valid objects) or from a ``torch.Generator`` on the
device, in that order; in an epoch, each step's from a generator seeded by
(seed, epoch, segment). The epoch's order, its segments of
``T2P_FUSED_SEG`` steps (default 128; 0 or fewer than that many steps, one
segment) and the refresh points are numpy and JAX's exactly
(``epoch_plan``); the loss is read once a segment (``run_segments``).
"""

from __future__ import annotations

import math
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from text2pos_torch.config import TrainConfig
from text2pos_torch.data.dense import build_cell_bank
from text2pos_torch.data.hints import Vocabulary, create_hint_description
from text2pos_torch.device import on_device
from text2pos_torch.ops.transforms import (prepare_object_points,
                                           sample_indices)
from text2pos_torch.train.coarse import CoarseTrainer, step_generator
from text2pos_torch.train.state import TrainState

_SWAPS = {1: (("east", "west"),), -1: (("north", "south"),)}
BANK_KEYS = ("points_xyz", "points_rgb", "point_count", "centers", "colors",
             "mask", "class_idx", "color_idx")


def build_token_swap(vocab: Vocabulary, direction: int) -> np.ndarray:
    """Identity permutation over the vocab except the direction pair."""
    table = np.arange(vocab.size, dtype=np.int32)
    for a, b in _SWAPS[direction]:
        ia, ib = vocab.word_to_index.get(a), vocab.word_to_index.get(b)
        if ia is not None and ib is not None:
            table[ia], table[ib] = ib, ia
    return table


def epoch_plan(num_poses: int, batch_size: int, seed: int, epoch: int,
               refresh: int = 0
               ) -> Tuple[np.ndarray, List[Tuple[int, int]], List[int]]:
    """(step_idx [steps, B] pose indices, the segments' (first, end) steps,
    the segments before which the bank is refreshed mid-epoch) of an epoch:
    ``default_rng(seed·10000 + epoch)``'s permutation, cut into segments of
    ``T2P_FUSED_SEG`` steps, and with ``refresh`` (the bank's refreshes an
    epoch when it is active, else 0) every ``num_segs // refresh``-th
    segment but the first, as JAX's ``fused_train_epoch`` runs them."""
    steps = num_poses // batch_size
    order = np.random.default_rng(seed * 10_000 + epoch).permutation(
        num_poses)
    step_idx = order[: steps * batch_size].reshape(steps, batch_size)
    seg = int(os.environ.get("T2P_FUSED_SEG", "128"))
    if seg <= 0 or steps <= seg:
        return step_idx, [(0, steps)], []
    segs = [(s0, min(s0 + seg, steps)) for s0 in range(0, steps, seg)]
    every = max(1, len(segs) // max(refresh, 1)) if refresh else 0
    return step_idx, segs, [i for i in range(1, len(segs))
                            if every and i % every == 0]


def valid_rows(mask: torch.Tensor, num: int) -> torch.Tensor:
    """The flat indices [num] of the true entries of ``mask`` (any shape),
    in order, found without a synchronization: each true entry's rank by a
    cumulative sum, scattered into a buffer whose last slot takes the
    false ones. ``num`` must be their count."""
    flat = mask.reshape(-1)
    n = flat.numel()
    rank = torch.cumsum(flat.long(), 0) - 1
    slot = torch.where(flat, rank, torch.full_like(rank, n))
    rows = torch.full((n + 1,), n, dtype=torch.long, device=mask.device)
    rows.scatter_(0, slot, torch.arange(n, device=mask.device))
    return rows[:num]


def run_segments(device: torch.device, seed: int, epoch: int,
                 step_idx: np.ndarray, segs: List[Tuple[int, int]],
                 step: Callable[[int, torch.Tensor, torch.Generator],
                                torch.Tensor],
                 before: Optional[Callable[[int], None]] = None) -> float:
    """An epoch's segments, as both fused trainers run them: ``before(i)``
    ahead of segment i, then ``step(s, pose_idx [B] on the device,
    generator)`` for each of its steps s, the generator seeded by (seed,
    epoch, segment); the segment's loss read once. Returns the step-weighted
    mean loss."""
    verbose = os.environ.get("T2P_FUSED_VERBOSE") == "1"
    losses, seg_lengths = [], []
    for i, (s0, s1) in enumerate(segs):
        if before is not None:
            before(i)
        t0 = time.time()
        idx = torch.from_numpy(step_idx[s0:s1]).to(device)
        gen = step_generator(device, 7, seed, epoch, i)
        losses.append(float(torch.stack(
            [step(s, idx[s - s0], gen) for s in range(s0, s1)]).mean()))
        seg_lengths.append(s1 - s0)
        if verbose:
            print(f"    seg {i} steps {s0}..{s1} loss {losses[-1]:0.3f} "
                  f"({time.time() - t0:0.1f}s)", flush=True)
    return float(np.average(losses, weights=seg_lengths))


class FusedCoarseTrainer(CoarseTrainer):
    """CoarseTrainer whose training batches are assembled on the device."""

    def __init__(self, cfg: TrainConfig, vocab: Vocabulary, cells, poses,
                 seed: int = 0, device=None):
        super().__init__(cfg, vocab, device)
        self.bank = build_cell_bank(cells, cfg.coarse_max_objects,
                                    cfg.pointnet_numpoints, seed)
        id2idx = self.bank.id_to_index()
        self.pose_cell_idx = np.array([id2idx[p.cell_id] for p in poses],
                                      np.int64)
        self.num_poses = len(poses)

        H, Th = cfg.num_mentioned, cfg.max_hint_len
        hint_tokens = np.zeros((len(poses), H, Th), np.int64)
        hint_lengths = np.zeros((len(poses), H), np.int64)
        for i, p in enumerate(poses):
            tk, ln = vocab.encode_batch(create_hint_description(p)[:H], Th)
            hint_tokens[i, : len(tk)] = tk
            hint_lengths[i, : len(ln)] = ln

        to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device)
        b = self.bank
        self.dev: Dict[str, torch.Tensor] = {
            k: to_dev(getattr(b, k)) for k in BANK_KEYS}
        self.dev.update(
            hint_tokens=to_dev(hint_tokens), hint_lengths=to_dev(hint_lengths),
            pose_cell_idx=to_dev(self.pose_cell_idx),
            swap_h=to_dev(build_token_swap(vocab, 1).astype(np.int64)),
            swap_v=to_dev(build_token_swap(vocab, -1).astype(np.int64)))
        self.neg_weight = 0.0
        if cfg.neg_bank:
            scene_ids = {s: i for i, s in
                         enumerate(dict.fromkeys(b.scene_names))}
            centers_w = 0.5 * (b.bbox_w[:, 0:2] + b.bbox_w[:, 3:5])
            self.dev.update(
                neg_bank=torch.zeros(b.num_cells, cfg.embed_dim,
                                     device=self.device),
                cell_scene=to_dev(np.array([scene_ids[s] for s in
                                            b.scene_names], np.int64)),
                cell_center_w=to_dev(centers_w.astype(np.float32)),
                cell_size_w=to_dev(b.cell_size.astype(np.float32)),
                pose_w=to_dev(np.array([p.pose_w[:2] for p in poses],
                                       np.float32)))

    def num_objects(self, pose_idx: np.ndarray) -> int:
        """The valid objects of the poses' cells (host arrays)."""
        return int(self.bank.mask[self.pose_cell_idx[pose_idx]].sum())

    # ------------------------------------------------------------------
    # Batch assembly
    # ------------------------------------------------------------------
    def _assemble_text(self, tokens: torch.Tensor, lengths: torch.Tensor,
                       flip_h: torch.Tensor, flip_v: torch.Tensor,
                       perm: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens [B, H, Th], lengths [B, H]: direction words swapped by
        the flips, hints in the order ``perm`` [B, H], packed into one
        sequence [B, T] (no interior padding) and its length [B]."""
        dev = self.dev
        B, H, Th = tokens.shape
        T = self.cfg.max_text_len
        tok = torch.where(flip_h[:, None, None], dev["swap_h"][tokens],
                          tokens)
        tok = torch.where(flip_v[:, None, None], dev["swap_v"][tok], tok)
        tok = torch.gather(tok, 1, perm[:, :, None].expand(B, H, Th))
        lens = torch.gather(lengths, 1, perm)
        offsets = torch.cumsum(lens, 1) - lens                     # [B, H]
        col = torch.arange(Th, device=tok.device)
        valid = col[None, None, :] < lens[:, :, None]
        # Padding, and tokens past T (JAX's scatter drops them), park in
        # column T, cut off below.
        pos = (offsets[:, :, None] + col).clamp_max(T)
        pos = torch.where(valid, pos, torch.full_like(pos, T))
        rows = torch.arange(B, device=tok.device)[:, None, None].expand_as(pos)
        joined = torch.zeros(B, T + 1, dtype=tok.dtype, device=tok.device)
        joined.index_put_((rows, pos), torch.where(valid, tok,
                                                   torch.zeros_like(tok)),
                          accumulate=True)
        return joined[:, :T], lens.sum(1).clamp_max(T)

    def draw(self, B: int, counts: torch.Tensor,
             generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        """A step's draws from ``generator``: flips, hint order, sample
        indices over counts [B, O] and rotation angles."""
        dev = counts.device
        H, P = self.cfg.num_mentioned, self.cfg.pointnet_numpoints
        flips = torch.rand(B, 2, generator=generator, device=dev) < 0.5
        perm = torch.argsort(torch.rand(B, H, generator=generator,
                                        device=dev), dim=1, stable=True)
        idx = sample_indices(counts, P, self.dev["points_xyz"].shape[2],
                             generator)
        angles = torch.rand(counts.shape, generator=generator,
                            device=dev) * 240.0 - 120.0
        return {"flips": flips, "perm": perm, "idx": idx, "angles": angles}

    def assemble(self, pose_idx: torch.Tensor, num_objects: int,
                 draws: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The step's inputs from pose indices [B] (device) and its draws:
        ``tokens``, ``lengths``, and the valid objects in the host loader's
        flat order: flipped ``points_xyz``, ``points_rgb``,
        ``point_count``, flipped ``centers``, ``colors``, ``cell_idx``,
        ``slot_idx``, ``idx`` and ``angles`` ([F, ...])."""
        dev = self.dev
        B, O = pose_idx.shape[0], self.cfg.coarse_max_objects
        cell_idx = dev["pose_cell_idx"][pose_idx]
        fxy = draws["flips"].to(torch.bool)
        sign = torch.where(fxy, -1.0, 1.0)
        off = torch.where(fxy, 1.0, 0.0)
        xyz = dev["points_xyz"][cell_idx]
        xyz = torch.cat([off[:, None, None, :] + sign[:, None, None, :]
                         * xyz[..., :2], xyz[..., 2:]], -1)
        ctr = dev["centers"][cell_idx]
        ctr = torch.cat([off[:, None, :] + sign[:, None, :] * ctr[..., :2],
                         ctr[..., 2:]], -1)
        tokens, lengths = self._assemble_text(
            dev["hint_tokens"][pose_idx], dev["hint_lengths"][pose_idx],
            fxy[:, 0], fxy[:, 1], draws["perm"])
        rows = valid_rows(dev["mask"][cell_idx], num_objects)
        flat = lambda t: t.reshape((B * O,) + t.shape[2:])[rows]
        out = {"tokens": tokens, "lengths": lengths,
               "points_xyz": flat(xyz),
               "points_rgb": flat(dev["points_rgb"][cell_idx]),
               "point_count": flat(dev["point_count"][cell_idx]),
               "centers": flat(ctr), "colors": flat(dev["colors"][cell_idx]),
               "cell_idx": rows // O, "slot_idx": rows % O,
               "class_idx": flat(dev["class_idx"][cell_idx]),
               "color_idx": flat(dev["color_idx"][cell_idx])}
        for k in ("idx", "angles"):
            if k in draws:
                out[k] = flat(draws[k])
        return out

    # ------------------------------------------------------------------
    # Steps
    # ------------------------------------------------------------------
    def fused_forward_loss(self, state: TrainState, pose_idx: torch.Tensor,
                           num_objects: Optional[int] = None,
                           generator: Optional[torch.Generator] = None,
                           draws: Optional[Dict] = None) -> torch.Tensor:
        """The fused step's forward pass in train mode from pose indices
        [B] on the device: the loss, with its graph. ``num_objects`` (the
        valid objects of the poses' cells) spares a synchronization;
        ``draws`` replace the generator's, each key on its own."""
        cfg = self.cfg
        B = pose_idx.shape[0]
        if num_objects is None:
            num_objects = self.num_objects(pose_idx.cpu().numpy())
        draws = dict(draws or {})
        if not {"flips", "perm"} <= set(draws) or not (
                "points" in draws or {"idx", "angles"} <= set(draws)):
            counts = self.dev["point_count"][
                self.dev["pose_cell_idx"][pose_idx]]
            draws = {**self.draw(B, counts, generator), **draws}
        d = {k: on_device(v, self.device) for k, v in draws.items()
             if k != "points"}
        a = self.assemble(pose_idx, num_objects, d)
        if "points" in draws:
            pts, cols = (on_device(p, self.device) for p in draws["points"])
        else:
            pts, cols = prepare_object_points(
                a["points_xyz"], a["points_rgb"], a["point_count"],
                cfg.pointnet_numpoints, augment=True,
                no_pc_augment=cfg.no_pc_augment, idx=a["idx"],
                angles=a["angles"])
        text, cells = state.model(
            a["tokens"], a["lengths"], pts, cols, a["centers"], a["colors"],
            a["cell_idx"], a["slot_idx"], B, cfg.coarse_max_objects,
            train=True, class_idx=a["class_idx"], color_idx=a["color_idx"])
        loss = self.loss(text, cells)
        if cfg.neg_bank:
            loss = loss + self.neg_weight * self._neg_bank_loss(
                pose_idx, self.dev["pose_cell_idx"][pose_idx], text, cells)
        return loss

    def fused_train_step(self, state: TrainState, pose_idx: torch.Tensor,
                         num_objects: Optional[int] = None,
                         generator: Optional[torch.Generator] = None,
                         draws: Optional[Dict] = None) -> torch.Tensor:
        """One contrastive update from pose indices alone; returns the loss
        (on the device, not synchronized)."""
        with record_function("train.forward"):
            loss = self.fused_forward_loss(state, pose_idx, num_objects,
                                           generator, draws)
        with record_function("train.backward"):
            loss.backward()
        with record_function("train.optimizer"):
            state.apply_gradients()
        return loss.detach()

    # ------------------------------------------------------------------
    # Global-negative memory bank
    # ------------------------------------------------------------------
    def _neg_bank_loss(self, pose_idx: torch.Tensor, cell_idx: torch.Tensor,
                       text: torch.Tensor, cells: torch.Tensor
                       ) -> torch.Tensor:
        """Sum over the M hardest bank cells of each anchor of
        max(0, margin − s⁺ + s⁻), mean over anchors. ``text`` and
        ``cells`` are the L2-normalized embeddings; bank cells that could
        describe the pose (its own, or the same scene's with the centre
        within one cell size of the pose, in f32) are out."""
        dev, cfg = self.dev, self.cfg
        s_pos = (text * cells).sum(-1)                                # [B]
        scores = text @ dev["neg_bank"].T                             # [B, C]
        pw = dev["pose_w"][pose_idx]
        d = torch.linalg.vector_norm(
            dev["cell_center_w"][None, :, :] - pw[:, None, :], dim=-1)
        same_scene = (dev["cell_scene"][None, :]
                      == dev["cell_scene"][cell_idx][:, None])
        close = d <= dev["cell_size_w"][None, :]
        own = (torch.arange(scores.shape[1], device=scores.device)[None, :]
               == cell_idx[:, None])
        scores = torch.where(own | (same_scene & close), -math.inf, scores)
        hard = torch.topk(scores, cfg.neg_bank_hardest, dim=1).values
        return torch.relu(cfg.margin - s_pos[:, None] + hard).sum(1).mean()

    @torch.no_grad()
    def _encode_cells_core(self, state: TrainState, idx: torch.Tensor,
                           num_objects: int,
                           generator: Optional[torch.Generator] = None,
                           u: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
        """Eval-mode cell embeddings [B, E] of bank cells ``idx`` [B]
        (device); the sampling's uniforms ``u`` [B, O, P] or from
        ``generator``."""
        cfg, dev = self.cfg, self.dev
        B, O = idx.shape[0], cfg.coarse_max_objects
        counts = dev["point_count"][idx]
        sample = sample_indices(counts, cfg.pointnet_numpoints,
                                dev["points_xyz"].shape[2], generator,
                                None if u is None else on_device(
                                    u, self.device))
        rows = valid_rows(dev["mask"][idx], num_objects)
        flat = lambda t: t.reshape((B * O,) + t.shape[2:])[rows]
        pts, cols = prepare_object_points(
            flat(dev["points_xyz"][idx]), flat(dev["points_rgb"][idx]),
            flat(counts), cfg.pointnet_numpoints, augment=False,
            no_pc_augment=cfg.no_pc_augment, idx=flat(sample))
        return state.model.encode_objects(
            pts, cols, flat(dev["centers"][idx]), flat(dev["colors"][idx]),
            rows // O, rows % O, B, O, flat(dev["class_idx"][idx]),
            flat(dev["color_idx"][idx]))

    def refresh_chunks(self) -> np.ndarray:
        """The refresh's chunks [n, B] of bank cells: ``arange(n·B) % C``."""
        C, B = self.bank.num_cells, self.cfg.batch_size
        n = -(-C // B)
        return (np.arange(n * B) % C).reshape(n, B)

    def refresh_neg_bank(self, state: TrainState,
                         u: Optional[torch.Tensor] = None) -> None:
        """Re-embed every training cell with the current parameters, in
        chunks of ``batch_size`` cells, each on the same draws (the
        uniforms ``u`` [B, O, P], or a generator seeded alike for every
        chunk, as JAX reuses one key)."""
        chunks = self.refresh_chunks()
        idx = torch.from_numpy(chunks).to(self.device)
        embs = [self._encode_cells_core(
            state, idx[k], int(self.bank.mask[chunks[k]].sum()),
            step_generator(self.device, 8), u)
            for k in range(len(chunks))]
        self.dev["neg_bank"] = torch.cat(embs)[: self.bank.num_cells].float()

    # ------------------------------------------------------------------
    def fused_train_epoch(self, state: TrainState, epoch: int
                          ) -> Tuple[TrainState, float]:
        """One epoch: the bank activated and refreshed as scheduled, the
        steps in segments (``epoch_plan``, ``run_segments``); returns the
        step-weighted mean loss, read once a segment."""
        cfg = self.cfg
        B = cfg.batch_size
        if self.num_poses // B == 0:
            return state, float("nan")
        bank_active = cfg.neg_bank and epoch > cfg.neg_bank_warmup
        if bank_active:
            self.refresh_neg_bank(state)
            self.neg_weight = float(cfg.neg_bank_weight)
        step_idx, segs, refresh_at = epoch_plan(
            self.num_poses, B, cfg.seed, epoch,
            cfg.neg_bank_refresh if bank_active else 0)

        def before(i):
            if i in refresh_at:
                self.refresh_neg_bank(state)
        return state, run_segments(
            self.device, cfg.seed, epoch, step_idx, segs,
            lambda s, idx, gen: self.fused_train_step(
                state, idx, self.num_objects(step_idx[s]), gen), before)
