"""Device-resident fine-stage training (counterpart of
``text2pos_tpu/train/fused_fine.py``). The fine supervision is static a
pose (the fine stage trains without cell augmentation), so every pose's
``FineSample`` is made once, with ``default_rng(seed)`` through
``FineLoader.make_sample`` and ``_collate``, and kept on the device; a step
gathers its batch there from a device tensor of pose indices and runs
``FineTrainer``'s loss (the rank-aware term included), with no host copy,
no ``.item()`` and no synchronization. Its draws (``idx`` [B, O, P],
``angles`` [B, O], or the prepared ``points``) are arguments or come from a
``torch.Generator``; the epoch's order and segments are
``fused_coarse.epoch_plan``'s, JAX's exactly, and the loss is read once a
segment (``fused_coarse.run_segments``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from text2pos_torch.config import TrainConfig
from text2pos_torch.data.hints import Vocabulary
from text2pos_torch.data.loaders import FineLoader
from text2pos_torch.train.fine import TENSOR_KEYS, FineTrainer
from text2pos_torch.train.fused_coarse import epoch_plan, run_segments
from text2pos_torch.train.state import TrainState


class FusedFineTrainer(FineTrainer):
    """FineTrainer whose training batches are gathered on the device."""

    def __init__(self, cfg: TrainConfig, vocab: Vocabulary, cells, poses,
                 seed: int = 0, device=None):
        super().__init__(cfg, vocab, device)
        self.loader = FineLoader(
            cells, poses, vocab, cfg.batch_size, cfg.pad_size,
            cfg.num_mentioned, cfg.pointnet_numpoints, cfg.max_hint_len,
            regressor_cell=cfg.regressor_cell,
            regressor_learn=cfg.regressor_learn, seed=seed)
        self.num_poses = len(poses)
        rng = np.random.default_rng(seed)
        samples = [self.loader.make_sample(i, rng) for i in range(len(poses))]
        collated = self.loader._collate(
            samples, len(samples), np.arange(len(samples), dtype=np.int32))
        self.dev = self.tensors(collated)

    def batch(self, pose_idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The poses' supervision, gathered on the device."""
        return {k: self.dev[k][pose_idx] for k in TENSOR_KEYS}

    def fused_train_step(self, state: TrainState, pose_idx: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         draws: Optional[Dict] = None) -> torch.Tensor:
        """One update from pose indices [B] on the device; returns the loss
        (on the device, not synchronized)."""
        loss, _, _, _, _ = self.forward_loss(state, self.batch(pose_idx),
                                             generator, draws)
        with record_function("train.backward"):
            loss.backward()
        with record_function("train.optimizer"):
            state.apply_gradients()
        return loss.detach()

    def fused_train_epoch(self, state: TrainState, epoch: int,
                          draws: Optional[List[Dict]] = None
                          ) -> Tuple[TrainState, float]:
        """One epoch in segments (``epoch_plan``, ``run_segments``), step
        s's draws ``draws[s]`` or from the segment's generator; returns the
        step-weighted mean loss, read once a segment."""
        cfg = self.cfg
        if self.num_poses // cfg.batch_size == 0:
            return state, float("nan")
        step_idx, segs, _ = epoch_plan(self.num_poses, cfg.batch_size,
                                       cfg.seed, epoch)
        return state, run_segments(
            self.device, cfg.seed, epoch, step_idx, segs,
            lambda s, idx, gen: self.fused_train_step(
                state, idx, gen, None if draws is None else draws[s]))
