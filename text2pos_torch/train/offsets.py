"""Standalone offset (direction) regressor training (counterpart of
``text2pos_tpu/train/offsets.py``): the MSE between each hint's predicted
unit direction and its normalized offset target; ``eval_step`` also
localizes each pose by the least-squares intersection of the rays from the
ground-truth objects along the predicted directions
(``get_pos_in_cell_intersect``, the ground truth as the oracle matcher).

    python -m text2pos_torch.train.offsets --dataset SYNTHETIC --epochs 4 \\
        --batch_size 32 --regressor_dim 128

takes ``text2pos_tpu.train.offsets``'s flags and runs on the card unless
``--device cpu`` is given (the LSTM kernel takes ``regressor_dim`` a
multiple of 32 up to 256).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from text2pos_torch.config import TrainConfig
from text2pos_torch.data.hints import Vocabulary
from text2pos_torch.data.loaders import FineLoader
from text2pos_torch.device import on_device, resolve_device
from text2pos_torch.models.matcher import get_pos_in_cell_intersect
from text2pos_torch.models.offsets import OffsetRegressor
from text2pos_torch.ops.lstm import check_kernel_width
from text2pos_torch.train.state import (TrainState, init_parameters,
                                        make_optimizer)

KEYS = ("hint_tokens", "hint_lengths", "offsets", "gt_obj_for_hint",
        "centers", "pose_in_cell")


def oracle_matches(gt_obj_for_hint: torch.Tensor, num_objects: int
                   ) -> torch.Tensor:
    """[B, O] matches0 from the ground truth [B, H] (object index or -1),
    as JAX's evaluation scatters it: each object sums (hint + 1) over the
    hints that name it, and takes that sum − 1 (-1 when none does); two
    hints on one object so point past both."""
    gt = gt_obj_for_hint.long()
    B, H = gt.shape
    valid = gt >= 0
    hint1 = torch.arange(1, H + 1, device=gt.device).expand(B, H)
    rows = torch.arange(B, device=gt.device)[:, None].expand(B, H)
    accum = torch.zeros(B, num_objects, dtype=torch.long, device=gt.device)
    accum.index_put_((rows, torch.where(valid, gt, 0)),
                     hint1 * valid, accumulate=True)
    return torch.where(accum > 0, accum - 1, -1)


class OffsetsTrainer:
    def __init__(self, cfg: TrainConfig, vocab: Vocabulary, device=None):
        self.cfg = cfg
        self.device = resolve_device(device or cfg.device)
        if self.device.type == "cuda":
            check_kernel_width(cfg.regressor_dim)
        self.model = OffsetRegressor(vocab.size, cfg.regressor_dim)

    def init_state(self, steps_per_epoch: int) -> TrainState:
        """Fresh weights (from ``cfg.seed``) and Adam decaying by
        ``lr_gamma`` an epoch."""
        cfg = self.cfg
        model = init_parameters(self.model, cfg.seed).to(self.device)
        return TrainState(model, make_optimizer(
            model, cfg.learning_rate, cfg.lr_gamma, steps_per_epoch))

    def tensors(self, batch: Dict) -> Dict[str, torch.Tensor]:
        return {k: on_device(batch[k], self.device) for k in KEYS}

    @staticmethod
    def normalized_targets(offsets: torch.Tensor) -> torch.Tensor:
        return offsets / torch.linalg.vector_norm(
            offsets, dim=-1, keepdim=True).clamp_min(1e-12)

    def forward_loss(self, state: TrainState, tb: Dict) -> torch.Tensor:
        pred = state.model(tb["hint_tokens"], tb["hint_lengths"])
        return ((pred - self.normalized_targets(tb["offsets"])) ** 2).mean()

    def train_step(self, state: TrainState, batch: Dict) -> torch.Tensor:
        """One Adam step; returns the loss (on the device)."""
        loss = self.forward_loss(state, self.tensors(batch))
        loss.backward()
        state.apply_gradients()
        return loss.detach()

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: Dict
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(direction MSE, mean intersection error against the true in-cell
        position) with the ground-truth matches as the oracle."""
        tb = self.tensors(batch)
        pred = state.model(tb["hint_tokens"], tb["hint_lengths"])
        mse = ((pred - self.normalized_targets(tb["offsets"])) ** 2).mean()
        matches0 = oracle_matches(tb["gt_obj_for_hint"],
                                  tb["centers"].shape[1])
        pos = get_pos_in_cell_intersect(tb["centers"][..., 0:2], matches0,
                                        pred)
        err = torch.linalg.vector_norm(
            pos - tb["pose_in_cell"][..., 0:2], dim=-1).mean()
        return mse, err


def train(cfg: TrainConfig, cells_train, poses_train, cells_val, poses_val,
          log=print) -> Tuple[TrainState, Dict]:
    from text2pos_torch.data.hints import (build_vocabulary,
                                           create_hint_description)

    vocab = Vocabulary(build_vocabulary(
        [create_hint_description(p) for p in poses_train]))

    def make_loader(cells, poses):
        return FineLoader(cells, poses, vocab, cfg.batch_size, cfg.pad_size,
                          cfg.num_mentioned, cfg.pointnet_numpoints,
                          cfg.max_hint_len,
                          regressor_cell=cfg.regressor_cell,
                          regressor_learn=cfg.regressor_learn)

    loader_train = make_loader(cells_train, poses_train)
    loader_val = make_loader(cells_val, poses_val)
    trainer = OffsetsTrainer(cfg, vocab)
    state = trainer.init_state(loader_train.num_batches(drop_last=True))

    history: Dict[str, List[float]] = {"loss": [], "val_mse": [],
                                       "val_err": []}
    for epoch in range(cfg.epochs):
        losses = [trainer.train_step(state, b)
                  for b in loader_train.epoch(seed=epoch)]
        val = [trainer.eval_step(state, b)
               for b in loader_val.epoch(seed=0, shuffle=False)]
        loss = float(np.mean([float(x) for x in losses]))
        mse = float(np.mean([float(m) for m, _ in val]))
        err = float(np.mean([float(e) for _, e in val]))
        history["loss"].append(loss)
        history["val_mse"].append(mse)
        history["val_err"].append(err)
        log(f"epoch {epoch} loss {loss:0.4f} val-mse {mse:0.4f} "
            f"val-err {err:0.3f}")
    return state, {"history": history, "vocab": vocab, "trainer": trainer}


def main(argv: Optional[List[str]] = None) -> None:
    from text2pos_torch.config import parse_config
    from text2pos_torch.utils.cli import load_split

    cfg = parse_config(TrainConfig, argv)
    cells_train, poses_train = load_split(cfg, "train")
    cells_val, poses_val = load_split(cfg, "val")
    train(cfg, cells_train, poses_train, cells_val, poses_val)


if __name__ == "__main__":
    main()
