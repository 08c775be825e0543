"""Training entry of the transformer matcher ablation (counterpart of
``text2pos_tpu/train/transformer.py``).

Trains ``models.transformer.TransformerMatch`` with the fine stage's
objective (the matching NLL + 5 · the MSE of the offsets, + 0.1 · the
class cross-entropy with the aux heads) on fine batches (``FineLoader``),
so the reference's negative-result baseline can be reproduced. A step
resamples and augments the points on the device, runs the model in train
mode (batch-statistics BN with running updates), the backward pass and one
Adam step (``train/state.py`` ``OptaxAdam``, decayed by ``lr_gamma`` an
epoch, as JAX's ``make_optimizer``), under the profiler ranges
``train.forward``, ``train.backward`` and ``train.optimizer``. The hint
encoder's LSTM, PointNet++'s FPS and the Sinkhorn run their kernels in the
forward pass; the LSTM's and the Sinkhorn's backward recompute their plain
versions (``LSTMFinalHidden``, ``LogOptimalTransport``), as in the fine
trainer.

    python -m text2pos_torch.train.transformer --dataset SYNTHETIC-FINE \\
        --epochs 4 --batch_size 32 --embed_dim 300 --num_layers 6

takes ``text2pos_tpu.train.transformer``'s flags and runs on the card
unless ``--device cpu`` is given; ``--max_batches`` cuts an epoch.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from text2pos_torch.config import TrainConfig, check_ported
from text2pos_torch.data.dense import NUM_CLASS_INDICES, NUM_COLOR_INDICES
from text2pos_torch.data.hints import Vocabulary
from text2pos_torch.data.loaders import FineLoader
from text2pos_torch.device import resolve_device
from text2pos_torch.models.transformer import (TransformerMatch,
                                               init_extra_parameters)
from text2pos_torch.ops.lstm import check_kernel_width
from text2pos_torch.train.coarse import step_generator
from text2pos_torch.train.fine import OFFSET_LOSS_WEIGHT, FineTrainer
from text2pos_torch.train.losses import calc_recall_precision, matching_loss
from text2pos_torch.train.state import (TrainState, init_parameters,
                                        make_optimizer)

AUX_CLASS_WEIGHT = 0.1


class TransformerTrainer(FineTrainer):
    """The fine trainer's batches and point resampling (``tensors``,
    ``points``) around ``TransformerMatch``."""

    def __init__(self, cfg: TrainConfig, vocab: Vocabulary,
                 with_aux_heads: bool = False, device=None):
        check_ported(cfg, "fine")
        self.cfg, self.vocab = cfg, vocab
        self.device = resolve_device(device or cfg.device)
        if self.device.type == "cuda":
            check_kernel_width(cfg.embed_dim)
        self.model = TransformerMatch(
            vocab.size, cfg.embed_dim, cfg.num_layers, cfg.sinkhorn_iters,
            NUM_CLASS_INDICES, NUM_COLOR_INDICES, tuple(cfg.use_features),
            cfg.pointnet_features, with_aux_heads=with_aux_heads)
        self.rank_negatives = 0

    def init_state(self, steps_per_epoch: int,
                   learning_rate: Optional[float] = None) -> TrainState:
        """Fresh weights from ``cfg.seed`` and Adam (JAX's
        ``make_optimizer``: no warm-up)."""
        cfg = self.cfg
        model = init_extra_parameters(init_parameters(self.model, cfg.seed),
                                      cfg.seed + 1).to(self.device)
        opt = make_optimizer(model, learning_rate or cfg.learning_rate,
                             cfg.lr_gamma, steps_per_epoch)
        return TrainState(model, opt)

    def _forward(self, state: TrainState, tb, pts, cols, train: bool,
                 rank: bool = False):
        return state.model(tb["hint_tokens"], tb["hint_lengths"], pts, cols,
                           tb["centers"], tb["colors"], tb["class_idx"],
                           tb["color_idx"], train=train)

    def loss(self, out: Dict[str, torch.Tensor], tb
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(loss, matching NLL, offsets MSE); with the aux heads the loss
        adds 0.1 · the class cross-entropy, as JAX's."""
        lm = matching_loss(out["log_P"], tb["all_matches"],
                           tb["all_matches_count"])
        lo = ((out["offsets"] - tb["offsets"]) ** 2).mean()
        loss = lm + OFFSET_LOSS_WEIGHT * lo
        if "class_pred" in out:
            pred = out["class_pred"]
            loss = loss + AUX_CLASS_WEIGHT * torch.nn.functional.cross_entropy(
                pred.reshape(-1, pred.shape[-1]),
                tb["class_idx"].reshape(-1).long())
        return loss, lm, lo

    def train_step(self, state: TrainState, batch: Dict[str, np.ndarray],
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Dict[str, np.ndarray]] = None
                   ) -> Dict[str, torch.Tensor]:
        """One optimizer step; returns loss, recall and precision (on the
        device, not synchronized)."""
        with record_function("train.forward"):
            tb = self.tensors(batch)
            pts, cols = self.points(tb, True, generator, draws)
            out = self._forward(state, tb, pts, cols, True)
            loss, _, _ = self.loss(out, tb)
        with record_function("train.backward"):
            loss.backward()
        with record_function("train.optimizer"):
            state.apply_gradients()
        recall, precision = calc_recall_precision(
            tb["gt_obj_for_hint"], out["matches0"].detach(),
            out["matches1"].detach())
        return {"loss": loss.detach(), "recall": recall,
                "precision": precision}

    def run_epoch(self, state: TrainState, loader: FineLoader, epoch: int,
                  train: bool = True, draws: Optional[List[Dict]] = None):
        """One pass of training steps over ``loader`` (JAX's order:
        ``loader.epoch(seed=epoch)``), ``--max_batches`` at most; returns
        (state, the metrics' means)."""
        stats: Dict[str, List[torch.Tensor]] = {}
        for i, batch in enumerate(loader.epoch(seed=epoch)):
            if self.cfg.max_batches is not None and i >= self.cfg.max_batches:
                break
            gen = step_generator(self.device, 6, self.cfg.seed, epoch, i)
            metrics = self.train_step(state, batch, gen,
                                      None if draws is None else draws[i])
            for k, v in metrics.items():
                stats.setdefault(k, []).append(v)
        return state, {k: float(torch.stack(v).float().mean().cpu())
                       for k, v in stats.items()}


def train(cfg: TrainConfig, cells_train, poses_train, cells_val=None,
          poses_val=None, log=print) -> Tuple[TrainState, Dict]:
    """JAX's loop: a vocabulary from the training poses, ``cfg.epochs``
    epochs of steps, a line of metric means an epoch."""
    from text2pos_torch.data.hints import (build_vocabulary,
                                           create_hint_description)

    vocab = Vocabulary(build_vocabulary(
        [create_hint_description(p) for p in poses_train]))
    loader = FineLoader(cells_train, poses_train, vocab, cfg.batch_size,
                        cfg.pad_size, cfg.num_mentioned,
                        cfg.pointnet_numpoints, cfg.max_hint_len)
    trainer = TransformerTrainer(cfg, vocab)
    state = trainer.init_state(loader.num_batches(drop_last=True))
    history = []
    for epoch in range(cfg.epochs):
        state, means = trainer.run_epoch(state, loader, epoch)
        history.append(means)
        log(f"epoch {epoch} " + " ".join(f"{k} {v:0.3f}"
                                         for k, v in means.items()))
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
