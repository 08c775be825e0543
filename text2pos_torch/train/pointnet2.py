"""PointNet++ pretraining on per-object classification (counterpart of
``text2pos_tpu/train/pointnet2.py``).

``ObjectsDataset`` makes every object of every cell one sample (its points
stored by ``sample_points``, its class and colour labels; numpy, the JAX
package's arrays exactly). ``PointNet2Trainer.train_step`` resamples and
rotates the points on the device, runs PointNet++ in train mode (batch
statistics with running updates: PyTorch ops, FPS as its kernel), the
cross-entropy of the class head only (the colour head is kept but not
trained, as in JAX), the backward pass and one Adam step; ``eval_step``
reports the accuracy in eval mode (running statistics: the FPS and
PointConv kernels). ``train`` keeps the best checkpoint by validation
accuracy, ``pointnet_acc{val:0.2f}.msgpack``, removing the previous best;
its parameters seed both stages' object encoders through
``load_pretrained_into`` (``--pointnet_path``).

    python -m text2pos_torch.train.pointnet2 --dataset SYNTHETIC \\
        --epochs 12 --batch_size 64 --pointnet_numpoints 256

takes ``text2pos_tpu.train.pointnet2``'s flags and runs on the card unless
``--device cpu`` is given. Draws: a training step's sample indices and
angles come from a generator seeded by (seed, epoch, step), or are handed
over (``draws``: ``idx`` [B, P] and ``angles`` [B], or the prepared
``points``); every evaluation batch takes the same draws (JAX reuses one
key), from a generator seeded alike for each batch or ``draws``.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from text2pos_torch.config import TrainConfig
from text2pos_torch.data.dense import (NUM_CLASS_INDICES, NUM_COLOR_INDICES,
                                       class_index, color_index,
                                       sample_points)
from text2pos_torch.data.structs import Cell
from text2pos_torch.device import on_device, resolve_device
from text2pos_torch.models.blocks import train_mode
from text2pos_torch.models.pointnet2 import PointNet2
from text2pos_torch.ops.transforms import prepare_object_points
from text2pos_torch.train.coarse import step_generator
from text2pos_torch.train.state import (TrainState, init_parameters,
                                        load_checkpoint, load_variables,
                                        make_optimizer, save_checkpoint)


class ObjectsDataset:
    """Every cell object as one (points, class, colour) sample."""

    def __init__(self, cells: Sequence[Cell], points_per_object: int,
                 seed: int = 0):
        rng = np.random.default_rng(seed)
        xyz, rgb, counts, classes, colors = [], [], [], [], []
        for cell in cells:
            for obj in cell.objects:
                x, r, n = sample_points(obj, points_per_object, rng)
                xyz.append(x)
                rgb.append(r)
                counts.append(n)
                classes.append(class_index(obj.label))
                colors.append(color_index(obj.get_color_text()))
        self.xyz = np.stack(xyz)
        self.rgb = np.stack(rgb)
        self.counts = np.array(counts, np.int32)
        self.classes = np.array(classes, np.int32)
        self.colors = np.array(colors, np.int32)

    def __len__(self):
        return len(self.xyz)

    def epoch(self, batch_size: int, seed: int, shuffle: bool = True
              ) -> Iterator[Dict[str, np.ndarray]]:
        """Full batches only (the tail is dropped), shuffled by
        ``default_rng(seed)``."""
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            idx = order[i: i + batch_size]
            yield {"xyz": self.xyz[idx], "rgb": self.rgb[idx],
                   "counts": self.counts[idx], "classes": self.classes[idx],
                   "colors": self.colors[idx]}


class PointNet2Trainer:
    def __init__(self, cfg: TrainConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device or cfg.device)
        self.model = PointNet2(heads=(NUM_CLASS_INDICES, NUM_COLOR_INDICES))

    def init_state(self, steps_per_epoch: int) -> TrainState:
        """Fresh weights (from ``cfg.seed``) and Adam decaying by
        ``lr_gamma`` an epoch."""
        cfg = self.cfg
        model = init_parameters(self.model, cfg.seed).to(self.device)
        return TrainState(model, make_optimizer(
            model, cfg.learning_rate, cfg.lr_gamma, steps_per_epoch))

    def points(self, batch: Dict, augment: bool,
               generator: Optional[torch.Generator] = None,
               draws: Optional[Dict] = None):
        """[B, P, 3] resampled (rotated with ``augment``) and normalized
        points and their colours."""
        draws = draws or {}
        if "points" in draws:
            return tuple(on_device(a, self.device) for a in draws["points"])
        as_t = lambda k: (None if k not in draws else
                          on_device(draws[k], self.device))
        return prepare_object_points(
            on_device(batch["xyz"], self.device),
            on_device(batch["rgb"], self.device),
            on_device(batch["counts"], self.device),
            self.cfg.pointnet_numpoints, generator, augment=augment,
            no_pc_augment=self.cfg.no_pc_augment, idx=as_t("idx"),
            angles=as_t("angles"))

    def forward_loss(self, state: TrainState, batch: Dict,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Dict] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(cross-entropy of the class head, accuracy) in train mode (BN
        running statistics updated), the loss with its graph."""
        pts, cols = self.points(batch, True, generator, draws)
        labels = on_device(batch["classes"], self.device).long()
        with train_mode(state.model):
            logits = state.model.predict(pts, cols)["class_pred"]
        loss = nn.functional.cross_entropy(logits, labels)
        acc = (logits.detach().argmax(-1) == labels).float().mean()
        return loss, acc

    def train_step(self, state: TrainState, batch: Dict,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Dict] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One Adam step; returns (loss, accuracy) on the device, not
        synchronized."""
        loss, acc = self.forward_loss(state, batch, generator, draws)
        loss.backward()
        state.apply_gradients()
        return loss.detach(), acc

    @torch.no_grad()
    def predictions(self, state: TrainState, batch: Dict,
                    generator: Optional[torch.Generator] = None,
                    draws: Optional[Dict] = None) -> torch.Tensor:
        """Eval-mode class predictions [B] (first maximum on ties)."""
        pts, cols = self.points(batch, False, generator, draws)
        return state.model.predict(pts, cols)["class_pred"].argmax(-1)

    def eval_step(self, state: TrainState, batch: Dict,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[Dict] = None) -> torch.Tensor:
        labels = on_device(batch["classes"], self.device).long()
        return (self.predictions(state, batch, generator, draws)
                == labels).float().mean()


def eval_generator(device: torch.device, seed: int) -> torch.Generator:
    """The evaluation's generator, the same draws for every batch."""
    return step_generator(device, 10, seed)


def train(cfg: TrainConfig, cells_train: Sequence[Cell],
          cells_val: Sequence[Cell], checkpoint_dir: str = "./checkpoints",
          log=print) -> Tuple[TrainState, Dict]:
    """Epochs of training and validation; the best checkpoint by
    validation accuracy is kept (``result["best_path"]``)."""
    ds_train = ObjectsDataset(cells_train, cfg.pointnet_numpoints, cfg.seed)
    ds_val = ObjectsDataset(cells_val, cfg.pointnet_numpoints, cfg.seed)
    log(f"objects: train {len(ds_train)}, val {len(ds_val)}")

    trainer = PointNet2Trainer(cfg)
    state = trainer.init_state(max(1, len(ds_train) // cfg.batch_size))
    dev = trainer.device
    best_acc, best_path = -1.0, None
    history: Dict[str, List[float]] = {"loss": [], "train_acc": [],
                                       "val_acc": []}
    for epoch in range(cfg.epochs):
        out = [trainer.train_step(state, b, step_generator(
            dev, 9, cfg.seed, epoch, i))
            for i, b in enumerate(ds_train.epoch(cfg.batch_size, epoch))]
        losses = [float(l) for l, _ in out]
        accs = [float(a) for _, a in out]
        val_accs = [float(trainer.eval_step(state, b, eval_generator(
            dev, cfg.seed))) for b in ds_val.epoch(cfg.batch_size, 0,
                                                   shuffle=False)]
        val_acc = float(np.mean(val_accs)) if val_accs else float("nan")
        history["loss"].append(float(np.mean(losses)))
        history["train_acc"].append(float(np.mean(accs)))
        history["val_acc"].append(val_acc)
        log(f"epoch {epoch} loss {np.mean(losses):0.3f} "
            f"train-acc {np.mean(accs):0.2f} val-acc {val_acc:0.2f}")
        if val_acc > best_acc:
            path = os.path.join(checkpoint_dir,
                                f"pointnet_acc{val_acc:0.2f}.msgpack")
            save_checkpoint(path, state, extra={"val_acc": val_acc})
            if best_path and best_path != path and os.path.isfile(best_path):
                os.remove(best_path)
            best_acc, best_path = val_acc, path
    return state, {"history": history, "best_path": best_path}


def load_pretrained_into(model: nn.Module, pointnet_path: str,
                         scope: str = "object_encoder") -> nn.Module:
    """Load the params and BN statistics of a PointNet++ checkpoint (its
    class and colour heads included; either package's file) into
    ``model.<scope>.pointnet``."""
    payload = load_checkpoint(pointnet_path)
    load_variables(getattr(model, scope).pointnet, payload)
    return model


def main(argv: Optional[List[str]] = None) -> None:
    from text2pos_torch.config import parse_config
    from text2pos_torch.utils.cli import load_split

    cfg = parse_config(TrainConfig, argv)
    cells_train, _ = load_split(cfg, "train")
    cells_val, _ = load_split(cfg, "val")
    _, result = train(cfg, cells_train, cells_val)
    print("best checkpoint:", result["best_path"])


if __name__ == "__main__":
    main()
