"""Fine matching-stage training (counterpart of
``text2pos_tpu/train/fine.py``).

The loss is the matching NLL plus 5 · the MSE of the offsets, and with
``--rank_weight`` > 0 the rank-aware term: ``rank_weight`` times the
listwise loss of the true cell's soft rank score against those of
``rank_negatives`` other cells of the batch (``forward_rank``; a negative
whose object centres all equal the query's own cell's is left out);
``train_step`` resamples and augments the points on the device, runs the
matcher in train mode (batch-statistics BN with running updates), the
backward pass and one Adam step, under the profiler ranges
``train.forward``, ``train.backward`` and ``train.optimizer``. The hint
encoder's LSTM and the Sinkhorn run their kernels in the forward pass
through their autograd Functions (``ops.lstm.LSTMFinalHidden``,
``ops.sinkhorn.LogOptimalTransport``), whose backward recomputes the plain
versions; the GNN and PointNet++ run as PyTorch ops on batch statistics, as
JAX trains them. ``eval_step`` runs the model on batch statistics without
updates (the fine model's ``eval_batch_stats``, as the JAX trainer's eval)
and reports recall, precision and three pose errors; ``eval_conf`` is JAX's
retrieval-by-confidence probe over it.

    python -m text2pos_torch.train.fine --dataset SYNTHETIC --epochs 4 \\
        --batch_size 32 --embed_dim 128 --num_layers 6

takes ``text2pos_tpu.train.fine``'s flags and runs on the card unless
``--device cpu`` is given. ``--fused`` trains from device-resident samples
(``train/fused_fine.py``), ``--remat`` recomputes the object encoder in the
backward pass. The learning rate warms up at 1e-5 for three
epochs, then takes the target rate; both decay by ``lr_gamma`` each epoch.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from text2pos_torch.config import TrainConfig, check_ported
from text2pos_torch.data.dense import NUM_CLASS_INDICES, NUM_COLOR_INDICES
from text2pos_torch.data.hints import Vocabulary
from text2pos_torch.data.loaders import FineLoader
from text2pos_torch.device import on_device, resolve_device
from text2pos_torch.models.matcher import SuperGlueMatch
from text2pos_torch.models.object_encoder import ID_KEYS
from text2pos_torch.ops.lstm import check_kernel_width
from text2pos_torch.ops.transforms import prepare_object_points
from text2pos_torch.train.coarse import (DTYPES, encoder_options,
                                         step_generator)
from text2pos_torch.train.losses import (calc_pose_error,
                                         calc_recall_precision,
                                         listwise_rank_loss, matching_loss,
                                         soft_rank_score)
from text2pos_torch.train.state import (TrainState, init_parameters,
                                        load_variables, make_optimizer,
                                        restore_variables, save_checkpoint)

WARMUP_LR = 1e-5
WARMUP_EPOCHS = 3
OFFSET_LOSS_WEIGHT = 5.0
TENSOR_KEYS = ("points_xyz", "points_rgb", "point_count", "centers",
               "colors", "hint_tokens", "hint_lengths", "gt_obj_for_hint",
               "all_matches", "all_matches_count", "offsets",
               "pose_in_cell") + ID_KEYS


def build_model(cfg: TrainConfig, vocab_size: int) -> SuperGlueMatch:
    return SuperGlueMatch(
        vocab_size, cfg.embed_dim, cfg.num_layers, cfg.sinkhorn_iters,
        dtype=DTYPES[cfg.dtype], stat_groups=1, eval_batch_stats=True,
        pointnet_heads=(NUM_CLASS_INDICES, NUM_COLOR_INDICES),
        remat=cfg.remat, **encoder_options(cfg))


def warmup_schedule(learning_rate: float, lr_gamma: float,
                    steps_per_epoch: int):
    """1e-5 for the first three epochs, then ``learning_rate``; both times
    ``lr_gamma`` to the epoch (f32, as JAX's schedule)."""
    boundary = WARMUP_EPOCHS * steps_per_epoch

    def sched(count: int) -> float:
        epoch = count // max(steps_per_epoch, 1)
        base = np.float32(WARMUP_LR if count < boundary else learning_rate)
        return float(base * np.float32(lr_gamma) ** np.float32(epoch))
    return sched


class FineTrainer:
    def __init__(self, cfg: TrainConfig, vocab: Vocabulary, device=None):
        check_ported(cfg, "fine")
        self.cfg = cfg
        self.vocab = vocab
        self.device = resolve_device(device or cfg.device)
        if self.device.type == "cuda":
            check_kernel_width(cfg.embed_dim)
        self.model = build_model(cfg, vocab.size)
        self.rank_negatives = (cfg.rank_negatives if cfg.rank_weight > 0
                               else 0)

    def init_state(self, steps_per_epoch: int,
                   learning_rate: Optional[float] = None) -> TrainState:
        """Fresh weights (from ``cfg.seed``), or ``--pointnet_path`` /
        ``--continue_path`` loaded, and Adam on the warm-up schedule."""
        cfg = self.cfg
        model = init_parameters(self.model, cfg.seed)
        if cfg.pointnet_path:
            from text2pos_torch.train.pointnet2 import load_pretrained_into

            load_pretrained_into(model, cfg.pointnet_path)
        if cfg.continue_path:
            load_variables(model, restore_variables(cfg.continue_path))
        model.to(self.device)
        freeze = ("object_encoder/pointnet",) if cfg.pointnet_freeze else ()
        opt = make_optimizer(
            model, 0.0, freeze_paths=freeze, schedule=warmup_schedule(
                learning_rate or cfg.learning_rate, cfg.lr_gamma,
                steps_per_epoch))
        return TrainState(model, opt)

    def tensors(self, batch: Dict[str, np.ndarray]
                ) -> Dict[str, torch.Tensor]:
        """The batch's arrays on the device (tensors already there stay
        as they are)."""
        keys = TENSOR_KEYS + (("sample_mask",) if "sample_mask" in batch
                              else ())
        return {k: on_device(batch[k], self.device) for k in keys}

    def points(self, tb: Dict[str, torch.Tensor], augment: bool,
               generator: Optional[torch.Generator] = None,
               draws: Optional[Dict[str, np.ndarray]] = None):
        """[B, O, P, 3] resampled points and colours; ``draws`` hands over
        ``idx`` [B, O, P] and ``angles`` [B, O] (degrees), or the prepared
        ``points`` (a pair of arrays) themselves."""
        draws = draws or {}
        if "points" in draws:
            return tuple(on_device(a, self.device) for a in draws["points"])
        as_t = lambda k: (None if k not in draws else
                          on_device(draws[k], self.device))
        return prepare_object_points(
            tb["points_xyz"], tb["points_rgb"], tb["point_count"],
            self.cfg.pointnet_numpoints, generator, augment=augment,
            no_pc_augment=self.cfg.no_pc_augment, idx=as_t("idx"),
            angles=as_t("angles"))

    def _forward(self, state: TrainState, tb, pts, cols, train: bool,
                 rank: bool = False):
        args = (tb["hint_tokens"], tb["hint_lengths"], pts, cols,
                tb["centers"], tb["colors"])
        ids = {k: tb[k] for k in ID_KEYS}
        if rank and self.rank_negatives:
            return state.model.forward_rank(*args, self.rank_negatives,
                                            train=train, **ids)
        return state.model(*args, train=train, **ids)

    def loss(self, out: Dict[str, torch.Tensor], tb
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(loss, matching NLL, offsets MSE); the rank-aware term is in the
        loss when ``out`` holds ``neg_P``."""
        lm = matching_loss(out["log_P"], tb["all_matches"],
                           tb["all_matches_count"])
        lo = ((out["offsets"] - tb["offsets"]) ** 2).mean()
        loss = lm + OFFSET_LOSS_WEIGHT * lo
        if "neg_P" in out:
            loss = loss + self.cfg.rank_weight * self.rank_loss(out, tb)
        return loss, lm, lo

    def rank_loss(self, out: Dict[str, torch.Tensor], tb) -> torch.Tensor:
        """The listwise loss of the true cell's soft rank score against the
        R rolled negatives' (``roll(centres, r)`` for r = 1..R); a negative
        whose centres all equal the query's own cell's (several poses
        share a cell) scores −inf, out of the softmax."""
        cfg = self.cfg
        ctr = tb["centers"][..., 0:2]
        pos_s = soft_rank_score(out["P"], ctr, out["offsets"],
                                cfg.rank_gamma)
        neg_ctr = torch.stack([torch.roll(ctr, r, 0) for r in
                               range(1, out["neg_P"].shape[0] + 1)])
        neg_s = soft_rank_score(out["neg_P"], neg_ctr, out["offsets"][None],
                                cfg.rank_gamma)
        same_cell = (neg_ctr == ctr[None]).all(-1).all(-1)
        neg_s = torch.where(same_cell, -math.inf, neg_s)
        return listwise_rank_loss(pos_s, neg_s, cfg.rank_tau)

    def forward_loss(self, state: TrainState, batch: Dict[str, np.ndarray],
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Dict[str, np.ndarray]] = None):
        """The step's forward pass in train mode (BN running statistics
        updated): (loss, matcher outputs, matching NLL, offsets MSE, the
        batch's tensors), the loss with its graph."""
        with record_function("train.forward"):
            tb = self.tensors(batch)
            pts, cols = self.points(tb, True, generator, draws)
            out = self._forward(state, tb, pts, cols, True, rank=True)
            loss, lm, lo = self.loss(out, tb)
        return loss, out, lm, lo, tb

    def forward_backward(self, state: TrainState, batch: Dict[str, np.ndarray],
                         generator: Optional[torch.Generator] = None,
                         draws: Optional[Dict[str, np.ndarray]] = None):
        """The train step up to the optimizer: (loss, matcher outputs,
        matching NLL, offsets MSE), all detached; gradients in ``.grad``,
        BN running statistics updated."""
        loss, out, lm, lo, tb = self.forward_loss(state, batch, generator,
                                                  draws)
        with record_function("train.backward"):
            loss.backward()
        out = {k: v.detach() for k, v in out.items()}
        return loss.detach(), out, lm.detach(), lo.detach(), tb

    def train_step(self, state: TrainState, batch: Dict[str, np.ndarray],
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Dict[str, np.ndarray]] = None
                   ) -> Dict[str, torch.Tensor]:
        """One optimizer step; returns the batch's metrics (on the device,
        not synchronized)."""
        loss, out, lm, lo, tb = self.forward_backward(state, batch, generator,
                                                      draws)
        with record_function("train.optimizer"):
            state.apply_gradients()
        metrics = self._batch_metrics(out, tb)
        metrics.update(loss=loss, loss_matching=lm, loss_offsets=lo)
        return metrics

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: Dict[str, np.ndarray],
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[Dict[str, np.ndarray]] = None):
        """(metrics, outputs) of the model on batch statistics, no
        updates; ``sample_mask`` in the batch limits the metric means."""
        tb = self.tensors(batch)
        pts, cols = self.points(tb, False, generator, draws)
        out = self._forward(state, tb, pts, cols, False)
        return self._batch_metrics(out, tb), out

    def _batch_metrics(self, out, tb) -> Dict[str, torch.Tensor]:
        mask = tb.get("sample_mask")
        recall, precision = calc_recall_precision(
            tb["gt_obj_for_hint"], out["matches0"], out["matches1"],
            sample_mask=mask)
        centers_xy = tb["centers"][..., 0:2]
        poses_xy = tb["pose_in_cell"][..., 0:2]
        return dict(
            recall=recall, precision=precision,
            pose_mid=calc_pose_error(centers_xy, out["matches0"], poses_xy,
                                     use_mid_pred=True, sample_mask=mask),
            pose_mean=calc_pose_error(centers_xy, out["matches0"], poses_xy,
                                      offsets=None, sample_mask=mask),
            pose_offsets=calc_pose_error(centers_xy, out["matches0"],
                                         poses_xy, offsets=out["offsets"],
                                         sample_mask=mask))

    def run_epoch(self, state: TrainState, loader: FineLoader, epoch: int,
                  train: bool, draws: Optional[List[Dict]] = None):
        """One pass over ``loader``: training steps (dropping the tail
        batch), or eval steps over every pose (the tail batch padded and
        masked out of the means). ``draws[i]`` hands over step i's."""
        stats: Dict[str, List[torch.Tensor]] = {}
        for i, batch in enumerate(loader.epoch(
                seed=self.cfg.seed * 10_000 + epoch, shuffle=train,
                drop_last=train)):
            if train and self.cfg.max_batches is not None \
                    and i >= self.cfg.max_batches:
                break
            gen = step_generator(self.device, 2 if train else 3,
                                 self.cfg.seed, epoch, i)
            d = None if draws is None else draws[i]
            if train:
                metrics = self.train_step(state, batch, gen, d)
            else:
                B = batch["gt_obj_for_hint"].shape[0]
                batch["sample_mask"] = np.arange(B) < int(batch["num_real"])
                metrics, _ = self.eval_step(state, batch, gen, d)
            for k, v in metrics.items():
                stats.setdefault(k, []).append(v)
        return state, {k: float(np.mean(torch.stack(v).float().cpu().numpy()))
                       for k, v in stats.items()}


def train(cfg: TrainConfig, cells_train, poses_train, cells_val, poses_val,
          checkpoint_dir: str = "./checkpoints", log=print):
    """The fine-stage loop: epochs, validation, best-checkpoint retention
    (after half the epochs, by mean(recall, precision)), the rolling resume
    file and ``T2P_METRICS_JSONL``."""
    from text2pos_torch.data.hints import (build_vocabulary,
                                           create_hint_description)
    from text2pos_torch.train.state import (load_resume_checkpoint,
                                            save_resume_checkpoint)
    from text2pos_torch.utils.profiling import (MetricsLogger,
                                                enable_nan_tripwire)

    vocab = Vocabulary(build_vocabulary(
        [create_hint_description(p) for p in poses_train]))
    if cfg.fused:
        from text2pos_torch.train.fused_fine import FusedFineTrainer

        trainer = FusedFineTrainer(cfg, vocab, cells_train, poses_train,
                                   seed=cfg.seed)
    else:
        trainer = FineTrainer(cfg, vocab)

    def make_loader(cells, poses):
        return FineLoader(
            cells, poses, vocab, cfg.batch_size, cfg.pad_size,
            cfg.num_mentioned, cfg.pointnet_numpoints, cfg.max_hint_len,
            regressor_cell=cfg.regressor_cell,
            regressor_learn=cfg.regressor_learn, seed=cfg.seed)

    loader_train = make_loader(cells_train, poses_train)
    loader_val = make_loader(cells_val, poses_val)
    steps_per_epoch = loader_train.num_batches(drop_last=True)
    lr = (float(np.logspace(-3.0, -4.0, 3)[cfg.lr_idx])
          if cfg.lr_idx is not None else cfg.learning_rate)
    state = trainer.init_state(steps_per_epoch, learning_rate=lr)

    dp_step = None
    if cfg.data_parallel > 1:
        # Batch-sharded training (parallel/dp.py); cfg.batch_size is the
        # per-device batch.
        from text2pos_torch.parallel.dp import (dp_fine_train_step,
                                                dp_train_epoch, make_mesh)

        mesh = make_mesh(cfg.data_parallel, trainer.device, log=log)
        dp_step = dp_fine_train_step(trainer, mesh)

    if os.environ.get("T2P_DEBUG_NANS"):
        enable_nan_tripwire()
    metrics_log = MetricsLogger(os.environ.get("T2P_METRICS_JSONL"))
    history = {"train": [], "val": []}
    best_acc, best_path = -1.0, None
    start_epoch = -1
    if cfg.resume_path and os.path.isfile(cfg.resume_path):
        state, start_epoch, best_acc, best_path = load_resume_checkpoint(
            cfg.resume_path, state)
        log(f"resumed from {cfg.resume_path}: epoch {start_epoch} done, "
            f"best val-acc {best_acc:0.3f}")

    for epoch in range(start_epoch + 1, cfg.epochs):
        t0 = time.time()
        if cfg.fused:
            state, fused_loss = trainer.fused_train_epoch(state, epoch)
            train_stats = {"loss": fused_loss}
        elif dp_step is not None:
            state, dp_loss = dp_train_epoch(dp_step, trainer, state,
                                            loader_train, epoch, mesh, 2)
            train_stats = {"loss": dp_loss}
        else:
            state, train_stats = trainer.run_epoch(state, loader_train,
                                                   epoch, train=True)
        _, val_stats = trainer.run_epoch(state, loader_val, epoch,
                                         train=False)
        history["train"].append(train_stats)
        history["val"].append(val_stats)
        metrics_log.log({"stage": "fine", "epoch": epoch,
                         "train": train_stats, "val": val_stats,
                         "elapsed_s": time.time() - t0})
        log(f"epoch {epoch} loss {train_stats.get('loss', float('nan')):0.3f}"
            f" t-recall {train_stats.get('recall', float('nan')):0.2f} "
            f"t-prec {train_stats.get('precision', float('nan')):0.2f} "
            f"v-recall {val_stats['recall']:0.2f} "
            f"v-prec {val_stats['precision']:0.2f} "
            f"v-offset {val_stats['pose_offsets']:0.3f} "
            f"({time.time()-t0:0.1f}s)")

        if epoch >= cfg.epochs // 2:
            acc = float(np.mean((val_stats["recall"],
                                 val_stats["precision"])))
            if acc > best_acc:
                path = os.path.join(
                    checkpoint_dir, f"fine_acc{acc:0.2f}_obj-"
                    f"{cfg.num_mentioned}-{cfg.pad_size}.msgpack")
                save_checkpoint(path, state, extra={
                    "val_acc": acc, "known_words": vocab.known_words,
                    "embed_dim": cfg.embed_dim, "num_layers": cfg.num_layers,
                    "sinkhorn_iters": cfg.sinkhorn_iters,
                    "use_features": list(cfg.use_features)})
                if best_path and best_path != path and os.path.isfile(
                        best_path):
                    os.remove(best_path)
                best_acc, best_path = acc, path
        if cfg.resume_path:
            save_resume_checkpoint(cfg.resume_path, state, epoch, best_acc,
                                   best_path)

    return state, {"history": history, "vocab": vocab,
                   "best_path": best_path, "trainer": trainer}


@torch.no_grad()
def eval_conf(trainer: FineTrainer, state: TrainState, loader: FineLoader,
              num_trials: int = 100, num_cells: int = 5, seed: int = 0,
              log=print, draws: Optional[List[Dict]] = None) -> float:
    """Retrieval by confidence (JAX's ``eval_conf``): each trial matches a
    pose's hints against its own cell and ``num_cells - 1`` other poses'
    cells, drawn by ``default_rng(seed)``; the score is how often the own
    cell has the most matched objects (the mean over reading the row
    forwards and backwards, first on ties). The trials run in batches of
    ``batch_size`` rows, the last padded with its last row; ``draws[i]``
    hands over batch i's resampling draws (``idx``)."""
    rng = np.random.default_rng(seed)
    n = len(loader)
    samples = []
    for _ in range(num_trials):
        own = loader.make_sample(int(rng.integers(n)), rng)
        samples.append(own)
        for _ in range(num_cells - 1):
            other = loader.make_sample(int(rng.integers(n)), rng)
            samples.append(dataclasses.replace(own, objects=other.objects))
    B = trainer.cfg.batch_size
    confs = []
    for b, i in enumerate(range(0, len(samples), B)):
        chunk = samples[i:i + B]
        real = len(chunk)
        chunk = chunk + [chunk[-1]] * (B - real)
        batch = loader._collate(chunk, real, np.zeros(B, np.int32))
        _, out = trainer.eval_step(
            state, batch, step_generator(trainer.device, 5, seed, i),
            None if draws is None else draws[b])
        confs.append((out["matches0"] >= 0).sum(1)[:real].cpu().numpy())
    confs = np.concatenate(confs).reshape(num_trials, num_cells)
    acc = float(np.mean(np.argmax(confs, axis=1) == 0))
    acc_rev = float(np.mean(
        np.argmax(confs[:, ::-1], axis=1) == num_cells - 1))
    log(f"Conf score: {0.5 * (acc + acc_rev):0.3f} ({acc:0.3f})")
    return 0.5 * (acc + acc_rev)


def main(argv: Optional[List[str]] = None) -> None:
    from text2pos_torch.config import parse_config
    from text2pos_torch.train.plots import plot_metrics
    from text2pos_torch.utils.cli import load_split

    cfg = parse_config(TrainConfig, argv)
    cells_train, poses_train = load_split(cfg, "train")
    cells_val, poses_val = load_split(cfg, "val")
    _, result = train(cfg, cells_train, poses_train, cells_val, poses_val)
    hist = result["history"]
    metrics = {}
    for split in ("train", "val"):
        for k in (hist[split][0].keys() if hist[split] else []):
            metrics[f"{split}-{k}"] = {"run": [h[k] for h in hist[split]]}
    plot_metrics(metrics, f"./plots/fine_e{cfg.embed_dim}.png")
    print("best checkpoint:", result["best_path"])


if __name__ == "__main__":
    main()
