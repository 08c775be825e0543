"""Coarse cell-retrieval training and retrieval evaluation (counterpart of
``text2pos_tpu/train/coarse.py``).

``CoarseTrainer.train_step`` resamples and augments the batch's points on
the device, runs both towers in train mode (batch-statistics BN with
running updates), the ranking loss, the backward pass and one Adam step;
the profiler ranges ``train.forward``, ``train.backward`` and
``train.optimizer`` split it. The text tower's LSTM runs its kernel in the
forward pass through ``ops.lstm.LSTMFinalHidden`` (the backward recomputes
the plain recurrence); PointNet++ runs as PyTorch ops on batch statistics,
FPS as its kernel. ``eval_epoch`` encodes every query and every cell in
eval mode (running-average BN: the LSTM, FPS and PointConv kernels) and
reports top-k and close-by accuracy.

    python -m text2pos_torch.train.coarse --dataset SYNTHETIC --epochs 4 \\
        --batch_size 64 --embed_dim 256 --coarse_max_objects 24

takes ``text2pos_tpu.train.coarse``'s flags and runs on the card unless
``--device cpu`` is given; ``--fused`` (with ``--neg_bank``) trains from
the device-resident bank of ``train/fused_coarse.py``, ``--remat``
recomputes the object encoder in the backward pass. Draws: the loaders' numpy streams are the JAX
package's, so batches are the same; the point draws come from a
``torch.Generator`` seeded by (seed, epoch, step), or are handed over
(``draws``: sample indices and rotation angles) to repeat JAX's.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from text2pos_torch.config import TrainConfig, check_ported
from text2pos_torch.data.dense import (NUM_CLASS_INDICES, NUM_COLOR_INDICES,
                                       CellBank, flatten_bank_slice)
from text2pos_torch.data.hints import Vocabulary
from text2pos_torch.data.loaders import CoarseLoader
from text2pos_torch.device import resolve_device
from text2pos_torch.models.cell_retrieval import CellRetrievalNetwork
from text2pos_torch.models.object_encoder import ID_KEYS
from text2pos_torch.ops.lstm import check_kernel_width
from text2pos_torch.ops.retrieval import topk_retrieval
from text2pos_torch.ops.transforms import prepare_object_points
from text2pos_torch.train.losses import (hardest_ranking_loss,
                                         pairwise_ranking_loss,
                                         triplet_margin_loss)
from text2pos_torch.train.state import (TrainState, init_parameters,
                                        load_variables, make_optimizer,
                                        restore_variables, save_checkpoint)

DTYPES = {"float32": None, "bfloat16": torch.bfloat16}
OBJECT_KEYS = ("points_xyz", "points_rgb", "point_count", "centers",
               "colors", "cell_idx", "slot_idx") + ID_KEYS


def step_generator(device: torch.device, *seeds: int) -> torch.Generator:
    """A generator on ``device`` seeded from the non-negative integers
    ``seeds`` (the draws' use first: 0 coarse training, 1 coarse cell
    encoding, 2 fine training, 3 fine evaluation)."""
    seed = int(np.random.SeedSequence(list(seeds)).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)


def encoder_options(cfg: TrainConfig) -> Dict:
    """The object encoder's options of a configuration (ROADMAP item 7a's
    variants; the defaults are the bench checkpoints')."""
    return dict(use_features=tuple(cfg.use_features),
                class_embed=cfg.class_embed, color_embed=cfg.color_embed,
                pointnet_features=cfg.pointnet_features)


def build_model(cfg: TrainConfig, vocab_size: int) -> CellRetrievalNetwork:
    return CellRetrievalNetwork(
        vocab_size, cfg.embed_dim, DTYPES[cfg.dtype],
        pointnet_heads=(NUM_CLASS_INDICES, NUM_COLOR_INDICES),
        remat=cfg.remat, variation=cfg.variation, **encoder_options(cfg))


class CoarseTrainer:
    """The train and encode steps of one model configuration; ``model``
    gives a network already built (the evaluator's, restored from a
    checkpoint) in place of a new one."""

    def __init__(self, cfg: TrainConfig, vocab: Vocabulary, device=None,
                 model: Optional[CellRetrievalNetwork] = None):
        check_ported(cfg, "coarse")
        self.cfg = cfg
        self.vocab = vocab
        self.device = resolve_device(device or cfg.device)
        if self.device.type == "cuda":
            check_kernel_width(cfg.embed_dim)
        self.model = model if model is not None else build_model(cfg,
                                                                 vocab.size)

    # ------------------------------------------------------------------
    # Initialization
    # ------------------------------------------------------------------
    def init_state(self, steps_per_epoch: int,
                   learning_rate: Optional[float] = None) -> TrainState:
        """Fresh weights (from ``cfg.seed``), or ``--pointnet_path`` /
        ``--continue_path`` loaded, and Adam."""
        cfg = self.cfg
        model = init_parameters(self.model, cfg.seed)
        if cfg.pointnet_path:
            from text2pos_torch.train.pointnet2 import load_pretrained_into

            load_pretrained_into(model, cfg.pointnet_path)
        if cfg.continue_path:
            load_variables(model, restore_variables(cfg.continue_path))
        model.to(self.device)
        freeze = ("object_encoder/pointnet",) if cfg.pointnet_freeze else ()
        opt = make_optimizer(model, learning_rate or cfg.learning_rate,
                             cfg.lr_gamma, steps_per_epoch,
                             freeze_paths=freeze)
        return TrainState(model, opt)

    # ------------------------------------------------------------------
    # Steps
    # ------------------------------------------------------------------
    def objects(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The batch's valid objects (its flat buffer less the padding
        tail) on the device."""
        valid = batch["flat_valid"].astype(bool)
        return {k: torch.from_numpy(np.ascontiguousarray(batch[k][valid]))
                .to(self.device) for k in OBJECT_KEYS}

    def points(self, obj: Dict[str, torch.Tensor], augment: bool,
               generator: Optional[torch.Generator] = None,
               draws: Optional[Dict[str, np.ndarray]] = None):
        """Resampled (and with ``augment`` rotated) normalized points and
        colours [F, P, 3]; ``draws`` hands over the sample indices
        (``idx`` [F, P]) and angles (``angles`` [F], degrees), or the
        prepared ``points`` (a pair of arrays) themselves."""
        draws = draws or {}
        if "points" in draws:
            return tuple(torch.as_tensor(np.asarray(a), device=self.device)
                         for a in draws["points"])
        as_t = lambda k: (None if k not in draws else
                          torch.as_tensor(np.asarray(draws[k]),
                                          device=self.device))
        return prepare_object_points(
            obj["points_xyz"], obj["points_rgb"], obj["point_count"],
            self.cfg.pointnet_numpoints, generator, augment=augment,
            no_pc_augment=self.cfg.no_pc_augment, idx=as_t("idx"),
            angles=as_t("angles"))

    def loss(self, text: torch.Tensor, cells: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.ranking_loss == "pairwise":
            return pairwise_ranking_loss(text, cells, cfg.margin)
        if cfg.ranking_loss == "hardest":
            return hardest_ranking_loss(text, cells, cfg.margin)
        # One negative cell per anchor: the next sample's, as JAX rolls it.
        return triplet_margin_loss(text, cells, torch.roll(cells, 1, 0),
                                   cfg.margin)

    def forward_towers(self, state: TrainState, batch: Dict[str, np.ndarray],
                       generator: Optional[torch.Generator] = None,
                       draws: Optional[Dict[str, np.ndarray]] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both towers of the step's forward pass in train mode (BN running
        statistics updated): (text [B, E], cells [B, E]), with their
        graph."""
        with record_function("train.forward"):
            return self._towers(state, batch, generator, draws)

    def _towers(self, state, batch, generator, draws):
        cfg = self.cfg
        obj = self.objects(batch)
        pts, cols = self.points(obj, True, generator, draws)
        tok = torch.from_numpy(batch["tokens"]).to(self.device)
        ln = torch.from_numpy(batch["lengths"]).to(self.device)
        return state.model(
            tok, ln, pts, cols, obj["centers"], obj["colors"],
            obj["cell_idx"].long(), obj["slot_idx"].long(),
            len(batch["tokens"]), cfg.coarse_max_objects, train=True,
            class_idx=obj["class_idx"], color_idx=obj["color_idx"])

    def forward_loss(self, state: TrainState, batch: Dict[str, np.ndarray],
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Dict[str, np.ndarray]] = None
                     ) -> torch.Tensor:
        """The step's forward pass in train mode (BN running statistics
        updated): the loss, with its graph."""
        with record_function("train.forward"):
            return self.loss(*self._towers(state, batch, generator, draws))

    def forward_backward(self, state: TrainState, batch: Dict[str, np.ndarray],
                         generator: Optional[torch.Generator] = None,
                         draws: Optional[Dict[str, np.ndarray]] = None
                         ) -> torch.Tensor:
        """The train step up to the optimizer: loss (returned, detached),
        gradients in ``.grad`` and the BN running statistics updated."""
        loss = self.forward_loss(state, batch, generator, draws)
        with record_function("train.backward"):
            loss.backward()
        return loss.detach()

    def train_step(self, state: TrainState, batch: Dict[str, np.ndarray],
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Dict[str, np.ndarray]] = None
                   ) -> torch.Tensor:
        """One optimizer step on ``batch``; returns the loss (on the
        device, not synchronized)."""
        loss = self.forward_backward(state, batch, generator, draws)
        with record_function("train.optimizer"):
            state.apply_gradients()
        return loss

    # ------------------------------------------------------------------
    # Epochs
    # ------------------------------------------------------------------
    def train_epoch(self, state: TrainState, loader: CoarseLoader,
                    epoch: int) -> Tuple[TrainState, float]:
        losses = []
        for i, batch in enumerate(loader.epoch(
                seed=self.cfg.seed * 10_000 + epoch)):
            if self.cfg.max_batches is not None and i >= self.cfg.max_batches:
                break
            gen = step_generator(self.device, 0, self.cfg.seed, epoch, i)
            losses.append(self.train_step(state, batch, gen))
        if not losses:
            return state, float("nan")
        return state, float(np.mean(torch.stack(losses).cpu().numpy()))

    @torch.no_grad()
    def encode_all_queries(self, state: TrainState, loader: CoarseLoader
                           ) -> np.ndarray:
        """[Q, E] text encodings of every pose's un-augmented text."""
        tokens, lengths = loader.all_query_tokens()
        B = self.cfg.batch_size
        out = []
        for i in range(0, len(tokens), B):
            tk = torch.from_numpy(tokens[i:i + B]).to(self.device)
            ln = torch.from_numpy(lengths[i:i + B]).to(self.device)
            out.append(state.model.encode_text(tk, ln))
        return torch.cat(out).cpu().numpy()

    @torch.no_grad()
    def encode_all_cells(self, state: TrainState, bank: CellBank,
                         draws: Optional[Sequence[np.ndarray]] = None
                         ) -> np.ndarray:
        """[C, E] cell encodings in steps of ``batch_size`` cells; step i's
        sample indices from ``draws[i]`` ([F_i, P] over its valid objects
        in flat order) or from a generator seeded by (seed, i)."""
        cfg = self.cfg
        B = cfg.batch_size
        out = []
        for step, i in enumerate(range(0, bank.num_cells, B)):
            idx = np.arange(i, min(i + B, bank.num_cells))
            flat = flatten_bank_slice(bank, idx, B * cfg.coarse_max_objects)
            out.append(self.encode_cells(
                state.model, flat, len(idx),
                step_generator(self.device, 1, cfg.seed, i),
                None if draws is None else draws[step]))
        return torch.cat(out).cpu().numpy()

    def encode_cells(self, model: CellRetrievalNetwork,
                     flat: Dict[str, np.ndarray], num_cells: int,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[np.ndarray] = None) -> torch.Tensor:
        """[num_cells, E] encodings (eval mode) of the cells flat-packed in
        ``flat`` (``flatten_bank_slice``); the sample indices from
        ``draws`` ([F', P] with F' at least the valid objects, in flat
        order) or from ``generator``."""
        obj = self.objects(flat)
        F = obj["points_xyz"].shape[0]
        d = None if draws is None else {"idx": np.asarray(draws)[:F]}
        pts, cols = self.points(obj, False, generator, d)
        return model.encode_objects(
            pts, cols, obj["centers"], obj["colors"],
            obj["cell_idx"].long(), obj["slot_idx"].long(), num_cells,
            self.cfg.coarse_max_objects, obj["class_idx"], obj["color_idx"])

    def eval_epoch(self, state: TrainState, loader: CoarseLoader,
                   top_k: Tuple[int, ...], return_encodings: bool = False,
                   draws: Optional[Sequence[np.ndarray]] = None):
        """Top-k accuracy (the pose's own cell among the k best) and
        close-by accuracy (a retrieved cell within half a cell of the
        pose), by k; and each query's retrieved cell ids."""
        text_enc = self.encode_all_queries(state, loader)
        cell_enc = self.encode_all_cells(state, loader.bank, draws)

        max_k = min(max(top_k), loader.bank.num_cells)
        _, top_idx = topk_retrieval(torch.from_numpy(text_enc),
                                    torch.from_numpy(cell_enc), max_k)
        top_idx = top_idx.numpy()
        target_idx = loader.pose_cell_idx
        bank = loader.bank
        cell_centers = 0.5 * (bank.bbox_w[:, 0:2] + bank.bbox_w[:, 3:5])
        cell_size = float(bank.cell_size[0])
        pose_w = np.array([p.pose_w[0:2] for p in loader.poses])
        dists = np.linalg.norm(cell_centers[top_idx] - pose_w[:, None, :],
                               axis=2)
        hit = top_idx == target_idx[:, None]
        accuracies, accuracies_close = {}, {}
        for k in top_k:
            kk = min(k, max_k)
            accuracies[k] = float(np.mean(np.any(hit[:, :kk], axis=1)))
            accuracies_close[k] = float(
                np.mean(np.any(dists[:, :kk] <= cell_size / 2, axis=1)))
        retrievals = {qi: [bank.cell_ids[ci] for ci in top_idx[qi]]
                      for qi in range(len(top_idx))}
        if return_encodings:
            return accuracies, accuracies_close, retrievals, cell_enc, text_enc
        return accuracies, accuracies_close, retrievals


def make_loaders(cfg: TrainConfig, vocab: Vocabulary, cells_train,
                 poses_train, cells_val, poses_val
                 ) -> Tuple[CoarseLoader, CoarseLoader]:
    """The training loader (hint shuffles and flips unless
    ``--no_cell_augment``) and the validation loader."""
    def make(cells, poses, train_mode):
        return CoarseLoader(
            cells, poses, vocab, cfg.batch_size, cfg.coarse_max_objects,
            cfg.pointnet_numpoints, cfg.max_text_len,
            shuffle_hints=train_mode and not cfg.no_cell_augment,
            flip_poses=train_mode and not cfg.no_cell_augment,
            flat_cap=cfg.flat_cap, seed=cfg.seed)
    return make(cells_train, poses_train, True), make(cells_val, poses_val,
                                                       False)


def train(cfg: TrainConfig, cells_train, poses_train, cells_val, poses_val,
          checkpoint_dir: str = "./checkpoints", log=print
          ) -> Tuple[TrainState, Dict]:
    """The training loop: epochs, evaluation, best-checkpoint retention
    (after half the epochs, by validation top-max(k)), the rolling resume
    file (``--resume_path``) and ``T2P_METRICS_JSONL``."""
    from text2pos_torch.data.hints import (build_vocabulary,
                                           create_hint_description)
    from text2pos_torch.train.state import (load_resume_checkpoint,
                                            save_resume_checkpoint)
    from text2pos_torch.utils.profiling import (MetricsLogger,
                                                enable_nan_tripwire)

    vocab = Vocabulary(build_vocabulary(
        [create_hint_description(p) for p in poses_train]))
    if cfg.fused:
        from text2pos_torch.train.fused_coarse import FusedCoarseTrainer

        trainer = FusedCoarseTrainer(cfg, vocab, cells_train, poses_train,
                                     seed=cfg.seed)
    else:
        trainer = CoarseTrainer(cfg, vocab)
    loader_train, loader_val = make_loaders(cfg, vocab, cells_train,
                                            poses_train, cells_val, poses_val)
    steps_per_epoch = loader_train.num_batches(drop_last=True)
    lr = (float(np.logspace(-2.5, -3.5, 3)[cfg.lr_idx])
          if cfg.lr_idx is not None else cfg.learning_rate)
    state = trainer.init_state(steps_per_epoch, learning_rate=lr)

    dp_step = None
    if cfg.data_parallel > 1:
        # Batch-sharded training (parallel/dp.py); cfg.batch_size is the
        # per-device batch; --global_negatives all-gathers both towers.
        from text2pos_torch.parallel.dp import (dp_coarse_train_step,
                                                dp_train_epoch, make_mesh)

        mesh = make_mesh(cfg.data_parallel, trainer.device, log=log)
        dp_step = dp_coarse_train_step(trainer, mesh, cfg.global_negatives)

    if os.environ.get("T2P_DEBUG_NANS"):
        enable_nan_tripwire()
    metrics_log = MetricsLogger(os.environ.get("T2P_METRICS_JSONL"))
    history = {"train_loss": [], "train_acc": [], "val_acc": [],
               "val_acc_close": []}
    best_acc, best_path = -1.0, None
    start_epoch = 0
    if cfg.resume_path and os.path.isfile(cfg.resume_path):
        state, start_epoch, best_acc, best_path = load_resume_checkpoint(
            cfg.resume_path, state)
        log(f"resumed from {cfg.resume_path}: epoch {start_epoch} done, "
            f"best val-acc {best_acc:0.3f}")

    for epoch in range(start_epoch + 1, cfg.epochs + 1):
        t0 = time.time()
        if cfg.fused:
            state, loss = trainer.fused_train_epoch(state, epoch)
        elif dp_step is not None:
            state, loss = dp_train_epoch(dp_step, trainer, state,
                                         loader_train, epoch, mesh, 0)
        else:
            state, loss = trainer.train_epoch(state, loader_train, epoch)
        history["train_loss"].append(loss)
        if cfg.resume_path:
            save_resume_checkpoint(cfg.resume_path, state, epoch, best_acc,
                                   best_path)
        if epoch % cfg.eval_every and epoch != cfg.epochs:
            log(f"epoch {epoch} loss {loss:0.3f} ({time.time()-t0:0.1f}s)")
            continue
        train_acc, _, _ = trainer.eval_epoch(state, loader_train, cfg.top_k)
        val_acc, val_acc_close, _ = trainer.eval_epoch(state, loader_val,
                                                       cfg.top_k)
        history["train_acc"].append(train_acc)
        history["val_acc"].append(val_acc)
        history["val_acc_close"].append(val_acc_close)
        log(f"epoch {epoch} loss {loss:0.3f} train-acc {train_acc} "
            f"val-acc {val_acc} val-close {val_acc_close} "
            f"({time.time()-t0:0.1f}s)")
        metrics_log.log({"stage": "coarse", "epoch": epoch, "loss": loss,
                         "train_acc": {str(k): v for k, v in train_acc.items()},
                         "val_acc": {str(k): v for k, v in val_acc.items()},
                         "elapsed_s": time.time() - t0})

        if epoch >= cfg.epochs // 2:
            acc = val_acc[max(cfg.top_k)]
            if acc > best_acc:
                path = os.path.join(
                    checkpoint_dir,
                    f"coarse_acc{acc:0.2f}_e{cfg.embed_dim}.msgpack")
                save_checkpoint(path, state, extra={
                    "val_acc": acc, "known_words": vocab.known_words,
                    "embed_dim": cfg.embed_dim, "variation": cfg.variation,
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


def main(argv: Optional[List[str]] = None) -> None:
    from text2pos_torch.config import parse_config
    from text2pos_torch.train.plots import plot_metrics
    from text2pos_torch.utils.cli import load_split

    cfg = parse_config(TrainConfig, argv)
    cells_train, poses_train = load_split(cfg, "train")
    cells_val, poses_val = load_split(cfg, "val")
    _, result = train(cfg, cells_train, poses_train, cells_val, poses_val)
    hist = result["history"]
    metrics = {"train-loss": {"run": hist["train_loss"]}}
    for k in cfg.top_k:
        metrics[f"train-acc-{k}"] = {"run": [a[k] for a in hist["train_acc"]]}
        metrics[f"val-acc-{k}"] = {"run": [a[k] for a in hist["val_acc"]]}
        metrics[f"val-close-{k}"] = {
            "run": [a[k] for a in hist["val_acc_close"]]}
    plot_metrics(metrics, f"./plots/coarse_e{cfg.embed_dim}.png")
    print("best checkpoint:", result["best_path"])


if __name__ == "__main__":
    main()
