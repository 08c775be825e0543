"""The fine matching stage evaluated in isolation on ground-truth cells
(counterpart of ``text2pos_tpu/evaluation/fine.py``): recall and
precision of the matches, and six pose errors in cell units, {mid, mean,
offsets} from the predicted matches and {matching_oracle, offset_oracle,
both_oracle} with the ground truth's matches or offsets, each also as
accuracies within thresholds in meters (error · cell size ≤ t).

    python -m text2pos_torch.evaluation.fine --dataset SYNTHETIC-FINE \\
        --path_fine checkpoints/bench_fine.msgpack

takes JAX's flags and runs on the card unless ``--device cpu`` is given:
``FineTrainer.eval_step`` (the model on batch statistics; the LSTM and
Sinkhorn kernels, FPS's, the GNN and PointNet++ as PyTorch ops). The
loader's tail batch is padded by repetition and its padding rows enter the
batch statistics, as in JAX; the metrics count the real rows only.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from text2pos_torch.data.loaders import FineLoader
from text2pos_torch.models.matcher import get_pos_in_cell
from text2pos_torch.train.coarse import step_generator
from text2pos_torch.train.fine import FineTrainer
from text2pos_torch.train.losses import calc_recall_precision
from text2pos_torch.train.state import TrainState

VARIANTS = ("mid", "mean", "offsets", "matching_oracle", "offset_oracle",
            "both_oracle")


def _gt_matches0(gt_obj_for_hint: np.ndarray, num_objects: int) -> np.ndarray:
    """[B, H] ground-truth object per hint → [B, O] ground-truth hint per
    object (−1 where none)."""
    B, H = gt_obj_for_hint.shape
    gt_matches = np.full((B, num_objects), -1, np.int64)
    for b in range(B):
        for h in range(H):
            o = gt_obj_for_hint[b, h]
            if o >= 0:
                gt_matches[b, o] = h
    return gt_matches


@torch.no_grad()
def run_fine(trainer: FineTrainer, state: TrainState, loader: FineLoader,
             threshs: Tuple[float, ...] = (5, 10, 15), cell_size: float = 30.0,
             log=print, draws: Optional[Sequence[Dict]] = None) -> Dict:
    """Every pose of ``loader`` in its batches (unshuffled, the tail
    padded); ``draws[i]`` hands over batch i's resampling draws (``idx``
    [B, O, P]), else a generator seeded by (4, i) draws them. Returns
    ``{"stats": {name: mean}, "thresh": {variant: {t: accuracy}}}``."""
    stats = {k: [] for k in ("recall", "precision") + VARIANTS}
    stats_thresh = {k: {t: [] for t in threshs} for k in VARIANTS}
    as_t = lambda a: torch.as_tensor(np.asarray(a), device=trainer.device)
    for i, batch in enumerate(loader.epoch(seed=0, shuffle=False,
                                           drop_last=False)):
        gen = step_generator(trainer.device, 4, i)
        _, out = trainer.eval_step(state, batch, gen,
                                   None if draws is None else draws[i])
        real = int(batch["num_real"])
        matches0 = out["matches0"][:real]
        offsets = out["offsets"][:real]
        gt_hint = batch["gt_obj_for_hint"][:real]
        centers = as_t(batch["centers"][:real, :, 0:2])
        poses = batch["pose_in_cell"][:real, 0:2]
        oracle_off = as_t(batch["offsets_best_center"][:real])
        gt_m0 = as_t(_gt_matches0(gt_hint, matches0.shape[1]))

        r, p = calc_recall_precision(as_t(gt_hint), matches0,
                                     out["matches1"][:real])
        stats["recall"].append(float(r))
        stats["precision"].append(float(p))
        variants = {
            "mid": (matches0, offsets, True),
            "mean": (matches0, torch.zeros_like(offsets), False),
            "offsets": (matches0, offsets, False),
            "matching_oracle": (gt_m0, offsets, False),
            "offset_oracle": (matches0, oracle_off, False),
            "both_oracle": (gt_m0, oracle_off, False),
        }
        for name, (m0, off, mid) in variants.items():
            if mid:
                preds = np.full((real, 2), 0.5, np.float32)
            else:
                preds = get_pos_in_cell(centers, m0, off).cpu().numpy()
            errors = np.linalg.norm(poses - preds, axis=1)
            stats[name].append(float(np.mean(errors)))
            for t in threshs:
                stats_thresh[name][t].extend(
                    (errors * cell_size <= t).tolist())

    out_stats = {k: float(np.mean(v)) for k, v in stats.items()}
    out_thresh = {k: {t: float(np.mean(v)) for t, v in d.items()}
                  for k, d in stats_thresh.items()}
    log("Fine-in-isolation:")
    for k, v in out_stats.items():
        log(f"  {k}: {v:0.3f}")
    for k, d in out_thresh.items():
        log("  " + k + ": " + " ".join(f"{t}m={v:0.2f}" for t, v in d.items()))
    return {"stats": out_stats, "thresh": out_thresh}


def main(argv: Optional[List[str]] = None,
         draws: Optional[Sequence[Dict]] = None) -> Dict:
    """``python -m text2pos_torch.evaluation.fine``: the fine checkpoint
    (``--path_fine``) on the validation (or ``--use_test_set``) split;
    ``draws`` as ``run_fine``'s."""
    from text2pos_torch.config import (EvalConfig, TrainConfig,
                                       check_eval_ported, parse_config)
    from text2pos_torch.data.hints import Vocabulary
    from text2pos_torch.device import resolve_device
    from text2pos_torch.train.state import (load_checkpoint, load_variables,
                                            restore_variables)
    from text2pos_torch.utils.cli import load_split

    cfg = parse_config(EvalConfig, argv)
    check_eval_ported(cfg)
    resolve_device(cfg.device)
    cells, poses = load_split(cfg, "test" if cfg.use_test_set else "val")
    extra = load_checkpoint(cfg.path_fine)["extra"]
    vocab = Vocabulary(extra["known_words"])
    tcfg = TrainConfig(
        batch_size=cfg.batch_size, embed_dim=extra.get("embed_dim", 128),
        num_layers=extra.get("num_layers", 6),
        sinkhorn_iters=extra.get("sinkhorn_iters", 50),
        pointnet_numpoints=cfg.pointnet_numpoints,
        num_mentioned=cfg.num_mentioned, pad_size=cfg.pad_size,
        no_pc_augment=cfg.no_pc_augment, regressor_cell=cfg.regressor_cell,
        regressor_learn=cfg.regressor_learn, dtype=cfg.dtype,
        device=cfg.device)
    trainer = FineTrainer(tcfg, vocab)
    load_variables(trainer.model, restore_variables(cfg.path_fine))
    state = TrainState(trainer.model.to(trainer.device).eval())
    loader = FineLoader(cells, poses, vocab, cfg.batch_size, cfg.pad_size,
                        cfg.num_mentioned, cfg.pointnet_numpoints,
                        tcfg.max_hint_len, regressor_cell=cfg.regressor_cell,
                        regressor_learn=cfg.regressor_learn)
    cell_size = cells[0].cell_size if cells else 30.0
    return run_fine(trainer, state, loader, threshs=cfg.threshs,
                    cell_size=cell_size, draws=draws)


if __name__ == "__main__":
    main()
