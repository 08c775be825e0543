"""Configurations: ``TrainConfig``, ``EvalConfig`` and ``parse_config``,
copies of ``text2pos_tpu/config.py``'s (the same flags, names and defaults),
and ``ServeConfig``, the fields of its ``EvalConfig`` that serving,
calibration and the map encode read."""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple


@dataclass
class TrainConfig:
    """Training configuration: a copy of ``text2pos_tpu/config.py``'s
    ``TrainConfig`` (the reference's training flags, names and defaults),
    plus ``device``."""

    purpose: str = ""
    batch_size: int = 32
    num_distractors: str = "all"
    max_batches: Optional[int] = None
    dataset: str = "K360"
    base_path: str = ""

    # Model
    embed_dim: int = 300
    num_layers: int = 6          # SuperGlue self/cross block pairs
    use_features: Tuple[str, ...] = ("class", "color", "position")
    shuffle: bool = False
    variation: int = 0           # 0 = max aggregation, 1 = mean (cell_retrieval.py:44-54)
    lr_idx: Optional[int] = None
    learning_rate: float = 1e-3
    continue_path: str = ""
    resume_path: str = ""        # rolling full-state checkpoint; if the file
                                 # exists training resumes from it (params +
                                 # optimizer + epoch), else it is created and
                                 # refreshed at every eval point
    no_pc_augment: bool = False
    no_cell_augment: bool = False

    # SuperGlue
    sinkhorn_iters: int = 50
    num_mentioned: int = 6
    pad_size: int = 16
    describe_by: str = "all"

    # Cell retrieval
    margin: float = 0.35
    top_k: Tuple[int, ...] = (1, 3, 5)
    ranking_loss: str = "pairwise"

    # Object encoder / PointNet
    pointnet_layers: int = 3
    pointnet_variation: int = 0
    pointnet_numpoints: int = 256
    pointnet_path: str = ""
    pointnet_freeze: bool = False
    pointnet_features: int = 2   # which feature tier feeds the object MLP

    class_embed: bool = False
    color_embed: bool = False

    # Offset regressor
    regressor_dim: int = 128
    regressor_cell: str = "pose"      # pose | best
    regressor_learn: str = "center"   # center | closest
    regressor_eval: str = "center"    # center | closest

    epochs: int = 16
    lr_gamma: float = 1.0

    # ------------------------------------------------------------------
    # Additions of the JAX package (no reference equivalent)
    # ------------------------------------------------------------------
    seed: int = 0
    dtype: str = "float32"            # compute dtype for the model bodies
    max_text_len: int = 64            # token cap for joined coarse text
    max_hint_len: int = 16            # token cap for a single hint
    coarse_max_objects: int = 28      # dense cap of objects per cell (coarse)
    flat_object_cap: Optional[int] = None  # packed-object buffer per batch
    data_parallel: int = 1            # devices on the 'dp' mesh axis
    remat: bool = False               # jax.checkpoint the object encoders
    fused: bool = False               # device-resident fused training epochs
    global_negatives: bool = False    # all-gather embeddings for the ranking loss
    # Global-negative memory bank (fused coarse training only): a device-
    # resident table of ALL train-cell embeddings, refreshed once per epoch
    # with the current parameters, scored against every anchor in one MXU
    # matmul. Trains retrieval against the full database instead of the 63
    # in-batch negatives — the serving task is top-k over thousands of cells.
    neg_bank: bool = False
    neg_bank_hardest: int = 8         # hardest bank negatives per anchor
    neg_bank_weight: float = 1.0      # weight of the bank term in the loss
    neg_bank_warmup: int = 2          # epochs before the bank term turns on
    neg_bank_refresh: int = 1         # bank re-embeds per epoch (staleness ↓)
    eval_every: int = 1               # run the retrieval eval every N epochs
    # Rank-aware fine training (the JAX package's addition): listwise loss on a
    # differentiable surrogate of the SERVING re-ranking score — each
    # query's hints are matched against its own cell plus rank_negatives
    # other cells from the batch; softmax-CE pushes the soft transport
    # mass (− rank_gamma · soft vote spread) of the true cell above the
    # negatives'. Trains the fine confidence for the job re-ranking uses
    # it for (the reference's fine loss never compares cells,
    # the Text2Pos reference code, training/fine.py:56-63).
    rank_weight: float = 0.0          # 0 = off (reference loss only)
    rank_negatives: int = 4           # negative cells per query
    rank_tau: float = 1.0             # listwise softmax temperature
    rank_gamma: float = 0.0           # soft vote-spread penalty in the score
    # The port's addition: where the trainers run ("cuda" or "cpu").
    device: str = "cuda"

    def __post_init__(self):
        self.use_features = tuple(self.use_features)
        self.top_k = tuple(self.top_k)
        assert self.variation in (0, 1)
        assert self.ranking_loss in ("triplet", "pairwise", "hardest")
        assert self.regressor_cell in ("pose", "best")
        assert self.regressor_learn in ("center", "closest")
        assert self.regressor_eval in ("center", "closest")
        assert self.describe_by in ("closest", "class", "direction", "random", "all")
        for feat in self.use_features:
            assert feat in ("class", "color", "position"), f"Unexpected feature {feat}"

    @property
    def flat_cap(self) -> int:
        if self.flat_object_cap is not None:
            return self.flat_object_cap
        return self.batch_size * self.coarse_max_objects




@dataclass(frozen=True)
class ServeConfig:
    max_text_len: int = 64            # token cap for the joined query text
    max_hint_len: int = 16            # token cap for a single hint
    num_mentioned: int = 6            # hints per query
    pad_size: int = 16                # objects per cell
    top_k: Tuple[int, ...] = (1, 5, 10)
    threshs: Tuple[int, ...] = (5, 10, 15)   # meters
    pointnet_numpoints: int = 256     # points per resampled object
    coarse_max_objects: int = 28      # object slots per cell of the map bank
    seed: int = 0                     # draws of the map bank and its encode


@dataclass
class EvalConfig:
    """Evaluation configuration: a copy of ``text2pos_tpu/config.py``'s
    ``EvalConfig`` (the same flags, names and defaults), plus ``dtype`` (the
    compute dtype of the restored model bodies: JAX's evaluator runs f32)
    and ``device``. It holds every field of ``ServeConfig``, so a pipeline
    built for evaluation reads it as its serving configuration."""

    purpose: str = ""
    batch_size: int = 32
    dataset: str = "K360"
    base_path: str = ""
    path_coarse: str = ""
    path_fine: str = ""

    top_k: Tuple[int, ...] = (1, 5, 10)
    threshs: Tuple[int, ...] = (5, 10, 15)   # meters
    pad_size: int = 16
    use_test_set: bool = False
    no_pc_augment: bool = False
    num_mentioned: int = 6

    plot_retrievals: bool = False
    plot_matches: bool = False
    coarse_only: bool = False

    # Oracles (the reference's evaluation/args.py:44-50)
    coarse_oracle: bool = False
    street_oracle: bool = False
    coarse_random: bool = False
    fine_oracle: bool = False
    fine_random: bool = False

    # DB-cell encoding sharded over devices (the JAX package's addition)
    data_parallel: int = 1

    pointnet_numpoints: int = 256
    ranking_loss: str = "pairwise"
    regressor_cell: str = "pose"
    regressor_learn: str = "center"
    regressor_eval: str = "center"

    # Additions of the JAX package
    seed: int = 0
    max_text_len: int = 64
    max_hint_len: int = 16
    coarse_max_objects: int = 28
    # Fine-confidence re-ranking: retrieve this many coarse candidates, run
    # the fine matcher on all of them and re-rank by the summed Sinkhorn
    # scores of matched objects before reporting top-k (0 = off).
    rerank: int = 0
    # Weight of the matched position votes' spread in the re-ranking score
    # (conf − gamma·spread).
    rerank_gamma: float = 0.0
    # The port's additions: compute dtype of the model bodies and where the
    # evaluation runs ("cuda" or "cpu").
    dtype: str = "float32"
    device: str = "cuda"

    def __post_init__(self):
        self.top_k = tuple(self.top_k)
        self.threshs = tuple(self.threshs)
        if self.coarse_oracle:
            assert max(self.top_k) >= 1
        if self.coarse_random:
            assert not self.coarse_oracle and not self.street_oracle
        if self.fine_random:
            assert not self.coarse_oracle and not self.fine_oracle


def check_eval_ported(cfg: EvalConfig) -> None:
    """Raise ``ValueError`` for the evaluation options the port does not
    have yet, each naming its ROADMAP item (``--dataset K360`` raises in
    ``utils.cli.load_split``)."""
    if cfg.plot_retrievals:
        raise ValueError("--plot_retrievals is not ported to text2pos_torch "
                         "yet (ROADMAP Queue 1 item 7: utils/drawing.py, "
                         "which needs cv2); use text2pos_tpu.evaluation for "
                         "it")
    if cfg.dtype not in ("float32", "bfloat16"):
        raise ValueError(f"--dtype {cfg.dtype}: float32 or bfloat16")


def check_ported(cfg: TrainConfig, stage: str) -> None:
    """Raise ``ValueError`` for the combinations the data-parallel step does
    not take and for an unknown ``--dtype``; nothing takes another path
    quietly. ``--fused``, ``--neg_bank``, ``--remat``, ``--rank_weight``,
    ``--data_parallel``, ``--global_negatives`` and the model variants
    (``--variation``, ``--class_embed``, ``--color_embed``,
    ``--use_features``, ``--pointnet_features``) are ported. ``stage`` is
    "coarse" or "fine"."""
    if cfg.data_parallel > 1 and cfg.fused:
        # JAX asserts the same (train/coarse.py:289, train/fine.py:264).
        raise ValueError("--fused and --data_parallel exclude each other")
    if cfg.data_parallel > 1 and stage == "fine" and cfg.rank_weight > 0:
        # JAX's data-parallel fine step has no rank term: it would train
        # without it, quietly (parallel/dp.py:129-160).
        raise ValueError("--rank_weight > 0 and --data_parallel exclude "
                         "each other (the data-parallel fine step has no "
                         "rank-aware term)")
    if cfg.dtype not in ("float32", "bfloat16"):
        raise ValueError(f"--dtype {cfg.dtype}: float32 or bfloat16")


def _add_dataclass_args(parser: argparse.ArgumentParser, cls) -> None:
    for f in dataclasses.fields(cls):
        name = "--" + f.name
        default = f.default if f.default is not dataclasses.MISSING else None
        if f.type in ("bool", bool):
            parser.add_argument(name, action="store_true", default=bool(default))
        elif isinstance(default, tuple):
            parser.add_argument(name, nargs="+", type=type(default[0]), default=list(default))
        elif f.type in ("Optional[int]",):
            parser.add_argument(name, type=int, default=default)
        else:
            typ = type(default) if default is not None else str
            parser.add_argument(name, type=typ, default=default)


def parse_config(cls, argv: Optional[Sequence[str]] = None):
    """Parse CLI args into the given config dataclass.

    Keeps the reference flag spelling (`--batch_size`, `--use_features`, ...).
    """
    parser = argparse.ArgumentParser(description=f"Text2Pos (PyTorch): {cls.__name__}")
    _add_dataclass_args(parser, cls)
    ns = parser.parse_args(argv)
    kwargs = {f.name: getattr(ns, f.name) for f in dataclasses.fields(cls)}
    for key in ("use_features", "top_k", "threshs"):
        if key in kwargs and isinstance(kwargs[key], list):
            kwargs[key] = tuple(kwargs[key])
    return cls(**kwargs)
