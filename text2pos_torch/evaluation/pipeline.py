"""Serving: text query → cell and in-cell position (counterpart of
``text2pos_tpu/evaluation/pipeline.py``, ``serve_batch`` and its helpers),
the BN calibration that makes serving per-query (``calibrated_for_serving``,
``with_calibrated_stats``) and the offline DB encode that produces what
serving reads.

Stages of ``serve_batch``: text encode (LSTM kernel) → top-k retrieval over
the precomputed cell embeddings → hint encode (LSTM kernel) → gather from
the fine bank → the fused GNN kernel → Sinkhorn kernel and match
extraction → offset head and in-cell positions → optional stable re-rank.
The cascade (``prune_m``) scores all ``rerank_k`` candidates first with a
cheap pass, the first ``prune_layers`` block pairs and ``prune_sinkhorn``
iterations of the same matcher through the same two kernels, optionally on
the int8 bank of ``quantize_fine_bank`` and with soft scores
(``prune_soft``), and runs the full pass on the ``prune_m`` best only,
reusing the cheap pass's hint encodings.

A pipeline built from the checkpoints alone (``from_checkpoints`` with no
DB cache) is the uncalibrated JAX model: the fine stage's BNs normalize by
batch statistics, so a query's result depends on its batch. The GNN and
PointConv kernels fold calibrated statistics and cannot run there; that
model runs those two stages as PyTorch ops on the card (the LSTM, Sinkhorn
and FPS kernels still run). ``calibrated_for_serving`` turns it into the
per-query, all-kernel serving pipeline.

The offline DB encode (``encode_database``, ``LocalizationPipeline.
encode_database``) turns a ``CellBank`` into ``cell_enc`` [C, 256] through
the coarse object tower (``encode_coarse_cells``, as ``train/coarse.py``'s
``encode_all_cells``) and ``fine_bank_enc`` [C, 16, 128] with
``fine_bank_centers`` [C, 16, 2] through the fine one
(``encode_fine_cells``, as ``precompute_fine_bank``), ``DB_CHUNK`` cells
at a time (``encode_all_coarse``, ``encode_all_fine``). Both run PointNet++
in the pipeline's dtype, the set-abstraction levels through the PointConv
kernel. The coarse tower uses its checkpoint's BN statistics, the fine
tower the calibrated ones of the DB cache. Point resampling and padding
objects draw from a ``torch.Generator`` seeded by ``seed``, so a rebuilt
database matches one built by JAX only statistically; the ``u`` and
``pad_pts`` arguments take given draws instead.

Evaluation (JAX's ``run_coarse``, ``run_fine``, the oracles and the CLI,
``python -m text2pos_torch.evaluation.pipeline``) runs on the pipeline of
``build_pipeline_from_checkpoints``, f32 unless ``--dtype`` says otherwise,
its ``cfg`` an ``EvalConfig``: ``run_coarse`` encodes the queries and the
cells through the coarse trainer's loops (``cfg.batch_size`` a step: the
LSTM, FPS and PointConv kernels) and retrieves with the stable top-k;
``run_fine`` matches chunks of queries against their candidates, from the
fine bank (``precompute_fine_bank``) or re-encoding every candidate, and
re-ranks in numpy as JAX does. On the checkpoints' pipeline every fine BN
takes batch statistics (the bank's 64-cell steps, a chunk's pose-cell
pairs), so the GNN runs as PyTorch ops there, as JAX runs it without its
Pallas kernel; a calibrated pipeline runs the GNN and PointConv kernels.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import copy
import os

import numpy as np
import torch
from torch.profiler import record_function

from text2pos_torch.config import ServeConfig, TrainConfig
from text2pos_torch.constants import PAD_LABEL
from text2pos_torch.data.dense import CellBank, class_index
from text2pos_torch.data.hints import Vocabulary, create_hint_description
from text2pos_torch.device import resolve_device
from text2pos_torch.evaluation.metrics import calc_accuracies
from text2pos_torch.models.blocks import calibrating, set_eval_batch_stats
from text2pos_torch.models.cell_retrieval import CellRetrievalNetwork
from text2pos_torch.models.matcher import SuperGlueMatch, get_pos_in_cell
from text2pos_torch.models.superglue import (fast_graph_requested,
                                             with_fast_graph)
from text2pos_torch.models.object_encoder import FEATURES, ID_KEYS
from text2pos_torch.ops.retrieval import topk_retrieval
from text2pos_torch.ops.superglue_gnn import widen_gnn_stats
from text2pos_torch.ops.transforms import prepare_object_points, sum_points
from text2pos_torch.train.coarse import CoarseTrainer
from text2pos_torch.train.losses import soft_mass_and_spread
from text2pos_torch.train.state import TrainState, load_checkpoint
from text2pos_torch.utils.convert_jax import (jax_to_state_dict,
                                              load_jax_params, module_to_jax)
from text2pos_torch.utils.msgpack_io import msgpack_restore

_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}
PAD_POINTS = 8          # points of a padding object, uniform in [0, 0.001)³
DB_CHUNK = 64           # cells per DB-encode step (precompute_fine_bank's)
Draws = Tuple[torch.Tensor, torch.Tensor]   # (u, pad_pts) of fine_cell_points
BANK_FIELDS = ("points_xyz", "points_rgb", "point_count", "centers", "colors",
               "mask", "class_idx", "color_idx")
PAD_CLASS_IDX = class_index(PAD_LABEL)  # a padding object's ids: class "pad",
PAD_COLOR_IDX = 5                       # colour "black" (zero RGB), as JAX's
# JAX leaves that encoding never reads (PointNet's class and colour heads).
_UNREAD = ("class_classifier", "color_classifier")


def hint_arrays(vocab: Vocabulary, hint_lists: Sequence[Sequence[str]],
                num_mentioned: int, max_hint_len: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(hint_tokens [Q, H, T], hint_lengths [Q, H]) of the first H hints of
    each query; missing hints are all-pad with length 1."""
    Q, H = len(hint_lists), num_mentioned
    hint_tokens = np.zeros((Q, H, max_hint_len), np.int32)
    hint_lengths = np.ones((Q, H), np.int32)
    for i, hints in enumerate(hint_lists):
        if hints:
            tk, ln = vocab.encode_batch(list(hints)[:H], max_hint_len)
            hint_tokens[i, :len(tk)] = tk
            hint_lengths[i, :len(ln)] = ln
    return hint_tokens, hint_lengths


def bank_tensors(bank: CellBank, device) -> Dict[str, torch.Tensor]:
    """The bank's dense per-cell arrays as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(getattr(bank, k))).to(device)
            for k in BANK_FIELDS}


def _pad_filled_cell_tensors(bt: Dict[str, torch.Tensor], idx: torch.Tensor,
                             pad: int, pad_pts: torch.Tensor):
    """Cells ``idx`` cut to ``pad`` slots, empty slots filled with padding
    objects: ``PAD_POINTS`` points ``pad_pts`` [n, pad, 8, 3], black, their
    centre the points' mean."""
    xyz, rgb, count, centers, colors, mask = (
        bt[k][idx][:, :pad] for k in BANK_FIELDS[:6])
    pad_xyz = torch.zeros_like(xyz)
    pad_xyz[:, :, :PAD_POINTS] = pad_pts
    m4 = mask[:, :, None, None]
    xyz = torch.where(m4, xyz, pad_xyz)
    rgb = torch.where(m4, rgb, torch.zeros_like(rgb))
    count = torch.where(mask, count, torch.full_like(count, PAD_POINTS))
    pad_ctr = sum_points(pad_pts) / PAD_POINTS
    centers = torch.where(mask[..., None], centers, pad_ctr)
    colors = torch.where(mask[..., None], colors, torch.zeros_like(colors))
    return xyz, rgb, count, centers, colors


def fine_cell_points(bt: Dict[str, torch.Tensor], idx: torch.Tensor,
                     pad: int, generator: Optional[torch.Generator] = None,
                     u: Optional[torch.Tensor] = None,
                     pad_pts: Optional[torch.Tensor] = None,
                     num_points: int = ServeConfig.pointnet_numpoints,
                     no_pc_augment: bool = False
                     ) -> Tuple[torch.Tensor, ...]:
    """The fine tower's input for cells ``idx``: (xyz, rgb [n, pad, P, 3]
    resampled to P = ``num_points`` and normalize-scaled (not scaled with
    ``no_pc_augment``), centers, colors [n, pad, 3]), empty slots filled
    with padding objects. ``pad_pts`` [n, pad, 8, 3] and ``u`` [n, pad, P]
    are the padding points and resampling draws (drawn from ``generator``,
    in that order, when None)."""
    dev = bt["points_xyz"].device
    if pad_pts is None:
        pad_pts = torch.rand((len(idx), pad, PAD_POINTS, 3),
                             generator=generator, device=dev) * 0.001
    xyz, rgb, count, centers, colors = _pad_filled_cell_tensors(
        bt, idx, pad, pad_pts.to(dev, torch.float32))
    xyz, rgb = prepare_object_points(xyz, rgb, count, num_points, generator,
                                     u, no_pc_augment=no_pc_augment)
    return xyz, rgb, centers, colors


def checkpoint_encoder_options(params: Dict, extra: Dict) -> Dict:
    """The object encoder's options of a checkpoint: ``use_features`` from
    its ``extra`` (as JAX's ``build_pipeline_from_checkpoints`` reads it),
    and what its parameter tree shows, which JAX's extras do not hold: an
    id embedding (``class_embedding``, ``color_embedding``) and the width
    ``mlp_pointnet`` reads (``pointnet_features`` 0, 1, 2: 1024, 512,
    256)."""
    oe = params["object_encoder"]
    out = dict(use_features=tuple(extra.get("use_features", FEATURES)),
               class_embed="class_embedding" in oe,
               color_embed="color_embedding" in oe)
    if "mlp_pointnet" in oe:
        width = np.shape(oe["mlp_pointnet"]["dense_0"]["kernel"])[0]
        out["pointnet_features"] = {1024: 0, 512: 1, 256: 2}[width]
    return out


def cell_ids(encoder, bt: Dict[str, torch.Tensor], idx: torch.Tensor,
             pad: Optional[int] = None) -> Dict[str, Optional[torch.Tensor]]:
    """``class_idx`` and ``color_idx`` of cells ``idx`` for ``encoder``'s
    id-embedding variants (None for the others, which read none): the fine
    tower's [n, pad] with empty slots the padding object's ids (``pad``
    given), or the coarse tower's valid objects in ``coarse_cell_points``'
    order."""
    if not encoder.needs_ids:
        return dict.fromkeys(ID_KEYS)
    if pad is None:
        cell, slot = bt["mask"][idx].nonzero(as_tuple=True)
        return {k: bt[k][idx[cell], slot] for k in ID_KEYS}
    mask = bt["mask"][idx][:, :pad]
    return {k: torch.where(mask, bt[k][idx][:, :pad], fill)
            for k, fill in zip(ID_KEYS, (PAD_CLASS_IDX, PAD_COLOR_IDX))}


def encode_fine_cells(fine: SuperGlueMatch, bt: Dict[str, torch.Tensor],
                      idx: torch.Tensor, pad: int,
                      generator: Optional[torch.Generator] = None,
                      u: Optional[torch.Tensor] = None,
                      pad_pts: Optional[torch.Tensor] = None,
                      num_points: int = ServeConfig.pointnet_numpoints,
                      no_pc_augment: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fine object encodings of cells ``idx`` (as JAX's
    ``_encode_cells_chunk``): (enc [n, pad, E] f32, centers_xy [n, pad, 2]
    f32); the draws and ``no_pc_augment`` as in ``fine_cell_points``."""
    xyz, rgb, centers, colors = fine_cell_points(bt, idx, pad, generator, u,
                                                 pad_pts, num_points,
                                                 no_pc_augment)
    enc = fine.encode_cell_objects(
        xyz, rgb, centers, colors,
        **cell_ids(fine.object_encoder, bt, idx, pad))
    return enc, centers[..., 0:2]


def coarse_cell_points(bt: Dict[str, torch.Tensor], idx: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       u: Optional[torch.Tensor] = None,
                       num_points: int = ServeConfig.pointnet_numpoints
                       ) -> Tuple[torch.Tensor, ...]:
    """The coarse tower's input for cells ``idx``: the valid objects, cell by
    cell in slot order (the order of JAX's flat buffer), as (xyz, rgb
    [F, P, 3] resampled to P = ``num_points`` and normalize-scaled, centers,
    colors [F, 3], cell, slot [F]); ``u`` [F, P] gives their resampling
    draws (drawn from ``generator`` when None)."""
    mask = bt["mask"][idx]
    cell, slot = mask.nonzero(as_tuple=True)
    flat = idx[cell]
    xyz, rgb = prepare_object_points(
        bt["points_xyz"][flat, slot], bt["points_rgb"][flat, slot],
        bt["point_count"][flat, slot], num_points, generator, u)
    return (xyz, rgb, bt["centers"][flat, slot], bt["colors"][flat, slot],
            cell, slot)


def encode_coarse_cells(coarse: CellRetrievalNetwork,
                        bt: Dict[str, torch.Tensor], idx: torch.Tensor,
                        generator: Optional[torch.Generator] = None,
                        u: Optional[torch.Tensor] = None,
                        num_points: int = ServeConfig.pointnet_numpoints
                        ) -> torch.Tensor:
    """Coarse embeddings [n, E] of cells ``idx`` (as JAX's
    ``encode_cells_step``). PointNet++ runs on the valid objects only; the
    draws as in ``coarse_cell_points``."""
    return coarse.encode_objects(
        *coarse_cell_points(bt, idx, generator, u, num_points), len(idx),
        bt["mask"].shape[1], **cell_ids(coarse.object_encoder, bt, idx))


def _db_chunks(bt: Dict[str, torch.Tensor]):
    C, dev = bt["mask"].shape[0], bt["mask"].device
    return [torch.arange(i, min(i + DB_CHUNK, C), device=dev)
            for i in range(0, C, DB_CHUNK)]


def encode_all_coarse(coarse: CellRetrievalNetwork,
                      bt: Dict[str, torch.Tensor],
                      generator: torch.Generator,
                      num_points: int = ServeConfig.pointnet_numpoints
                      ) -> torch.Tensor:
    """``cell_enc`` [C, E] of every cell of ``bt``, ``DB_CHUNK`` at a time."""
    return torch.cat([encode_coarse_cells(coarse, bt, idx, generator,
                                          num_points=num_points)
                      for idx in _db_chunks(bt)])


def encode_all_fine(fine: SuperGlueMatch, bt: Dict[str, torch.Tensor],
                    pad: int, generator: Optional[torch.Generator] = None,
                    num_points: int = ServeConfig.pointnet_numpoints,
                    draws: Optional[Sequence[Draws]] = None,
                    no_pc_augment: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(``fine_bank_enc`` [C, pad, E], ``fine_bank_centers`` [C, pad, 2]) of
    every cell of ``bt``, ``DB_CHUNK`` at a time. A short last step is
    filled up with cell 0 as ``precompute_fine_bank`` fills it: a model on
    batch statistics sees the same batches as JAX's. ``draws`` gives each
    step's ``(u, pad_pts)`` over its ``DB_CHUNK`` cells (drawn from
    ``generator`` when None)."""
    out = []
    for i, idx in enumerate(_db_chunks(bt)):
        real = len(idx)
        idx = torch.cat([idx, idx.new_zeros(DB_CHUNK - real)])
        u, pad_pts = draws[i] if draws is not None else (None, None)
        enc, ctr = encode_fine_cells(fine, bt, idx, pad, generator, u,
                                     pad_pts, num_points, no_pc_augment)
        out.append((enc[:real], ctr[:real]))
    return torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out])


def quantize_fine_bank(obj_enc_bank: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fine bank in int8 with per-object scales (JAX's
    ``quantize_fine_bank``): scale = absmax/127 [C, pad, 1] f32, q =
    round(x / scale) half to even, clipped to ±127; dequantize as
    ``q * scale``. The cascade's cheap pass reads it."""
    b = obj_enc_bank.float()
    scale = b.abs().amax(-1, keepdim=True).clamp_min(1e-12) / 127.0
    q = torch.round(b / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def _check_unread(unused: Sequence[str], what: str) -> None:
    """Every checkpoint leaf but the PointNet heads must have been loaded."""
    extra = [u for u in unused if u.split("/")[-2] not in _UNREAD]
    if extra:
        raise ValueError(f"{what}: checkpoint leaves not loaded: {extra}")


def _match_confidence_scores(matches0: torch.Tensor,
                             mscores0: torch.Tensor) -> torch.Tensor:
    """Summed transport scores of matched objects, [B, K] f32."""
    return torch.where(matches0 >= 0, mscores0.float(),
                       mscores0.new_zeros((), dtype=torch.float32)).sum(2)


def _match_vote_spread(matches1: torch.Tensor, offsets: torch.Tensor,
                       centers_xy: torch.Tensor) -> torch.Tensor:
    """RMS distance of matched hints' position votes (matched object center
    + hint offset) to their mean, [B, K] f32; 0 when ≤ 1 hint matches.

    matches1 [B, K, H], offsets [B, K, H, 2], centers_xy [B, K, pad, 2].
    """
    valid = matches1 >= 0
    idx = matches1.clamp_min(0)[..., None].expand(*matches1.shape, 2)
    votes = (torch.gather(centers_xy, 2, idx) + offsets).float()
    n = valid.sum(-1).clamp_min(1)
    mean_v = (votes * valid[..., None]).sum(2) / n[..., None]
    d2 = ((votes - mean_v[:, :, None, :]) ** 2).sum(-1)
    return torch.sqrt((d2 * valid).sum(-1) / n)


def _match_results(out: Dict[str, torch.Tensor], centers_xy: torch.Tensor):
    """The matcher's outputs over [B·K] pairs → (pos_mean, pos_offsets
    [B, K, 2], confidences, conf_scores, spreads [B, K]) for the candidates'
    object centres ``centers_xy`` [B, K, pad, 2]."""
    B, K, pad = centers_xy.shape[:3]
    matches0 = out["matches0"].reshape(B, K, pad)
    mscores0 = out["matching_scores0"].reshape(B, K, pad)
    offsets = out["offsets"].reshape(B, K, -1, 2)
    pos_mean = get_pos_in_cell(centers_xy, matches0, torch.zeros_like(offsets))
    pos_offsets = get_pos_in_cell(centers_xy, matches0, offsets)
    confidences = (matches0 >= 0).sum(2)
    conf_scores = _match_confidence_scores(matches0, mscores0)
    spreads = _match_vote_spread(out["matches1"].reshape(B, K, -1), offsets,
                                 centers_xy)
    return pos_mean, pos_offsets, confidences, conf_scores, spreads


def _rerank_order(conf_scores: np.ndarray, spreads: np.ndarray,
                  gamma: float) -> np.ndarray:
    """Re-ranked candidate order per query, [Q, K] indices into the coarse
    top-k list (JAX's ``_rerank_order``, numpy): score ``conf −
    gamma·spread``, the stable sort keeping the coarse order among ties."""
    score = np.asarray(conf_scores, np.float32)
    if gamma:
        score = score - gamma * np.asarray(spreads, np.float32)
    return np.argsort(-score, axis=1, kind="stable")


def _take(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    idx = order.reshape(order.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(*order.shape, *x.shape[2:]))


def _compact_results(top_idx, pos_mean, pos_offsets, confidences,
                     conf_scores, top_k: int, rerank_k: int, num_cells: int,
                     sims=None, rerank_lambda: float = 0.0, spreads=None,
                     rerank_gamma: float = 0.0):
    """Stable re-rank by ``conf + λ·sim − γ·spread`` when ``rerank_k >
    top_k``, then the compact wire types: int16 cell indices (DB under
    2^15 cells), f16 positions, u8 match counts."""
    if rerank_k > top_k:
        score = conf_scores.float()
        if sims is not None and rerank_lambda:
            score = score + rerank_lambda * sims.float()
        if spreads is not None and rerank_gamma:
            score = score - rerank_gamma * spreads.float()
        order = torch.sort(-score, dim=1, stable=True).indices[:, :top_k]
        top_idx, pos_mean, pos_offsets, confidences = (
            _take(x, order) for x in (top_idx, pos_mean, pos_offsets,
                                      confidences))
    if num_cells < 2 ** 15:
        top_idx = top_idx.to(torch.int16)
    return (top_idx, pos_mean.half(), pos_offsets.half(),
            confidences.to(torch.uint8))


class LocalizationPipeline:
    """Coarse retriever + fine matcher + the serving-resident DB tensors
    (None until a database is given: ``with_database``). ``mesh``
    (``parallel.dp.make_mesh``, set by ``build_pipeline_from_checkpoints``
    from the evaluator's ``--data_parallel``) shards the evaluation's
    DB-cell encode over its devices."""

    def __init__(self, coarse: CellRetrievalNetwork, fine: SuperGlueMatch,
                 vocab: Vocabulary, fine_vocab: Vocabulary,
                 cell_enc: Optional[torch.Tensor] = None,
                 fine_bank_enc: Optional[torch.Tensor] = None,
                 fine_bank_centers: Optional[torch.Tensor] = None,
                 cfg: ServeConfig = ServeConfig()):
        self.coarse, self.fine = coarse.eval(), fine.eval()
        self.vocab, self.fine_vocab, self.cfg = vocab, fine_vocab, cfg
        self.cell_enc = cell_enc
        self.fine_bank_enc = fine_bank_enc
        self.fine_bank_centers = fine_bank_centers
        self.mesh = None
        self.device = fine.superglue.final_proj.weight.device

    @classmethod
    def from_checkpoints(cls, coarse: str, fine: str,
                         db_cache: Optional[str] = None,
                         dtype: Optional[str] = "bfloat16",
                         device: Union[str, torch.device] = "cuda",
                         cfg: ServeConfig = ServeConfig()
                         ) -> "LocalizationPipeline":
        """Restore both stages, object towers included, from flax msgpack
        checkpoints. ``dtype`` is the compute dtype of the fine model bodies
        and of both object towers.

        With ``db_cache`` (``cell_enc``, ``fine_bank_enc``,
        ``fine_bank_centers`` and the ``bn_stat_groups=2`` ``batch_stats``)
        the pipeline serves calibrated from that database. Without it (JAX's
        ``build_pipeline_from_checkpoints``) it holds no database and its
        fine model is the uncalibrated one, on batch statistics, carrying
        the checkpoint's own statistics; ``encode_database`` and
        ``calibrated_for_serving`` go on from there."""
        dev = resolve_device(device)
        if dtype not in _DTYPES:
            raise ValueError(f"unsupported dtype {dtype!r}")
        cp, fp = load_checkpoint(coarse), load_checkpoint(fine)
        cx, fx = cp["extra"], fp["extra"]
        vocab = Vocabulary(cx["known_words"])
        fine_vocab = Vocabulary(fx.get("known_words", cx["known_words"]))

        def vocab_rows(params):
            return params["language_encoder"]["word_embedding"][
                "embedding"].shape[0]

        coarse_model = CellRetrievalNetwork(
            vocab_rows(cp["params"]), cx.get("embed_dim", 256),
            dtype=_DTYPES[dtype], variation=cx.get("variation", 0),
            **checkpoint_encoder_options(cp["params"], cx))
        _check_unread(load_jax_params(coarse_model, cp["params"],
                                      cp["batch_stats"]), coarse)
        fine_model = SuperGlueMatch(
            vocab_rows(fp["params"]), fx.get("embed_dim", 128),
            num_layers=fx.get("num_layers", 6),
            sinkhorn_iters=fx.get("sinkhorn_iters", 50),
            dtype=_DTYPES[dtype], stat_groups=2, eval_batch_stats=True,
            **checkpoint_encoder_options(fp["params"], fx))
        widen_gnn_stats(fp["batch_stats"]["superglue"]["gnn"])
        _check_unread(load_jax_params(fine_model, fp["params"],
                                      fp["batch_stats"]), fine)
        pipe = cls(coarse_model.to(dev), fine_model.to(dev), vocab,
                   fine_vocab, cfg=cfg)
        if db_cache is None:
            return pipe
        with np.load(db_cache) as z:
            db = [torch.from_numpy(z[k].astype(np.float32)).to(dev)
                  for k in ("cell_enc", "fine_bank_enc", "fine_bank_centers")]
            stats = msgpack_restore(z["batch_stats"].tobytes())
        if db[1].shape[1] != cfg.pad_size or db[2].shape[1] != cfg.pad_size:
            raise ValueError(f"{db_cache}: fine bank holds {db[1].shape[1]} "
                             f"objects per cell, the matcher {cfg.pad_size}")
        return pipe.with_calibrated_stats(stats).with_database(*db)

    def with_database(self, cell_enc: torch.Tensor,
                      fine_bank_enc: Optional[torch.Tensor],
                      fine_bank_centers: Optional[torch.Tensor]
                      ) -> "LocalizationPipeline":
        """The same models serving from another database."""
        return LocalizationPipeline(self.coarse, self.fine, self.vocab,
                                    self.fine_vocab, cell_enc, fine_bank_enc,
                                    fine_bank_centers, self.cfg)

    def with_calibrated_stats(self, batch_stats: Dict
                              ) -> "LocalizationPipeline":
        """The eval-mode serving pipeline on previously computed calibration
        statistics (the fine model's JAX-layout ``batch_stats``: object
        encoder and the GNN's ``[2, F]`` per-set rows, as
        ``calibrated_for_serving`` leaves them and the DB cache holds
        them), with the same database."""
        fine = copy.deepcopy(self.fine)
        fine.load_state_dict(jax_to_state_dict(
            fine, module_to_jax(fine)[0], batch_stats))
        set_eval_batch_stats(fine, False)
        _switch_fast_graph(fine)
        return LocalizationPipeline(self.coarse, fine, self.vocab,
                                    self.fine_vocab, self.cell_enc,
                                    self.fine_bank_enc,
                                    self.fine_bank_centers, self.cfg)

    def batch_stats(self) -> Dict:
        """The fine model's BN statistics as a JAX-layout numpy tree."""
        return module_to_jax(self.fine)[1]

    @torch.no_grad()
    def calibrated_for_serving(self, bank: CellBank, hint_tokens,
                               hint_lengths, top_idx, max_cells: int = 128,
                               sample_draws: Optional[Draws] = None,
                               bank_draws: Optional[Sequence[Draws]] = None
                               ) -> "LocalizationPipeline":
        """Freeze the fine stage's BNs on population statistics (JAX's
        ``calibrated_for_serving``): the returned pipeline serves in eval
        mode, each query independent of its batch, through the GNN and
        PointConv kernels, from the fine bank re-encoded here and this
        pipeline's ``cell_enc``. In JAX's order:

        1. one forward of the object encoder on batch statistics over the
           first ``min(C, max_cells)`` cells of ``bank`` overwrites its BN
           statistics with theirs (PyTorch ops on the card, FPS's kernel);
        2. the fine bank is encoded in eval mode with them (the PointConv
           kernel);
        3. one forward of the GNN on batch statistics over the calibration
           queries (``hint_tokens`` [Q, H, T], ``hint_lengths``) matched
           against their retrievals ``top_idx`` [Q, K] in the new bank
           writes the object set's statistics into row 0 and the hints'
           into row 1 of every block BN.

        Draws come from a ``torch.Generator`` seeded by ``cfg.seed``;
        ``sample_draws`` (step 1's ``(u, pad_pts)``) and ``bank_draws``
        (step 2's, one pair a ``DB_CHUNK`` step) give them instead."""
        cfg, dev = self.cfg, self.device
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        bt = bank_tensors(bank, dev)
        fine = set_eval_batch_stats(copy.deepcopy(self.fine), True)
        _switch_fast_graph(fine)

        sample = torch.arange(min(bank.num_cells, max_cells), device=dev)
        u, pad_pts = sample_draws if sample_draws is not None else (None,
                                                                    None)
        points = fine_cell_points(bt, sample, cfg.pad_size, gen, u, pad_pts,
                                  cfg.pointnet_numpoints)
        with calibrating(fine.object_encoder):
            fine.encode_cell_objects(*points, **cell_ids(
                fine.object_encoder, bt, sample, cfg.pad_size))

        set_eval_batch_stats(fine, False)
        fb_enc, fb_ctr = encode_all_fine(fine, bt, cfg.pad_size, gen,
                                         cfg.pointnet_numpoints, bank_draws)

        sg = set_eval_batch_stats(fine.superglue, True)
        hint_enc = fine.encode_hints(self._as_tensor(hint_tokens),
                                     self._as_tensor(hint_lengths))
        top_idx = self._as_tensor(top_idx).long()
        with calibrating(sg):
            fine.match_encoded(fb_enc[top_idx.reshape(-1)],
                               hint_enc.repeat_interleave(top_idx.shape[1],
                                                          dim=0))
        set_eval_batch_stats(sg, False)
        return LocalizationPipeline(self.coarse, fine, self.vocab,
                                    self.fine_vocab, self.cell_enc, fb_enc,
                                    fb_ctr, cfg)

    @torch.inference_mode()
    def encode_database(self, bank: CellBank, seed: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Offline DB encode of every cell of ``bank``: (cell_enc
        [C, E_coarse], fine_bank_enc [C, pad, E_fine], fine_bank_centers
        [C, pad, 2]), f32 on the pipeline's device; draws seeded by
        ``seed`` (``cfg.seed`` when None)."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(
            cfg.seed if seed is None else seed)
        bt = bank_tensors(bank, self.device)
        cell_enc = encode_all_coarse(self.coarse, bt, gen,
                                     cfg.pointnet_numpoints)
        return (cell_enc, *encode_all_fine(self.fine, bt, cfg.pad_size, gen,
                                           cfg.pointnet_numpoints))

    def _as_tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device)

    def _gather(self, top_idx: torch.Tensor, bank: torch.Tensor
                ) -> torch.Tensor:
        """Rows ``top_idx`` [B, K] of a per-cell bank → [B, K, ...]."""
        return bank[top_idx.reshape(-1)].reshape(*top_idx.shape,
                                                 *bank.shape[1:])

    def _match_from_enc(self, obj_enc, centers_xy, hint_enc,
                        num_layers: Optional[int] = None,
                        sinkhorn_iterations: Optional[int] = None):
        """Matcher core: obj_enc [B, K, pad, E], centers_xy [B, K, pad, 2],
        hint_enc [B, H, E]; the depth cut as in ``SuperGlue.forward``."""
        K = obj_enc.shape[1]
        out = self.fine.match_encoded(obj_enc.flatten(0, 1),
                                      hint_enc.repeat_interleave(K, dim=0),
                                      num_layers, sinkhorn_iterations)
        return _match_results(out, centers_xy)

    def _cheap_keep(self, top_idx, sims, hint_enc, prune_m: int,
                    prune_layers: int, prune_sinkhorn: int, prune_soft: bool,
                    cheap_bank, cheap_scale, rerank_lambda: float,
                    rerank_gamma: float) -> torch.Tensor:
        """The cascade's cheap pass over all candidates ``top_idx`` [B, K]:
        the columns [B, prune_m] of the best by ``conf + λ·sim − γ·spread``
        (stable: coarse order breaks ties). Hard scores come from match
        extraction, soft ones (``prune_soft``) from the transport matrix
        (``soft_mass_and_spread``)."""
        if cheap_bank is not None:
            dt = self.fine.superglue.dtype or torch.float32
            obj = (self._gather(top_idx, cheap_bank).to(dt)
                   * self._gather(top_idx, cheap_scale).to(dt))
        else:
            obj = self._gather(top_idx, self.fine_bank_enc)
        ctr = self._gather(top_idx, self.fine_bank_centers)
        return self._cheap_order(obj, ctr, sims, hint_enc, prune_m,
                                 prune_layers, prune_sinkhorn, prune_soft,
                                 rerank_lambda, rerank_gamma)

    def _cheap_order(self, obj, ctr, sims, hint_enc, prune_m: int,
                     prune_layers: int, prune_sinkhorn: int,
                     prune_soft: bool, rerank_lambda: float,
                     rerank_gamma: float) -> torch.Tensor:
        """``_cheap_keep`` on the candidates' gathered encodings ``obj``
        [B, K, pad, E] and centres ``ctr`` [B, K, pad, 2]."""
        if prune_soft:
            B, K, pad = obj.shape[:3]
            out = self.fine.match_encoded(
                obj.flatten(0, 1), hint_enc.repeat_interleave(K, dim=0),
                prune_layers, prune_sinkhorn)
            conf, spread = soft_mass_and_spread(
                out["P"].reshape(B, K, pad + 1, -1), ctr,
                out["offsets"].reshape(B, K, -1, 2))
        else:
            *_, conf, spread = self._match_from_enc(
                obj, ctr, hint_enc, prune_layers, prune_sinkhorn)
        score = conf.float()
        if rerank_lambda:
            score = score + rerank_lambda * sims.float()
        if rerank_gamma:
            score = score - rerank_gamma * spread.float()
        return torch.sort(-score, dim=1, stable=True).indices[:, :prune_m]

    @torch.inference_mode()
    def serve_batch(self, tokens, lengths, hint_tokens, hint_lengths,
                    top_k: int, rerank_k: int = 0, rerank_lambda: float = 0.0,
                    rerank_gamma: float = 0.0, prune_m: int = 0,
                    prune_layers: int = 1, prune_sinkhorn: int = 10,
                    prune_soft: bool = False,
                    cheap_bank: Optional[torch.Tensor] = None,
                    cheap_scale: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, ...]:
        """Localize a batch of queries end to end.

        tokens [Q, T], lengths [Q], hint_tokens [Q, H, Th], hint_lengths
        [Q, H]. With ``rerank_k > top_k`` the fine stage scores
        ``rerank_k`` candidates and the ``top_k`` best by
        ``conf + λ·sim − γ·spread`` are returned (stable: coarse order
        breaks ties). With ``top_k < prune_m < rerank_k`` (the cascade;
        JAX skips it silently outside that range, and so does this) a
        cheap pass of ``prune_layers`` block pairs and ``prune_sinkhorn``
        Sinkhorn iterations scores all ``rerank_k`` first, on
        ``cheap_bank``/``cheap_scale`` (``quantize_fine_bank``) when given,
        and only the ``prune_m`` best get the full pass and the final
        re-rank. Returns (top_idx, pos_mean, pos_offsets, confidences),
        each [Q, top_k, ...], on the pipeline's device. Profiler ranges
        ``serve.encode``, ``serve.cheap_pass`` and ``serve.full_pass``
        (gather, matcher, positions) let a trace attribute the time.
        """
        tokens, lengths, hint_tokens, hint_lengths = (
            self._as_tensor(x) for x in (tokens, lengths, hint_tokens,
                                         hint_lengths))
        with record_function("serve.encode"):
            text_enc = self.coarse.encode_text(tokens, lengths)
            k_all = rerank_k if rerank_k > top_k else top_k
            sims, top_idx = topk_retrieval(text_enc, self.cell_enc, k_all)
            hint_enc = self.fine.encode_hints(hint_tokens, hint_lengths)
        if prune_m and top_k < prune_m < k_all:
            with record_function("serve.cheap_pass"):
                keep = self._cheap_keep(top_idx, sims, hint_enc, prune_m,
                                        prune_layers, prune_sinkhorn,
                                        prune_soft, cheap_bank, cheap_scale,
                                        rerank_lambda, rerank_gamma)
                top_idx, sims = _take(top_idx, keep), _take(sims, keep)
            rerank_k = prune_m
        with record_function("serve.full_pass"):
            pos_mean, pos_offsets, confidences, conf_scores, spreads = (
                self._match_from_enc(
                    self._gather(top_idx, self.fine_bank_enc),
                    self._gather(top_idx, self.fine_bank_centers),
                    hint_enc))
        return _compact_results(top_idx, pos_mean, pos_offsets, confidences,
                                conf_scores, top_k, rerank_k,
                                self.cell_enc.shape[0], sims=sims,
                                rerank_lambda=rerank_lambda, spreads=spreads,
                                rerank_gamma=rerank_gamma)

    def tokenize_queries(self, hint_lists: Sequence[Sequence[str]]
                         ) -> Tuple[np.ndarray, ...]:
        """Query text (hints joined) and per-hint tokens, as the JAX
        loaders build them: missing hints are all-pad with length 1."""
        cfg = self.cfg
        tokens, lengths = self.vocab.encode_batch(
            [" ".join(h) for h in hint_lists], cfg.max_text_len)
        return (tokens, lengths, *hint_arrays(
            self.fine_vocab, hint_lists, cfg.num_mentioned, cfg.max_hint_len))

    def localize(self, hint_lists: Sequence[Sequence[str]], top_k: int = 10,
                 **rerank) -> Dict[str, np.ndarray]:
        """Serve natural-language queries (one list of hint sentences
        each): cell indices [Q, top_k] and in-cell positions [Q, top_k, 2]."""
        top_idx, _, pos, conf = self.serve_batch(
            *self.tokenize_queries(hint_lists), top_k, **rerank)
        return {"top_idx": top_idx.cpu().numpy().astype(np.int64),
                "pos_in_cell": pos.float().cpu().numpy(),
                "confidences": conf.cpu().numpy()}

    # ------------------------------------------------------------------
    # Evaluation (JAX's run_coarse, run_fine and the oracles). The pipeline
    # is the checkpoints' (``build_pipeline_from_checkpoints``), its ``cfg``
    # an ``EvalConfig``; draws of the coarse tower come from the coarse
    # trainer's generators, the fine tower's from a generator seeded by
    # ``cfg.seed``, unless handed over.
    # ------------------------------------------------------------------
    def coarse_trainer(self) -> CoarseTrainer:
        """The coarse trainer's query and cell encode loops over this
        pipeline's coarse model: ``cfg.batch_size`` queries or cells a
        step, ``cfg.coarse_max_objects`` slots, ``cfg.pointnet_numpoints``
        points."""
        cfg = self.cfg
        tcfg = TrainConfig(
            batch_size=cfg.batch_size, embed_dim=self.coarse.embed_dim,
            pointnet_numpoints=cfg.pointnet_numpoints,
            coarse_max_objects=cfg.coarse_max_objects,
            no_pc_augment=cfg.no_pc_augment, seed=cfg.seed,
            device=self.device.type)
        return CoarseTrainer(tcfg, self.vocab, self.device, model=self.coarse)

    @torch.no_grad()
    def coarse_encodings(self, loader, cell_draws=None
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """(text [Q, E], cells [C, E]) of every query of ``loader`` and
        every cell of its bank; ``cell_draws`` as ``CoarseTrainer.
        encode_all_cells``'s ``draws``, or with a mesh as
        ``parallel.dp.dp_encode_all_cells``'s, which encodes the cells
        then."""
        trainer, state = self.coarse_trainer(), TrainState(self.coarse)
        text = trainer.encode_all_queries(state, loader)
        if self.mesh is not None:
            from text2pos_torch.parallel.dp import dp_encode_all_cells

            return text, dp_encode_all_cells(trainer, state, loader.bank,
                                             self.mesh, cell_draws)
        return text, trainer.encode_all_cells(state, loader.bank, cell_draws)

    def run_coarse(self, loader, poses, cell_draws=None
                   ) -> Tuple[np.ndarray, Dict]:
        """Retrieve ``max(top_k)`` cells a pose (``rerank`` when larger, for
        the fine stage to re-order), or the oracles' cells
        (``coarse_oracle``, ``coarse_random``, ``street_oracle``); coarse
        accuracy predicts the cells' centres. Returns (top_idx [Q, max_k],
        accuracies)."""
        cfg = self.cfg
        bank = loader.bank
        max_k = min(max(max(cfg.top_k), cfg.rerank), bank.num_cells)
        if cfg.coarse_oracle:
            top_idx = np.tile(loader.pose_cell_idx[:, None], (1, max_k))
        elif cfg.coarse_random:
            rng = np.random.default_rng(cfg.seed)
            top_idx = rng.integers(0, bank.num_cells, size=(len(poses), max_k))
        elif cfg.street_oracle:
            top_idx = self._street_oracle_retrieval(loader, poses, max_k,
                                                    cell_draws=cell_draws)
        else:
            text_enc, cell_enc = self.coarse_encodings(loader, cell_draws)
            _, top_idx = topk_retrieval(self._as_tensor(text_enc),
                                        self._as_tensor(cell_enc), max_k)
            top_idx = top_idx.cpu().numpy()
        accs = self._accuracies(poses, bank, top_idx,
                                np.full(top_idx.shape + (2,), 0.5))
        return top_idx, accs

    def _street_oracle_retrieval(self, loader, poses, max_k: int,
                                 street_centers=None, cell_draws=None
                                 ) -> np.ndarray:
        """The model's retrieval with every cell whose nearest street centre
        is not the pose's masked out, per scene. ``street_centers``: one
        array for every scene, a dict {scene: array}, or (None) the
        pickles ``{base_path}/street_centers/2013_05_28_drive_<scene>_
        sync.pkl``. Scores are numpy ``text @ cells.T`` ordered by numpy's
        default ``argsort``, as JAX orders them: where fewer than ``max_k``
        cells share the pose's street, the −inf tail is in its order."""
        from scipy.spatial.distance import cdist

        cfg = self.cfg
        bank = loader.bank
        pose_scenes = np.array([p.scene_name for p in poses])
        cell_scenes = np.array([cid.split("_")[0] for cid in bank.cell_ids])
        scenes = sorted(set(pose_scenes) | set(cell_scenes))
        if street_centers is None:
            import pickle

            street_centers = {}
            for scene in scenes:
                path = os.path.join(cfg.base_path, "street_centers",
                                    f"2013_05_28_drive_{scene}_sync.pkl")
                with open(path, "rb") as f:
                    street_centers[scene] = np.asarray(pickle.load(f))
        elif not isinstance(street_centers, dict):
            street_centers = {scene: np.asarray(street_centers)
                              for scene in scenes}
        text_enc, cell_enc = self.coarse_encodings(loader, cell_draws)

        cell_centers = 0.5 * (bank.bbox_w[:, 0:3] + bank.bbox_w[:, 3:6])
        pose_w = np.array([p.pose_w for p in poses])
        cell_street = np.full(bank.num_cells, -1, np.int64)
        pose_street = np.full(len(poses), -2, np.int64)
        for si, scene in enumerate(scenes):
            centers = street_centers[scene]
            cm = cell_scenes == scene
            if np.any(cm):
                cell_street[cm] = (np.argmin(cdist(cell_centers[cm], centers),
                                             axis=1) + si * 10_000)
            pm = pose_scenes == scene
            if np.any(pm):
                pose_street[pm] = (np.argmin(cdist(pose_w[pm], centers),
                                             axis=1) + si * 10_000)
        scores = text_enc @ cell_enc.T
        scores = np.where(cell_street[None, :] == pose_street[:, None],
                          scores, -np.inf)
        return np.argsort(-scores, axis=1)[:, :max_k]

    def _accuracies(self, poses, bank: CellBank, top_idx: np.ndarray,
                    pos_in_cells: np.ndarray,
                    top_k: Optional[Tuple[int, ...]] = None) -> Dict:
        pose_w = np.array([p.pose_w[0:2] for p in poses])
        pose_scenes = np.array([p.cell_id.split("_")[0] for p in poses])
        cell_scenes = np.array([cid.split("_")[0] for cid in bank.cell_ids])
        same_scene = cell_scenes[top_idx] == pose_scenes[:, None]
        return calc_accuracies(pose_w, bank.bbox_w[top_idx][..., 0:2],
                               bank.cell_size[top_idx], pos_in_cells,
                               same_scene, top_k or self.cfg.top_k,
                               self.cfg.threshs)

    @torch.no_grad()
    def precompute_fine_bank(self, bank: CellBank,
                             draws: Optional[Sequence[Draws]] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The fine object encodings of every cell of ``bank`` (``[C, pad,
        E]``, ``[C, pad, 2]``), ``DB_CHUNK`` cells a step
        (``encode_all_fine``): on the checkpoints' model each step on its
        own batch statistics, the last filled up with cell 0."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        return encode_all_fine(self.fine, bank_tensors(bank, self.device),
                               cfg.pad_size, gen, cfg.pointnet_numpoints,
                               draws, cfg.no_pc_augment)

    def _match_chunk_cached(self, fine_bank, top_idx, hint_tokens,
                            hint_lengths):
        """Fine matching of a chunk's queries against their candidates'
        encodings in ``fine_bank``: hints encoded once a query, then the
        GNN, Sinkhorn and offsets over the chunk's [B·K] pairs."""
        hint_enc = self.fine.encode_hints(hint_tokens, hint_lengths)
        return self._match_from_enc(self._gather(top_idx, fine_bank[0]),
                                    self._gather(top_idx, fine_bank[1]),
                                    hint_enc)

    def _fine_chunk(self, bt, top_idx, hint_tokens, hint_lengths,
                    generator: Optional[torch.Generator] = None,
                    draws: Optional[Draws] = None):
        """The uncached path (the reference's execution pattern): every
        candidate cell re-encoded for its query, padding objects and
        resampling drawn (``draws``: ``(u, pad_pts)`` over the [B·K]
        cells), then the matcher's whole forward on the repeated hints."""
        cfg = self.cfg
        B, K = top_idx.shape
        u, pad_pts = draws if draws is not None else (None, None)
        xyz, rgb, centers, colors = fine_cell_points(
            bt, top_idx.reshape(-1), cfg.pad_size, generator, u, pad_pts,
            cfg.pointnet_numpoints, cfg.no_pc_augment)
        out = self.fine(hint_tokens.repeat_interleave(K, dim=0),
                        hint_lengths.repeat_interleave(K, dim=0), xyz, rgb,
                        centers, colors, train=False, **cell_ids(
                            self.fine.object_encoder, bt, top_idx.reshape(-1),
                            cfg.pad_size))
        return _match_results(out, centers[..., 0:2].reshape(
            B, K, cfg.pad_size, 2))

    @torch.no_grad()
    def run_fine(self, loader, poses, top_idx: np.ndarray, vocab: Vocabulary,
                 chunk: int = 8, use_cache: bool = True, fine_bank=None,
                 bank_draws: Optional[Sequence[Draws]] = None,
                 chunk_draws: Optional[Sequence[Draws]] = None
                 ) -> Tuple[Dict, Dict, Dict]:
        """Fine matching of every pose against its candidates ``top_idx``
        [Q, K], ``chunk`` queries at a time; the last chunk is padded with
        copies of its first row (on batch statistics they enter the
        statistics, as in JAX). With ``use_cache`` the candidates'
        encodings come from ``fine_bank`` (``precompute_fine_bank`` when
        None, ``bank_draws`` its draws); without, every chunk re-encodes
        its cells (``chunk_draws[c]``: chunk c's). With ``cfg.rerank`` the
        candidates are re-ordered by ``conf − rerank_gamma·spread``.
        Returns the accuracies of the mean and offsets positions and of
        the most-matched candidate (mean-conf, the first on ties)."""
        cfg = self.cfg
        bank = loader.bank
        Q, K = top_idx.shape
        hint_tokens, hint_lengths = hint_arrays(
            vocab, [create_hint_description(p) for p in poses],
            cfg.num_mentioned, cfg.max_hint_len)
        bt = bank_tensors(bank, self.device)
        if use_cache and fine_bank is None:
            fine_bank = self.precompute_fine_bank(bank, bank_draws)
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        parts = []
        for c, i in enumerate(range(0, Q, chunk)):
            sl = slice(i, min(i + chunk, Q))
            real = sl.stop - sl.start
            arrs = [top_idx[sl], hint_tokens[sl], hint_lengths[sl]]
            if real < chunk:
                arrs = [np.concatenate([a, a[:1].repeat(chunk - real, 0)])
                        for a in arrs]
            idx, tok, lng = (self._as_tensor(a) for a in arrs)
            if use_cache:
                res = self._match_chunk_cached(fine_bank, idx.long(), tok, lng)
            else:
                res = self._fine_chunk(
                    bt, idx.long(), tok, lng, gen,
                    None if chunk_draws is None else chunk_draws[c])
            parts.append([r[:real] for r in res])
        pos_mean, pos_offsets, confidences, conf_scores, spreads = (
            torch.cat(p).cpu().numpy() for p in zip(*parts))

        if cfg.rerank > 0 and K > 1:
            order = _rerank_order(conf_scores, spreads, cfg.rerank_gamma)
            rows = np.arange(Q)[:, None]
            top_idx = top_idx[rows, order]
            pos_mean = pos_mean[rows, order]
            pos_offsets = pos_offsets[rows, order]
            confidences = confidences[rows, order]

        accs_mean = self._accuracies(poses, bank, top_idx, pos_mean)
        accs_offsets = self._accuracies(poses, bank, top_idx, pos_offsets)
        conf_idx = np.argmax(confidences, axis=1)
        rows = np.arange(Q)
        accs_conf = self._accuracies(
            poses, bank, top_idx[rows, conf_idx][:, None],
            pos_mean[rows, conf_idx][:, None], top_k=(1,))
        return accs_mean, accs_offsets, accs_conf

    def run_fine_oracle(self, loader, poses, top_idx: np.ndarray,
                        random_oracle: bool = False) -> Dict:
        """Accuracies of perfect in-cell positions (the pose's own,
        clipped to each retrieved cell), or of uniform random ones drawn
        from ``default_rng(cfg.seed)``."""
        bank = loader.bank
        pose_w = np.array([p.pose_w[0:2] for p in poses])
        if random_oracle:
            rng = np.random.default_rng(self.cfg.seed)
            pos = rng.random(top_idx.shape + (2,))
        else:
            lo = bank.bbox_w[top_idx][..., 0:2]
            size = bank.cell_size[top_idx][..., None]
            pos = np.clip((pose_w[:, None, :] - lo) / size, 0, 1)
        return self._accuracies(poses, bank, top_idx, pos)


def encode_database(coarse: str, fine: str, db_cache: str, bank: CellBank,
                    dtype: Optional[str] = "bfloat16",
                    device: Union[str, torch.device] = "cuda", seed: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Offline DB encode from checkpoints: (cell_enc, fine_bank_enc,
    fine_bank_centers) of ``bank``, with the coarse checkpoint's BN
    statistics and the DB cache's calibrated fine ones."""
    return LocalizationPipeline.from_checkpoints(
        coarse, fine, db_cache, dtype, device).encode_database(bank, seed)


def _switch_fast_graph(fine: SuperGlueMatch) -> None:
    """The fine model's GNN in the module form JAX's switch asks for
    (``T2P_FAST_GRAPH=1``: the fast graph; read where JAX reads it, when a
    serving pipeline is calibrated or restored)."""
    on = fast_graph_requested()
    if fine.superglue.fast_graph != on:
        fine.superglue = with_fast_graph(fine.superglue, on)


def build_pipeline_from_checkpoints(cfg, path_coarse: str, path_fine: str,
                                    dtype: Optional[str] = None
                                    ) -> Tuple[LocalizationPipeline,
                                               Vocabulary, Vocabulary]:
    """Both stages restored from msgpack checkpoints into the evaluator's
    pipeline (JAX's ``build_pipeline_from_checkpoints``): no database, the
    fine model on batch statistics, ``cfg`` (an ``EvalConfig``) its
    configuration and its device; with ``cfg.data_parallel`` > 1 a mesh of
    that many shards on ``cfg.device`` (``parallel.dp.make_mesh``). The
    model bodies run in f32 unless ``dtype`` is given, as JAX builds them.
    Returns (pipeline, coarse vocabulary, fine vocabulary)."""
    pipe = LocalizationPipeline.from_checkpoints(
        path_coarse, path_fine, None, dtype or "float32", cfg.device,
        cfg=cfg)
    if getattr(cfg, "data_parallel", 1) > 1:
        from text2pos_torch.parallel.dp import make_mesh

        pipe.mesh = make_mesh(cfg.data_parallel, pipe.device)
    return pipe, pipe.vocab, pipe.fine_vocab


def main(argv: Optional[Sequence[str]] = None, draws: Optional[Dict] = None
         ) -> None:
    """``python -m text2pos_torch.evaluation.pipeline``: JAX's evaluation
    CLI (its flags, plus ``--dtype`` and ``--device``) on the split's
    scenes (``--dataset K360``: ``--base_path``'s val scene, or its test
    scenes with ``--use_test_set``): the coarse stage's accuracy table
    (with ``--plot_retrievals`` then retrieval examples under
    ``./plots/retrievals``, and no fine stage), then the fine stage's (mean, offsets and mean-conf
    positions, re-ranked with ``--rerank``) or the fine oracle's. ``draws``
    hands over the coarse cell steps' (``cells``) and the fine bank's
    (``bank``) resampling draws."""
    from text2pos_torch.config import (EvalConfig, check_eval_ported,
                                       parse_config)
    from text2pos_torch.data.loaders import CoarseLoader
    from text2pos_torch.evaluation.metrics import print_accuracies
    from text2pos_torch.utils.cli import load_split

    cfg = parse_config(EvalConfig, argv)
    check_eval_ported(cfg)
    resolve_device(cfg.device)
    draws = draws or {}
    cells, poses = load_split(cfg, "test" if cfg.use_test_set else "val")
    pipe, vocab, fine_vocab = build_pipeline_from_checkpoints(
        cfg, cfg.path_coarse, cfg.path_fine, cfg.dtype)
    loader = CoarseLoader(cells, poses, vocab, cfg.batch_size,
                          cfg.coarse_max_objects, cfg.pointnet_numpoints,
                          cfg.max_text_len)

    top_idx, coarse_accs = pipe.run_coarse(loader, poses, draws.get("cells"))
    print_accuracies(coarse_accs, "Coarse")
    if cfg.plot_retrievals:
        # Success and failure examples, then stop (the reference's
        # pipeline.py:325-328).
        from text2pos_torch.utils.drawing import plot_retrievals, require_cv2

        cv2 = require_cv2()
        retrievals = [[loader.bank.cell_ids[ci] for ci in row]
                      for row in np.asarray(top_idx)]
        out_dir = "./plots/retrievals"
        os.makedirs(out_dir, exist_ok=True)
        for i, (ok, img) in enumerate(plot_retrievals(retrievals, cells,
                                                      poses)):
            cv2.imwrite(f"{out_dir}/{'success' if ok else 'fail'}_{i}.png",
                        img)
        print(f"wrote retrieval examples to {out_dir}")
        return
    if cfg.coarse_only:
        return
    if cfg.fine_oracle or cfg.fine_random:
        accs = pipe.run_fine_oracle(loader, poses, top_idx,
                                    random_oracle=cfg.fine_random)
        print_accuracies(accs, "Fine (oracle)")
        return
    accs_mean, accs_offsets, accs_conf = pipe.run_fine(
        loader, poses, top_idx, fine_vocab, bank_draws=draws.get("bank"))
    tag = f", reranked@{cfg.rerank}" if cfg.rerank > 0 else ""
    print_accuracies(accs_mean, f"Fine (mean{tag})")
    print_accuracies(accs_offsets, f"Fine (offsets{tag})")
    print_accuracies(accs_conf, f"Fine (mean-conf{tag})")


if __name__ == "__main__":
    main()
