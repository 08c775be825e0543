"""Calibrated serving: text query → cell and in-cell position (counterpart of
``text2pos_tpu/evaluation/pipeline.py``, ``serve_batch`` and its helpers).

Stages of ``serve_batch``: text encode (LSTM kernel) → top-k retrieval over
the precomputed cell embeddings → hint encode (LSTM kernel) → gather from
the fine bank → the fused GNN kernel → Sinkhorn kernel and match
extraction → offset head and in-cell positions → optional stable re-rank.
The cascade (``prune_m``, the int8 cheap bank, ``prune_soft``) is not
ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from text2pos_torch.config import ServeConfig
from text2pos_torch.data.hints import Vocabulary
from text2pos_torch.device import resolve_device
from text2pos_torch.models.cell_retrieval import CellRetrievalNetwork
from text2pos_torch.models.matcher import SuperGlueMatch, get_pos_in_cell
from text2pos_torch.ops.retrieval import topk_retrieval
from text2pos_torch.train.state import load_checkpoint
from text2pos_torch.utils.convert_jax import load_jax_params
from text2pos_torch.utils.msgpack_io import msgpack_restore

_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}


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
    """Coarse retriever + fine matcher + the serving-resident DB tensors."""

    def __init__(self, coarse: CellRetrievalNetwork, fine: SuperGlueMatch,
                 vocab: Vocabulary, fine_vocab: Vocabulary,
                 cell_enc: torch.Tensor, fine_bank_enc: torch.Tensor,
                 fine_bank_centers: torch.Tensor,
                 cfg: ServeConfig = ServeConfig()):
        self.coarse, self.fine = coarse.eval(), fine.eval()
        self.vocab, self.fine_vocab, self.cfg = vocab, fine_vocab, cfg
        self.cell_enc = cell_enc
        self.fine_bank_enc = fine_bank_enc
        self.fine_bank_centers = fine_bank_centers
        self.device = cell_enc.device

    @classmethod
    def from_checkpoints(cls, coarse: str, fine: str, db_cache: str,
                         dtype: Optional[str] = "bfloat16",
                         device: Union[str, torch.device] = "cuda",
                         cfg: ServeConfig = ServeConfig()
                         ) -> "LocalizationPipeline":
        """Restore both stages from flax msgpack checkpoints and the
        calibrated DB cache (``cell_enc``, ``fine_bank_enc``,
        ``fine_bank_centers`` and the ``bn_stat_groups=2`` ``batch_stats``).
        ``dtype`` is the fine model bodies' compute dtype."""
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

        coarse_model = CellRetrievalNetwork(vocab_rows(cp["params"]),
                                            cx.get("embed_dim", 256))
        load_jax_params(coarse_model, cp["params"], cp["batch_stats"])
        with np.load(db_cache) as z:
            cell_enc = z["cell_enc"].astype(np.float32)
            fb_enc = z["fine_bank_enc"].astype(np.float32)
            fb_ctr = z["fine_bank_centers"].astype(np.float32)
            stats = msgpack_restore(z["batch_stats"].tobytes())
        if fb_enc.shape[1] != cfg.pad_size or fb_ctr.shape[1] != cfg.pad_size:
            raise ValueError(f"{db_cache}: fine bank holds {fb_enc.shape[1]} "
                             f"objects per cell, the matcher {cfg.pad_size}")
        fine_model = SuperGlueMatch(
            vocab_rows(fp["params"]), fx.get("embed_dim", 128),
            num_layers=fx.get("num_layers", 6),
            sinkhorn_iters=fx.get("sinkhorn_iters", 50),
            dtype=_DTYPES[dtype], stat_groups=2)
        load_jax_params(fine_model, fp["params"], stats)

        def t(a):
            return torch.from_numpy(a).to(dev)

        return cls(coarse_model.to(dev), fine_model.to(dev), vocab,
                   fine_vocab, t(cell_enc), t(fb_enc), t(fb_ctr), cfg)

    def _as_tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device)

    def _match_from_enc(self, obj_enc, centers_xy, hint_enc):
        """Matcher core: obj_enc [B, K, pad, E], centers_xy [B, K, pad, 2],
        hint_enc [B, H, E]."""
        B, K, pad = obj_enc.shape[:3]
        H = hint_enc.shape[1]
        out = self.fine.match_encoded(obj_enc.flatten(0, 1),
                                      hint_enc.repeat_interleave(K, dim=0))
        matches0 = out["matches0"].reshape(B, K, pad)
        mscores0 = out["matching_scores0"].reshape(B, K, pad)
        offsets = out["offsets"].reshape(B, K, H, 2)
        pos_mean = get_pos_in_cell(centers_xy, matches0,
                                   torch.zeros_like(offsets))
        pos_offsets = get_pos_in_cell(centers_xy, matches0, offsets)
        confidences = (matches0 >= 0).sum(2)
        conf_scores = _match_confidence_scores(matches0, mscores0)
        spreads = _match_vote_spread(out["matches1"].reshape(B, K, H),
                                     offsets, centers_xy)
        return pos_mean, pos_offsets, confidences, conf_scores, spreads

    @torch.inference_mode()
    def serve_batch(self, tokens, lengths, hint_tokens, hint_lengths,
                    top_k: int, rerank_k: int = 0, rerank_lambda: float = 0.0,
                    rerank_gamma: float = 0.0) -> Tuple[torch.Tensor, ...]:
        """Localize a batch of queries end to end.

        tokens [Q, T], lengths [Q], hint_tokens [Q, H, Th], hint_lengths
        [Q, H]. With ``rerank_k > top_k`` the fine stage scores
        ``rerank_k`` candidates and the ``top_k`` best by
        ``conf + λ·sim − γ·spread`` are returned (stable: coarse order
        breaks ties). Returns (top_idx, pos_mean, pos_offsets, confidences),
        each [Q, top_k, ...], on the pipeline's device.
        """
        tokens, lengths, hint_tokens, hint_lengths = (
            self._as_tensor(x) for x in (tokens, lengths, hint_tokens,
                                         hint_lengths))
        text_enc = self.coarse.encode_text(tokens, lengths)
        k_all = rerank_k if rerank_k > top_k else top_k
        sims, top_idx = topk_retrieval(text_enc, self.cell_enc, k_all)
        B = top_idx.shape[0]
        flat = top_idx.reshape(-1)
        obj_enc = self.fine_bank_enc[flat].reshape(
            B, k_all, *self.fine_bank_enc.shape[1:])
        centers_xy = self.fine_bank_centers[flat].reshape(
            B, k_all, *self.fine_bank_centers.shape[1:])
        hint_enc = self.fine.encode_hints(hint_tokens, hint_lengths)
        pos_mean, pos_offsets, confidences, conf_scores, spreads = (
            self._match_from_enc(obj_enc, centers_xy, hint_enc))
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
        Q, H = len(hint_lists), cfg.num_mentioned
        hint_tokens = np.zeros((Q, H, cfg.max_hint_len), np.int32)
        hint_lengths = np.ones((Q, H), np.int32)
        for i, hints in enumerate(hint_lists):
            if hints:
                tk, ln = self.fine_vocab.encode_batch(list(hints)[:H],
                                                      cfg.max_hint_len)
                hint_tokens[i, :len(tk)] = tk
                hint_lengths[i, :len(ln)] = ln
        return tokens, lengths, hint_tokens, hint_lengths

    def localize(self, hint_lists: Sequence[Sequence[str]], top_k: int = 10,
                 **rerank) -> Dict[str, np.ndarray]:
        """Serve natural-language queries (one list of hint sentences
        each): cell indices [Q, top_k] and in-cell positions [Q, top_k, 2]."""
        top_idx, _, pos, conf = self.serve_batch(
            *self.tokenize_queries(hint_lists), top_k, **rerank)
        return {"top_idx": top_idx.cpu().numpy().astype(np.int64),
                "pos_in_cell": pos.float().cpu().numpy(),
                "confidences": conf.cpu().numpy()}
