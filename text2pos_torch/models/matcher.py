"""Fine hints-to-objects matcher (counterpart of
``text2pos_tpu/models/matcher.py``): ``SuperGlueMatch`` for inference (hint
encoding, matching against pre-encoded cell objects, the offset head, and
the object encoder that the offline DB encode runs: ``encode_cell_objects``)
and ``get_pos_in_cell``. Serving reads the object encodings from the fine
bank. ``eval_batch_stats`` is JAX's flag of the same name: every BN of the
object encoder and the GNN normalizes by its batch's statistics (the
uncalibrated model); ``blocks.set_eval_batch_stats`` switches it, as
calibrated serving does.

``forward(..., train=True)`` is the training forward of JAX's
``SuperGlueMatch.__call__``: hints and cell objects encoded, the GNN on
batch statistics with running updates (``blocks.train_mode``), Sinkhorn
through its autograd Function, the offset head; ``train=False`` the same
without updates, as the fine trainer's eval step runs it (the trainer's
model has ``eval_batch_stats``, ``stat_groups=1``: the checkpoints' flat
statistics). ``forward_rank`` adds the transport of each query's hints
against R other cells of the batch, for the rank-aware loss. ``remat``
(JAX's flag) recomputes the object encoder's PointNet++ in the backward
pass, a level at a time (``PointNet2.remat``). The object encoder's options
(``use_features``, ``class_embed``, ``color_embed``, ``pointnet_features``)
are ``ObjectEncoder``'s; ``class_idx`` and ``color_idx`` [B, O] reach it for
the id-embedding variants. ``get_pos_in_cell_intersect`` is the
least-squares intersection of matched direction rays, which the offsets
trainer's evaluation uses."""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from text2pos_torch.models.blocks import (HeadMLP, l2_normalize,
                                         set_eval_batch_stats, train_mode)
from text2pos_torch.models.language import LanguageEncoder
from text2pos_torch.models.object_encoder import FEATURES, ObjectEncoder
from text2pos_torch.models.superglue import SuperGlue


class SuperGlueMatch(nn.Module):
    def __init__(self, vocab_size: int, embed_dim: int, num_layers: int = 6,
                 sinkhorn_iters: int = 50, match_threshold: float = 0.2,
                 dtype: Optional[torch.dtype] = None, stat_groups: int = 2,
                 eval_batch_stats: bool = False,
                 pointnet_heads: Optional[Tuple[int, int]] = None,
                 remat: bool = False, use_features: Sequence[str] = FEATURES,
                 class_embed: bool = False, color_embed: bool = False,
                 pointnet_features: int = 2):
        super().__init__()
        self.embed_dim = embed_dim
        self.language_encoder = LanguageEncoder(vocab_size, embed_dim)
        self.object_encoder = ObjectEncoder(
            embed_dim, dtype, pointnet_heads, use_features, class_embed,
            color_embed, pointnet_features)
        self.superglue = SuperGlue(embed_dim, num_layers, sinkhorn_iters,
                                   match_threshold, dtype, stat_groups)
        self.mlp_offsets = HeadMLP(embed_dim, (embed_dim // 2, 2))
        set_eval_batch_stats(self, eval_batch_stats)
        self.remat = remat

    @property
    def remat(self) -> bool:
        return self.object_encoder.remat

    @remat.setter
    def remat(self, on: bool) -> None:
        self.object_encoder.remat = on

    def encode_hints(self, hint_tokens: torch.Tensor,
                     hint_lengths: torch.Tensor) -> torch.Tensor:
        """[B, H, T] tokens → [B, H, E] L2-normalized hint encodings."""
        B, H, T = hint_tokens.shape
        enc = self.language_encoder(hint_tokens.reshape(B * H, T),
                                    hint_lengths.reshape(B * H))
        return l2_normalize(enc.reshape(B, H, self.embed_dim))

    def encode_cell_objects(self, points_xyz, points_rgb, centers, colors,
                            class_idx: Optional[torch.Tensor] = None,
                            color_idx: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
        """[B, O, ...] padded cell objects (every slot a real or padding
        object; ``class_idx``, ``color_idx`` [B, O] for the id-embedding
        variants) → [B, O, E] L2-normalized encodings, f32."""
        B, O, P, _ = points_xyz.shape
        flat = lambda t: None if t is None else t.reshape(B * O)
        enc = self.object_encoder(points_xyz.reshape(B * O, P, 3),
                                  points_rgb.reshape(B * O, P, 3),
                                  centers.reshape(B * O, 3),
                                  colors.reshape(B * O, 3), flat(class_idx),
                                  flat(color_idx))
        return l2_normalize(enc.reshape(B, O, self.embed_dim))

    def match_encoded(self, obj_enc: torch.Tensor, hint_enc: torch.Tensor,
                      num_layers: Optional[int] = None,
                      sinkhorn_iterations: Optional[int] = None
                      ) -> Dict[str, torch.Tensor]:
        """GNN + Sinkhorn + offset head on encodings: obj_enc [B, O, E],
        hint_enc [B, H, E]; the depth cut as in ``SuperGlue.forward``."""
        out = self.superglue(obj_enc, hint_enc, num_layers,
                             sinkhorn_iterations)
        out["offsets"] = self.mlp_offsets(hint_enc)      # [B, H, 2]
        return out

    def forward(self, hint_tokens: torch.Tensor, hint_lengths: torch.Tensor,
                points_xyz, points_rgb, centers, colors, train: bool = True,
                class_idx: Optional[torch.Tensor] = None,
                color_idx: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """[B, H, T] hints against [B, O, ...] cell objects → P, log_P,
        matches0/1, matching_scores0/1 and offsets; in train mode with
        ``train``."""
        with train_mode(self, train):
            hint_enc = self.encode_hints(hint_tokens, hint_lengths)
            obj_enc = self.encode_cell_objects(points_xyz, points_rgb,
                                               centers, colors, class_idx,
                                               color_idx)
            return self.match_encoded(obj_enc, hint_enc)

    def forward_rank(self, hint_tokens: torch.Tensor,
                     hint_lengths: torch.Tensor, points_xyz, points_rgb,
                     centers, colors, num_negs: int, train: bool = True,
                     class_idx: Optional[torch.Tensor] = None,
                     color_idx: Optional[torch.Tensor] = None
                     ) -> Dict[str, torch.Tensor]:
        """``forward``'s outputs plus ``neg_P`` [R, B, M+1, N+1]: each
        query's hints matched against the objects of the cell r places
        before it in the batch (``roll(obj_enc, r)``, r = 1..R). The
        encoders run once; the R negative passes run before the true
        pairs' pass, each one momentum update of the GNN's BN statistics
        in train mode, so that they end on the true pairs, as in JAX."""
        with train_mode(self, train):
            hint_enc = self.encode_hints(hint_tokens, hint_lengths)
            obj_enc = self.encode_cell_objects(points_xyz, points_rgb,
                                               centers, colors, class_idx,
                                               color_idx)
            neg_P = [self.superglue(torch.roll(obj_enc, r, 0), hint_enc)["P"]
                     for r in range(1, num_negs + 1)]
            out = self.match_encoded(obj_enc, hint_enc)
        out["neg_P"] = (torch.stack(neg_P) if neg_P
                        else out["P"].new_zeros((0,) + out["P"].shape))
        return out


def get_pos_in_cell(centers: torch.Tensor, matches0: torch.Tensor,
                    offsets: torch.Tensor) -> torch.Tensor:
    """Mean of matched objects' center + matched hint's offset, [..., 2];
    (0.5, 0.5) when nothing matched.

    centers [..., O, 2], matches0 [..., O] (-1 unmatched), offsets [..., H, 2].
    """
    valid = matches0 >= 0
    safe = matches0.clamp_min(0)[..., None].expand(*matches0.shape, 2)
    preds = centers + torch.gather(offsets, -2, safe)
    vf = valid[..., None].to(preds.dtype)
    total = (preds * vf).sum(-2)
    count = vf.sum(-2)
    mean = total / count.clamp_min(1.0)
    return torch.where(count > 0, mean, torch.full_like(mean, 0.5))


def get_pos_in_cell_intersect(centers: torch.Tensor, matches0: torch.Tensor,
                              directions: torch.Tensor) -> torch.Tensor:
    """Least-squares intersection of the matched objects' rays (centre,
    matched hint's unit direction): the point p minimizing Σ‖(I − n nᵀ)(p
    − c)‖², from the 2x2 normal equations regularized by 1e-6·I; (0.5,
    0.5) where fewer than two objects matched. A hint index past the
    last hint reads NaN, as JAX's gather fills it.

    centers [..., O, 2], matches0 [..., O] (-1 unmatched), directions
    [..., H, 2] → [..., 2].
    """
    dirs = directions / torch.linalg.vector_norm(
        directions, dim=-1, keepdim=True).clamp_min(1e-12)
    valid = matches0 >= 0
    H = dirs.shape[-2]
    past = (matches0 >= H)[..., None]
    safe = matches0.long().clamp(0, H - 1)[..., None].expand(
        *matches0.shape, 2)
    n = torch.gather(dirs, -2, safe)                             # [..., O, 2]
    n = torch.where(past, torch.full_like(n, math.nan), n)
    eye = torch.eye(2, dtype=centers.dtype, device=centers.device)
    projs = eye - n[..., :, None] * n[..., None, :]              # [..., O, 2, 2]
    vf = valid[..., None, None].to(centers.dtype)
    R = (projs * vf).sum(-3) + 1e-6 * eye
    q = (torch.einsum("...oij,...oj->...oi", projs, centers)
         * vf[..., 0]).sum(-2)
    # LU with partial pivoting, as jnp.linalg.solve; no error check (a
    # synchronization on the card).
    p = torch.linalg.solve_ex(R, q[..., None])[0][..., 0]
    count = valid.sum(-1, keepdim=True)
    return torch.where(count >= 2, p, torch.full_like(p, 0.5))
