"""Coarse cell-retrieval network (counterpart of
``text2pos_tpu/models/cell_retrieval.py``): the text tower (``encode_text``,
used by serving) and the object tower (``encode_objects``, used by the
offline DB encode): per-object ``ObjectEncoder`` embeddings, L2-normalized,
scattered into [cells, max_objects, E], an ``EdgeConv`` over each cell's
kNN graph (k=8), a masked pool over the cell's objects, ``lin`` and an L2
norm. ``variation=0`` (the bench checkpoint's) aggregates the edges and
pools the objects by their max, ``variation=1`` by their mean. The object
encoder's options (``use_features``, ``class_embed``, ``color_embed``,
``pointnet_features``) are ``ObjectEncoder``'s; ``class_idx`` and
``color_idx`` [F] reach it for the id-embedding variants.

``forward(..., train=True)`` runs both towers in train mode
(``blocks.train_mode``: batch statistics with running updates), as JAX's
``__call__`` does for a training step; ``train=False`` is the eval form.
The object tower takes the valid objects only (JAX's flat buffer less its
padding tail, which JAX masks out of every statistic), so no mask reaches
the object encoder; EdgeConv's BNs count the valid edges. ``remat`` (JAX's
flag) recomputes the object encoder's PointNet++, which holds nearly all
of its activations, in the backward pass, a level at a time
(``PointNet2.remat``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from text2pos_torch.models.blocks import MLP, l2_normalize, train_mode
from text2pos_torch.models.language import LanguageEncoder
from text2pos_torch.models.object_encoder import FEATURES, ObjectEncoder
from text2pos_torch.ops.neighbors import masked_knn
from text2pos_torch.ops.pooling import (gather_neighbors, masked_max,
                                        masked_mean)


class EdgeConv(nn.Module):
    """DynamicEdgeConv: MLP([x_i, x_j − x_i]) over the k nearest valid
    objects (self included), max (``aggr="max"``) or mean over the valid
    edges."""

    def __init__(self, embed_dim: int, k: int = 8,
                 dtype: Optional[torch.dtype] = None, aggr: str = "max"):
        super().__init__()
        self.k = k
        self.pool = {"max": masked_max, "mean": masked_mean}[aggr]
        self.edge_mlp = MLP(2 * embed_dim, (embed_dim, embed_dim), dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x [B, O, E] f32, mask [B, O] → [B, O, E] (compute dtype)."""
        idx, edge_valid = masked_knn(x, mask, self.k)
        x_j = gather_neighbors(x, idx)
        x_i = x[:, :, None, :].expand_as(x_j)
        h = self.edge_mlp(torch.cat([x_i, x_j - x_i], dim=-1),
                          mask=edge_valid)
        return self.pool(h, edge_valid[..., None], dim=2)


class CellRetrievalNetwork(nn.Module):
    """``dtype`` is the object tower's compute dtype (the text tower is
    always f32); ``pointnet_heads`` as ``ObjectEncoder``'s."""

    def __init__(self, vocab_size: int, embed_dim: int,
                 dtype: Optional[torch.dtype] = None,
                 pointnet_heads: Optional[Tuple[int, int]] = None,
                 remat: bool = False, variation: int = 0,
                 use_features: Sequence[str] = FEATURES,
                 class_embed: bool = False, color_embed: bool = False,
                 pointnet_features: int = 2):
        super().__init__()
        if variation not in (0, 1):
            raise ValueError(f"variation {variation}: 0 or 1")
        self.embed_dim, self.variation = embed_dim, variation
        self.language_encoder = LanguageEncoder(vocab_size, embed_dim)
        self.object_encoder = ObjectEncoder(
            embed_dim, dtype, pointnet_heads, use_features, class_embed,
            color_embed, pointnet_features)
        self.graph1 = EdgeConv(embed_dim, dtype=dtype,
                               aggr=("max", "mean")[variation])
        self.lin = MLP(embed_dim, (embed_dim, embed_dim), dtype)
        self.remat = remat

    @property
    def remat(self) -> bool:
        return self.object_encoder.remat

    @remat.setter
    def remat(self, on: bool) -> None:
        self.object_encoder.remat = on

    def encode_text(self, tokens: torch.Tensor, lengths: torch.Tensor
                    ) -> torch.Tensor:
        """[B, T] tokens → [B, E] L2-normalized text embeddings."""
        return l2_normalize(self.language_encoder(tokens, lengths))

    def encode_objects(self, points_xyz, points_rgb, centers, colors,
                       cell_idx: torch.Tensor, slot_idx: torch.Tensor,
                       num_cells: int, max_objects: int,
                       class_idx: Optional[torch.Tensor] = None,
                       color_idx: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        """Flat valid objects [F, ...] of ``num_cells`` cells, object f in
        slot ``slot_idx[f]`` of cell ``cell_idx[f]`` → [num_cells, E]
        L2-normalized cell embeddings."""
        emb = l2_normalize(self.object_encoder(points_xyz, points_rgb,
                                               centers, colors, class_idx,
                                               color_idx))
        dense = emb.new_zeros(num_cells, max_objects, self.embed_dim)
        dense[cell_idx, slot_idx] = emb
        mask = torch.zeros(num_cells, max_objects, dtype=torch.bool,
                           device=emb.device)
        # A device value: an element set from a Python number is a host
        # copy that the host waits for.
        mask[cell_idx, slot_idx] = mask.new_ones(())
        x = self.graph1(dense, mask)
        pooled = self.graph1.pool(x, mask[..., None], dim=1)
        return l2_normalize(self.lin(pooled).float())

    def forward(self, tokens: torch.Tensor, lengths: torch.Tensor,
                points_xyz, points_rgb, centers, colors,
                cell_idx: torch.Tensor, slot_idx: torch.Tensor,
                num_cells: int, max_objects: int, train: bool = True,
                class_idx: Optional[torch.Tensor] = None,
                color_idx: Optional[torch.Tensor] = None):
        """Both towers: (text [B, E], cells [num_cells, E]), each
        L2-normalized; in train mode with ``train``."""
        with train_mode(self, train):
            text = self.encode_text(tokens, lengths)
            cells = self.encode_objects(points_xyz, points_rgb, centers,
                                        colors, cell_idx, slot_idx,
                                        num_cells, max_objects, class_idx,
                                        color_idx)
        return text, cells
