"""Object encoder in eval mode (counterpart of
``text2pos_tpu/models/object_encoder.py``): PointNet++ features through
``mlp_pointnet`` ("class"), the mean colour through ``color_encoder``
("color") and the object centre through ``pos_encoder`` ("position"), each
L2-normalized, concatenated and fused by ``mlp_merge``: the JAX model with
``use_features=FEATURES``, which both bench checkpoints use. On batch
statistics (``blocks.set_eval_batch_stats``) its BNs take them over all
objects: the fine model passes no validity mask. Other feature
subsets and the class/colour-id embedding variants (``class_embed``,
``color_embed``) are not ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from text2pos_torch.models.blocks import MLP, l2_normalize
from text2pos_torch.models.pointnet2 import PointNet2

FEATURES = ("class", "color", "position")


class ObjectEncoder(nn.Module):
    """``pointnet_heads``: (classes, colours) of PointNet's unread heads,
    built for a trainer (``PointNet2(heads=...)``)."""

    def __init__(self, embed_dim: int, dtype: Optional[torch.dtype] = None,
                 pointnet_heads: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.pointnet = PointNet2(dtype, heads=pointnet_heads)
        self.mlp_pointnet = MLP(self.pointnet.lin2.out_features,
                                (embed_dim,), dtype)
        self.color_encoder = MLP(3, (64, embed_dim), dtype)
        self.pos_encoder = MLP(3, (64, embed_dim), dtype)
        self.mlp_merge = MLP(len(FEATURES) * embed_dim, (embed_dim,), dtype)

    def forward(self, points_xyz: torch.Tensor, points_rgb: torch.Tensor,
                centers: torch.Tensor, colors: torch.Tensor) -> torch.Tensor:
        """points_xyz, points_rgb [F, P, 3] (resampled, normalize-scaled),
        centers [F, 3], colors [F, 3] → [F, E] f32 (not normalized)."""
        pn = self.mlp_pointnet(self.pointnet(points_xyz, points_rgb))
        features = [l2_normalize(pn), l2_normalize(self.color_encoder(colors)),
                    l2_normalize(self.pos_encoder(centers))]
        return self.mlp_merge(torch.cat(features, dim=-1)).float()
