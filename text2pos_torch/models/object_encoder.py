"""Object encoder (counterpart of ``text2pos_tpu/models/object_encoder.py``).

``use_features`` selects, in this order, "class" (PointNet++ features
through ``mlp_pointnet``, or with ``class_embed`` a class-id embedding whose
row is zeroed where ``class_idx == 0``), "color" (the mean colour through
``color_encoder``, or with ``color_embed`` a colour-id embedding) and
"position" (the object centre through ``pos_encoder``). Each is
L2-normalized; two or more are concatenated and fused by ``mlp_merge``, a
single one is the output. ``pointnet_features`` picks PointNet++'s
``features0`` [1024], ``features1`` [512] or ``features2`` [256] for
``mlp_pointnet``. Without "color" the point colours fed to PointNet++ are
zeroed. PointNet++ runs whenever ``class_embed`` is off, as in JAX, whose
training and calibration update its statistics even where "class" is not
among the features. The bench checkpoints use the defaults. On batch
statistics (``blocks.set_eval_batch_stats``) its BNs take them over all
objects: the fine model passes no validity mask.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from text2pos_torch.data.dense import NUM_CLASS_INDICES, NUM_COLOR_INDICES
from text2pos_torch.models.blocks import MLP, l2_normalize
from text2pos_torch.models.pointnet2 import PointNet2

FEATURES = ("class", "color", "position")
ID_KEYS = ("class_idx", "color_idx")    # the objects' ids, where a batch has them


class ObjectEncoder(nn.Module):
    """``pointnet_heads``: (classes, colours) of PointNet's unread heads,
    built for a trainer (``PointNet2(heads=...)``); the other options as
    the module docstring says."""

    def __init__(self, embed_dim: int, dtype: Optional[torch.dtype] = None,
                 pointnet_heads: Optional[Tuple[int, int]] = None,
                 use_features: Sequence[str] = FEATURES,
                 class_embed: bool = False, color_embed: bool = False,
                 pointnet_features: int = 2):
        super().__init__()
        if pointnet_features not in (0, 1, 2):
            raise ValueError(f"pointnet_features {pointnet_features}: 0, 1 "
                             "or 2")
        self.use_features = tuple(f for f in FEATURES if f in use_features)
        if not self.use_features:
            raise ValueError(f"use_features {tuple(use_features)} names none "
                             f"of {FEATURES}")
        self.class_embed, self.color_embed = class_embed, color_embed
        self.pointnet_features = pointnet_features
        if not class_embed:
            self.pointnet = PointNet2(dtype, heads=pointnet_heads)
            pnet = self.pointnet
            width = (pnet.lin1.in_features, pnet.lin1.out_features,
                     pnet.lin2.out_features)[pointnet_features]
            self.mlp_pointnet = MLP(width, (embed_dim,), dtype)
        if "class" in self.use_features and class_embed:
            self.class_embedding = nn.Embedding(NUM_CLASS_INDICES, embed_dim)
        if "color" in self.use_features:
            if color_embed:
                self.color_embedding = nn.Embedding(NUM_COLOR_INDICES,
                                                    embed_dim)
            else:
                self.color_encoder = MLP(3, (64, embed_dim), dtype)
        if "position" in self.use_features:
            self.pos_encoder = MLP(3, (64, embed_dim), dtype)
        if len(self.use_features) > 1:
            self.mlp_merge = MLP(len(self.use_features) * embed_dim,
                                 (embed_dim,), dtype)

    @property
    def remat(self) -> bool:
        """PointNet++'s ``remat`` (False without PointNet++)."""
        return hasattr(self, "pointnet") and self.pointnet.remat

    @remat.setter
    def remat(self, on: bool) -> None:
        if hasattr(self, "pointnet"):
            self.pointnet.remat = on

    @property
    def needs_ids(self) -> bool:
        """Whether ``forward`` reads ``class_idx`` / ``color_idx``."""
        return self.class_embed and "class" in self.use_features or \
            self.color_embed and "color" in self.use_features

    def forward(self, points_xyz: torch.Tensor, points_rgb: torch.Tensor,
                centers: torch.Tensor, colors: torch.Tensor,
                class_idx: Optional[torch.Tensor] = None,
                color_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """points_xyz, points_rgb [F, P, 3] (resampled, normalize-scaled),
        centers [F, 3], colors [F, 3], class_idx and color_idx [F] (read by
        the embedding variants only) → [F, E] f32 (not normalized)."""
        if self.needs_ids and (class_idx is None or color_idx is None):
            raise ValueError("this object encoder embeds class or colour ids: "
                             "pass class_idx and color_idx")
        features = []
        if not self.class_embed:
            rgb = (points_rgb if "color" in self.use_features
                   else torch.zeros_like(points_rgb))
            pn = self.mlp_pointnet(self.pointnet(points_xyz, rgb,
                                                 self.pointnet_features))
        if "class" in self.use_features:
            if self.class_embed:
                emb = self.class_embedding(class_idx.long())
                features.append(l2_normalize(
                    emb * (class_idx != 0)[..., None].to(emb.dtype)))
            else:
                features.append(l2_normalize(pn))
        if "color" in self.use_features:
            features.append(l2_normalize(
                self.color_embedding(color_idx.long()) if self.color_embed
                else self.color_encoder(colors)))
        if "position" in self.use_features:
            features.append(l2_normalize(self.pos_encoder(centers)))
        if len(features) == 1:
            return features[0].float()
        return self.mlp_merge(torch.cat(features, dim=-1)).float()
