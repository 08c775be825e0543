"""Building blocks (counterpart of ``text2pos_tpu/models/blocks.py``), eval
mode only.

Module and attribute names follow the flax parameter tree (``dense_0``,
``bn_0``, …) so that ``utils/convert_jax.py`` maps a checkpoint by name.
``dense`` applies a linear layer in a compute dtype the way flax's
``nn.Dense(dtype=...)`` does: inputs, kernel and bias cast to that dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12
                 ) -> torch.Tensor:
    """``x / max(||x||, eps)`` (torch ``F.normalize``)."""
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)


def dense(layer: nn.Linear, x: torch.Tensor,
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Apply ``layer`` in ``dtype`` (None: the promoted input dtype)."""
    dt = dtype or torch.promote_types(x.dtype, layer.weight.dtype)
    return nn.functional.linear(x.to(dt), layer.weight.to(dt),
                                layer.bias.to(dt))


class MaskedBatchNorm(nn.Module):
    """Eval-mode BatchNorm over the last axis with ``stat_groups`` rows of
    running statistics; ``stat_group`` picks the row. Computed in f32,
    returned in the input dtype (eps 1e-5)."""

    def __init__(self, features: int, stat_groups: int = 1,
                 eps: float = 1e-5):
        super().__init__()
        self.stat_groups = stat_groups
        self.eps = eps
        shape = (features,) if stat_groups == 1 else (stat_groups, features)
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(shape))
        self.register_buffer("running_var", torch.ones(shape))

    def forward(self, x: torch.Tensor, stat_group: int = 0) -> torch.Tensor:
        mean, var = self.running_mean, self.running_var
        if self.stat_groups > 1:
            mean, var = mean[stat_group], var[stat_group]
        inv = 1.0 / torch.sqrt(var + self.eps)
        out = (x.float() - mean) * inv * self.weight + self.bias
        return out.to(x.dtype)


class HeadMLP(nn.Module):
    """Dense layers with ReLU between, bare final layer (offset head)."""

    def __init__(self, in_features: int, channels: Sequence[int],
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.n = len(channels)
        for i, ch in enumerate(channels):
            self.add_module(f"dense_{i}", nn.Linear(in_features, ch))
            in_features = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = dense(getattr(self, f"dense_{i}"), x, self.dtype)
            if i < self.n - 1:
                x = torch.relu(x)
        return x


class SuperGlueMLP(nn.Module):
    """Dense → BN → ReLU between layers only, bare final layer."""

    def __init__(self, in_features: int, channels: Sequence[int],
                 dtype: Optional[torch.dtype] = None, stat_groups: int = 1):
        super().__init__()
        self.dtype = dtype
        self.n = len(channels)
        for i, ch in enumerate(channels):
            self.add_module(f"dense_{i}", nn.Linear(in_features, ch))
            if i < self.n - 1:
                self.add_module(f"bn_{i}", MaskedBatchNorm(ch, stat_groups))
            in_features = ch

    def forward(self, x: torch.Tensor, stat_group: int = 0) -> torch.Tensor:
        for i in range(self.n):
            x = dense(getattr(self, f"dense_{i}"), x, self.dtype)
            if i < self.n - 1:
                x = torch.relu(getattr(self, f"bn_{i}")(x, stat_group))
        return x
