"""Building blocks (counterpart of ``text2pos_tpu/models/blocks.py``), eval
mode only.

Module and attribute names follow the flax parameter tree (``dense_0``,
``bn_0``, …) so that ``utils/convert_jax.py`` maps a checkpoint by name.
``dense`` applies a flax ``nn.Dense(dtype=...)`` the way XLA compiles it,
which keeps f32 between matmuls ("excess precision"): callers round to the
compute dtype only where XLA stores a value (a matmul's input, a module's
output).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12
                 ) -> torch.Tensor:
    """``x / max(||x||, eps)`` (torch ``F.normalize``). In bf16 the sum of
    squares and the norm are each rounded to bf16, as the JAX package's
    compiled ``l2_normalize`` stores them."""
    if x.dtype != torch.bfloat16:
        return x / torch.linalg.vector_norm(x, dim=dim,
                                            keepdim=True).clamp_min(eps)
    sq = (x.float() * x.float()).sum(dim, keepdim=True).to(x.dtype)
    norm = torch.sqrt(sq.float()).to(x.dtype).float()
    return (x.float() / norm.clamp_min(eps)).to(x.dtype)


def dense(layer: nn.Linear, x: torch.Tensor,
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``nn.Dense(dtype)`` as XLA's CPU backend runs it, returned in f32:
    input and kernel in ``dtype`` (f32 when None), the product rounded to
    ``dtype``, the bias (in ``dtype``) added in f32. XLA fuses the bias add
    into the elementwise ops that follow (BN, ReLU, a residual add) and
    computes that chain in f32, rounding only where a value is stored.
    Measured on a bf16 set-abstraction level: 3e-5 of the outputs differ
    from the JAX package's by a bf16 step, against 0.19-0.41 when every
    flax op rounds."""
    dt = dtype or torch.float32
    y = nn.functional.linear(x.to(dt), layer.weight.to(dt)).float()
    return y + layer.bias.to(dt).float()


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


def bn_affine(bn: MaskedBatchNorm) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BN as ``x·scale + shift`` (f32): scale = γ/√(σ²+ε),
    shift = β − μ·scale."""
    scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    return scale, bn.bias - bn.running_mean * scale


class MLP(nn.Module):
    """``get_mlp``: (Dense → BN → ReLU) per layer, trailing ReLU included.
    Each chain of bias, BN and ReLU runs in f32 (``dense``); the output is
    stored in ``dtype`` (f32 when None)."""

    def __init__(self, in_features: int, channels: Sequence[int],
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.n = len(channels)
        for i, ch in enumerate(channels):
            self.add_module(f"dense_{i}", nn.Linear(in_features, ch))
            self.add_module(f"bn_{i}", MaskedBatchNorm(ch))
            in_features = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = dense(getattr(self, f"dense_{i}"), x, self.dtype)
            x = torch.relu(getattr(self, f"bn_{i}")(x))
        return x.to(self.dtype or torch.float32)


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
        return x.to(self.dtype or torch.float32)


class SuperGlueMLP(nn.Module):
    """Dense → BN → ReLU between layers only, bare final layer. The output
    stays f32: XLA fuses the final bias add into the residual add."""

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
