"""Masked pooling and neighbourhood gathers (counterpart of
``text2pos_tpu/ops/pooling.py``)."""

from __future__ import annotations

import torch

_NEG = -1e30


def masked_max(x: torch.Tensor, mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Max over ``dim`` of the masked-in entries (mask broadcastable to x);
    0 where none is valid."""
    mask = mask.expand_as(x)
    filled = torch.where(mask, x, torch.full((), _NEG, dtype=x.dtype,
                                             device=x.device))
    out = filled.amax(dim=dim)
    return torch.where(mask.any(dim=dim), out, torch.zeros_like(out))


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Mean over ``dim`` of the masked-in entries; 0 where none is valid."""
    maskf = mask.expand_as(x).to(x.dtype)
    total = (x * maskf).sum(dim)
    count = maskf.sum(dim)
    return torch.where(count > 0, total / count.clamp_min(1),
                       torch.zeros_like(total))


def gather_neighbors(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, C], idx [B, S, K] → [B, S, K, C]."""
    B, S, K = idx.shape
    flat = idx.reshape(B, S * K, 1).expand(B, S * K, x.shape[-1])
    return torch.gather(x, 1, flat).reshape(B, S, K, x.shape[-1])
