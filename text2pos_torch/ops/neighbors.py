"""Dense neighbour search (counterpart of ``text2pos_tpu/ops/neighbors.py``).

``pairwise_sqdist`` is the ``‖a‖² − 2a·b + ‖b‖²`` expansion clamped at 0,
never ``torch.cdist``: the ball boundary ``d2 ≤ r²`` of the set-abstraction
levels depends on this exact formula. For 3-D points it repeats what XLA's
CPU backend compiles bit for bit: it contracts multiply-adds into fused
multiply-adds, so ``‖a‖² = fma(a₂, a₂, fma(a₁, a₁, a₀·a₀))`` and
``a·b = fma(a₂, b₂, fma(a₁, b₁, a₀·b₀))``, each fma rounded once
(``fma3``: computed in f64, which holds the f32 product exactly). Wider
features (the EdgeConv kNN over embeddings) take a f32 ``matmul``, which
must not run in TF32 (``torch.backends.cuda.matmul.allow_tf32 = False``).
"""

from __future__ import annotations

from typing import Tuple

import torch


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a·b + c`` rounded once."""
    return torch.addcmul(c.double(), a.double(), b.double()).float()


def fma3(a0, a1, a2, b0, b1, b2) -> torch.Tensor:
    """f32 ``fma(a₂, b₂, fma(a₁, b₁, a₀·b₀))``: a 3-term dot as XLA's CPU
    backend computes it."""
    return _fma(a2, b2, _fma(a1, b1, a0 * b0))


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances [..., M, N] between a [..., M, D] and
    b [..., N, D], f32."""
    a, b = a.float(), b.float()
    if a.shape[-1] == 3:
        a2, b2 = fma3(*a.unbind(-1), *a.unbind(-1)), fma3(*b.unbind(-1),
                                                          *b.unbind(-1))
        ab = fma3(*(t[..., :, None] for t in a.unbind(-1)),
                  *(t[..., None, :] for t in b.unbind(-1)))
    else:
        a2, b2 = (a * a).sum(-1), (b * b).sum(-1)
        ab = torch.matmul(a, b.transpose(-1, -2))
    d2 = (a2[..., :, None] - 2.0 * ab) + b2[..., None, :]
    return d2.clamp_min(0.0)


def masked_knn(x: torch.Tensor, mask: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest valid neighbours of each element (self included).

    x [B, M, D], mask [B, M] bool → (idx [B, M, k] int64, valid [B, M, k]).
    Invalid pairs are +inf; ties go to the lower index, as ``lax.top_k``
    breaks them (a stable ascending sort, not ``torch.topk``). ``valid`` is
    False past a set's valid count and for invalid query elements.
    """
    B, M, _ = x.shape
    k = min(k, M)
    d2 = pairwise_sqdist(x, x)
    pair_ok = mask[:, :, None] & mask[:, None, :]
    d2 = torch.where(pair_ok, d2, torch.full_like(d2, float("inf")))
    vals, idx = torch.sort(d2, dim=-1, stable=True)
    valid = torch.isfinite(vals[..., :k]) & mask[:, :, None]
    return idx[..., :k], valid
