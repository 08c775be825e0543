"""Farthest-point sampling (counterpart of ``text2pos_tpu/ops/fps.py``).

Start at index 0; each step takes the point farthest from the selected set.
The squared distance is ``dx·dx + dy·dy + dz·dz`` in f32, summed in that
order with the two additions fused into the products
(``fma(dz, dz, fma(dy, dy, dx·dx))``), exactly as XLA's CPU backend
compiles it; the running minimum and ``argmax`` follow, and ``argmax`` takes
the first index on ties. With duplicate points everywhere (resampling with
replacement, pad objects of 8 points) exact ties are the rule, so these
choices decide which centroids come out.
"""

from __future__ import annotations

import torch

from text2pos_torch.ops.neighbors import fma3


def farthest_point_sampling(points: torch.Tensor, num_samples: int
                            ) -> torch.Tensor:
    """points [B, N, 3] f32 → [B, num_samples] int64 indices into N."""
    B, N, _ = points.shape
    if not 1 <= num_samples <= N:
        raise ValueError(f"num_samples {num_samples} not in [1, {N}]")
    selected = torch.zeros(B, num_samples, dtype=torch.long,
                           device=points.device)
    last = selected[:, 0]
    min_dist = torch.full((B, N), float("inf"), device=points.device,
                          dtype=points.dtype)
    rows = torch.arange(B, device=points.device)
    x, y, z = points.unbind(-1)
    for i in range(1, num_samples):
        dx = x - x[rows, last][:, None]
        dy = y - y[rows, last][:, None]
        dz = z - z[rows, last][:, None]
        min_dist = torch.minimum(min_dist, fma3(dx, dy, dz, dx, dy, dz))
        last = torch.argmax(min_dist, dim=-1)
        selected[:, i] = last
    return selected
