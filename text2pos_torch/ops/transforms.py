"""Point-cloud transforms for encoding (counterpart of
``text2pos_tpu/ops/transforms.py`` with ``augment=False``).

FixedPoints (uniform resampling with replacement) then NormalizeScale
(center on the mean, scale into [-1, 1] by 0.999999 / max|p|). The random
draws come from a ``torch.Generator``; ``u`` hands them over directly, so
that a test can feed both frameworks the same numbers.

Everything downstream that is discrete (farthest-point sampling, the ball
query) depends on these coordinates bit for bit, so ``normalize_scale``
sums the points in the order XLA's CPU backend does: eight contiguous
blocks, each summed in index order, then the block sums in order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def fixed_points(xyz: torch.Tensor, rgb: torch.Tensor, counts: torch.Tensor,
                 num: int, generator: Optional[torch.Generator] = None,
                 u: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample ``num`` of the first ``counts`` stored points per object.

    xyz, rgb [..., P, 3]; counts [...] (≥ 1); ``u`` [..., num] uniform
    draws in [0, 1) (drawn from ``generator`` when None). Index
    ``floor(u·count)`` clipped to [0, P-1], as in JAX.
    """
    lead = xyz.shape[:-2]
    if u is None:
        u = torch.rand(lead + (num,), generator=generator, device=xyz.device)
    u = u.to(device=xyz.device, dtype=torch.float32)
    idx = torch.floor(u * counts.to(xyz.device)[..., None].float()).long()
    idx = idx.clamp(0, xyz.shape[-2] - 1)[..., None].expand(*idx.shape, 3)
    return torch.gather(xyz, -2, idx), torch.gather(rgb, -2, idx)


def sum_points(x: torch.Tensor) -> torch.Tensor:
    """Σ over axis -2 of [..., N, 3] f32 in XLA CPU's order (N % 8 == 0:
    eight blocks of N/8 summed sequentially, then the eight partial sums;
    otherwise one sequential sum)."""
    n = x.shape[-2]
    blocks = x.unflatten(-2, (8, n // 8)) if n % 8 == 0 else x[..., None, :, :]
    s = blocks[..., 0, :]
    for i in range(1, blocks.shape[-2]):
        s = s + blocks[..., i, :]
    total = s[..., 0, :]
    for j in range(1, s.shape[-2]):
        total = total + s[..., j, :]
    return total


def normalize_scale(xyz: torch.Tensor) -> torch.Tensor:
    """Center each object at its mean and scale into [-1, 1] (PyG
    NormalizeScale with its 0.999999 factor)."""
    mean = sum_points(xyz) / xyz.shape[-2]
    centered = xyz - mean[..., None, :]
    max_abs = centered.abs().amax(dim=(-2, -1), keepdim=True)
    scale = (1.0 / max_abs.clamp_min(1e-12)) * 0.999999
    return centered * scale


def prepare_object_points(xyz: torch.Tensor, rgb: torch.Tensor,
                          counts: torch.Tensor, num_points: int,
                          generator: Optional[torch.Generator] = None,
                          u: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FixedPoints → NormalizeScale (the eval pipeline)."""
    sx, sr = fixed_points(xyz.float(), rgb.float(), counts, num_points,
                          generator, u)
    return normalize_scale(sx), sr
