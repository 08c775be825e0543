"""Point-cloud transforms (counterpart of ``text2pos_tpu/ops/transforms.py``).

FixedPoints (uniform resampling with replacement), in training
RandomRotate (uniform ±120° about z, one angle an object), then
NormalizeScale (center on the mean, scale into [-1, 1] by 0.999999 /
max|p|). The random draws come from a ``torch.Generator``: the uniforms of
the resampling, then the angles. ``u`` or ``idx`` (the sample indices) and
``angles`` (degrees) hand them over directly, so that a test can feed both
frameworks the same numbers.

Everything downstream that is discrete (farthest-point sampling, the ball
query) depends on these coordinates bit for bit, so ``normalize_scale``
sums the points in the order XLA's CPU backend does: eight contiguous
blocks, each summed in index order, then the block sums in order.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from text2pos_torch.ops.neighbors import _fma


def sample_indices(counts: torch.Tensor, num: int, num_stored: int,
                   generator: Optional[torch.Generator] = None,
                   u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[..., num] int64 indices ``floor(u·count)`` clipped to [0,
    num_stored-1], as in JAX; ``u`` [..., num] uniform draws in [0, 1)
    (drawn from ``generator`` when None)."""
    dev = counts.device
    if u is None:
        u = torch.rand(counts.shape + (num,), generator=generator, device=dev)
    u = u.to(device=dev, dtype=torch.float32)
    idx = torch.floor(u * counts[..., None].float()).long()
    return idx.clamp(0, num_stored - 1)


def fixed_points(xyz: torch.Tensor, rgb: torch.Tensor, counts: torch.Tensor,
                 num: int, generator: Optional[torch.Generator] = None,
                 u: Optional[torch.Tensor] = None,
                 idx: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample ``num`` of the first ``counts`` stored points per object.

    xyz, rgb [..., P, 3]; counts [...] (≥ 1); the sample indices ``idx``
    [..., num], or ``sample_indices`` of ``u`` or of ``generator``'s draws.
    """
    if idx is None:
        idx = sample_indices(counts.to(xyz.device), num, xyz.shape[-2],
                             generator, u)
    idx = idx.to(xyz.device).long()[..., None].expand(*idx.shape, 3)
    return torch.gather(xyz, -2, idx), torch.gather(rgb, -2, idx)


def random_rotate_z(xyz: torch.Tensor, degrees: torch.Tensor
                    ) -> torch.Tensor:
    """Rotate each object of xyz [..., P, 3] about z by ``degrees`` [...]
    (JAX draws them uniform in [-120, 120))."""
    theta = degrees.to(device=xyz.device, dtype=torch.float32) * (
        math.pi / 180.0)
    # cos and sin in f64, rounded once: closer to XLA's f32 results (98-99%
    # of them equal on [-120°, 120°)) than torch's f32 functions (95%).
    c = torch.cos(theta.double()).float()[..., None]
    s = torch.sin(theta.double()).float()[..., None]
    x, y, z = xyz.unbind(-1)
    # XLA's CPU backend contracts each row into one fused multiply-add:
    # x' = fma(c, x, -(s·y)), y' = fma(s, x, c·y).
    return torch.stack([_fma(c, x, -(s * y)), _fma(s, x, c * y), z], dim=-1)


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
                          u: Optional[torch.Tensor] = None, *,
                          augment: bool = False, no_pc_augment: bool = False,
                          idx: Optional[torch.Tensor] = None,
                          angles: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FixedPoints → (RandomRotate with ``augment``) → NormalizeScale;
    FixedPoints alone with ``no_pc_augment``. Draws: ``idx`` or ``u``, and
    ``angles`` [...] in degrees, each from ``generator`` when not given
    (the angles after the uniforms, and only with ``augment``)."""
    sx, sr = fixed_points(xyz.float(), rgb.float(), counts, num_points,
                          generator, u, idx)
    if no_pc_augment:
        return sx, sr
    if augment:
        if angles is None:
            angles = torch.rand(xyz.shape[:-2], generator=generator,
                                device=xyz.device) * 240.0 - 120.0
        sx = random_rotate_z(sx, angles)
    return normalize_scale(sx), sr
