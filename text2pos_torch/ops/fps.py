"""Farthest-point sampling (counterpart of ``text2pos_tpu/ops/fps.py``).

Start at index 0; each step takes the point farthest from the selected set.
The squared distance is ``dx·dx + dy·dy + dz·dz`` in f32, summed in that
order with the two additions fused into the products
(``fma(dz, dz, fma(dy, dy, dx·dx))``), exactly as XLA's CPU backend
compiles it; the running minimum and ``argmax`` follow, and ``argmax`` takes
the first index on ties. With duplicate points everywhere (resampling with
replacement, pad objects of 8 points) exact ties are the rule, so these
choices decide which centroids come out.

On the card the whole loop is one launch of ``csrc/fps.cu`` (a warp per
object); ``farthest_point_sampling_plain`` is the same loop in PyTorch, one
step at a time, and the CPU path.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from text2pos_torch.ops import _build
from text2pos_torch.ops.neighbors import fma3

MAX_POINTS = 1024  # the kernel keeps at most 32 points a lane


def _check(points: torch.Tensor, num_samples: int) -> None:
    if points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(f"points must be [B, N, 3], got {tuple(points.shape)}")
    if not 1 <= num_samples <= points.shape[1]:
        raise ValueError(f"num_samples {num_samples} not in "
                         f"[1, {points.shape[1]}]")


def farthest_point_sampling_plain(points: torch.Tensor, num_samples: int
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """points [B, N, 3] f32 → (idx [B, num_samples] int64 indices into N,
    the selected points [B, num_samples, 3])."""
    _check(points, num_samples)
    B, N, _ = points.shape
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
    cent = torch.gather(points, 1, selected[..., None].expand(B, num_samples,
                                                              3))
    return selected, cent


def _fps_kernel(points: torch.Tensor, num_samples: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(points, num_samples)
    if points.dtype != torch.float32:
        raise TypeError(f"FPS kernel: points must be float32, got "
                        f"{points.dtype}")
    B, N, _ = points.shape
    if not 1 <= N <= MAX_POINTS or B < 1:
        raise ValueError(f"FPS kernel: N={N} points, B={B} objects (N in "
                         f"[1, {MAX_POINTS}], B >= 1)")
    points = points.contiguous()
    idx = torch.empty(B, num_samples, dtype=torch.long, device=points.device)
    cent = torch.empty(B, num_samples, 3, device=points.device)
    _launch(points, idx, cent)
    return idx, cent


def _launch(points: torch.Tensor, idx: torch.Tensor, cent: torch.Tensor
            ) -> None:
    """One launch into idx [B, S] int64 and cent [B, S, 3] for contiguous f32
    points [B, N, 3] that ``_fps_kernel`` has checked."""
    B, N, _ = points.shape
    fn = _build.entry("fps", "t2p_fps", [ctypes.c_void_p] * 3
                      + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    _build.launch(fn, points.device, "fps", points.data_ptr(),
                  idx.data_ptr(), cent.data_ptr(), B, N, idx.shape[1])
    _build.LAUNCHES["fps"] += 1


def farthest_point_sampling(points: torch.Tensor, num_samples: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """points [B, N, 3] f32 → (idx [B, num_samples] int64, the selected
    points [B, num_samples, 3]); the CUDA kernel on the card, the plain
    version on the CPU."""
    if points.is_cuda:
        return _fps_kernel(points, num_samples)
    return farthest_point_sampling_plain(points, num_samples)
