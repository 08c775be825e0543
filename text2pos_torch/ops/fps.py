"""Farthest-point sampling (counterpart of ``text2pos_tpu/ops/fps.py``).

Start at index 0; each step takes the point farthest from the selected set.
The squared distance is ``dx·dx + dy·dy + dz·dz`` in f32, summed in that
order with the two additions fused into the products
(``fma(dz, dz, fma(dy, dy, dx·dx))``), exactly as XLA's CPU backend
compiles it; the running minimum and ``argmax`` follow, and ``argmax`` takes
the first index on ties. With duplicate points everywhere (resampling with
replacement, pad objects of 8 points) exact ties are the rule, so these
choices decide which centroids come out.

On the card a PointNet++ forward's levels are one launch of ``csrc/fps.cu``
(``farthest_point_sampling_levels``: level l + 1 samples level l's
centroids), and one level, JAX's function, is the same kernel on one level
(``farthest_point_sampling``); any number of points. The ``_plain``
versions are the same loops in PyTorch, one step at a time, and the CPU
path.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from text2pos_torch.ops import _build
from text2pos_torch.ops.neighbors import fma3

MAX_LEVELS = 3        # levels a launch chains (csrc/fps.cu MAX_LEVELS)
REGISTER_POINTS = 4096  # past this the kernel keeps the minima in scratch

Level = Tuple[torch.Tensor, torch.Tensor]


def _check(points: torch.Tensor, num_samples: int) -> None:
    if points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(f"points must be [B, N, 3], got {tuple(points.shape)}")
    if not 1 <= num_samples <= points.shape[1]:
        raise ValueError(f"num_samples {num_samples} not in "
                         f"[1, {points.shape[1]}]")


def level_sizes(num_points: int, ratios: Sequence[float]) -> List[int]:
    """Samples a level for ``num_points`` points and the levels' ratios:
    ``S_l = max(1, int(N_l · ratio_l))``, ``N_{l+1} = S_l`` (the rule of
    ``SetAbstraction``)."""
    sizes = []
    for r in ratios:
        num_points = max(1, int(num_points * r))
        sizes.append(num_points)
    return sizes


def farthest_point_sampling_plain(points: torch.Tensor, num_samples: int
                                  ) -> Level:
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


def farthest_point_sampling_levels_plain(points: torch.Tensor,
                                         ratios: Sequence[float]
                                         ) -> List[Level]:
    """``farthest_point_sampling_plain`` level by level: [(idx_l, cent_l)],
    level l + 1 on level l's centroids, sizes by ``level_sizes``."""
    out = []
    for S in level_sizes(points.shape[1], ratios):
        out.append(farthest_point_sampling_plain(points, S))
        points = out[-1][1]
    return out


def _check_kernel(points: torch.Tensor, sizes: Sequence[int]) -> None:
    if points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(f"points must be [B, N, 3], got "
                         f"{tuple(points.shape)}")
    if points.dtype != torch.float32:
        raise TypeError(f"FPS kernel: points must be float32, got "
                        f"{points.dtype}")
    B, N = points.shape[:2]
    if B < 1 or not 1 <= len(sizes) <= MAX_LEVELS:
        raise ValueError(f"FPS kernel: B={B} objects, {len(sizes)} levels "
                         f"(B >= 1, 1 to {MAX_LEVELS} levels)")
    for S in sizes:
        if not 1 <= S <= N:
            raise ValueError(f"FPS kernel: {S} samples of {N} points")
        N = S


def _buffers(points: torch.Tensor, sizes: Sequence[int]
             ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor],
                        List[Level]]:
    """One allocation for a launch, in 4-byte words: every level's int64
    indices (two words each), then every level's f32 centroids, each
    level-major as the kernel writes them, then the minima's scratch past
    REGISTER_POINTS points. Returns (indices, centroids, scratch or None,
    [(idx_l [B, S_l], cent_l [B, S_l, 3])]); few tensor operations, since
    each costs the host microseconds a call."""
    B, N, _ = points.shape
    L = len(sizes)
    scratch = B * N if N > REGISTER_POINTS else 0
    words = [2 * B * S for S in sizes] + [3 * B * S for S in sizes]
    parts = torch.empty(sum(words) + scratch, dtype=torch.float32,
                        device=points.device).split_with_sizes(
                            words + [scratch])
    levels = [(parts[l].view(torch.long).view(B, S),
               parts[L + l].view(B, S, 3)) for l, S in enumerate(sizes)]
    return parts[0], parts[L], parts[-1] if scratch else None, levels


def _launch(points: torch.Tensor, idx: torch.Tensor, cent: torch.Tensor,
            scratch: Optional[torch.Tensor], sizes: Sequence[int]) -> None:
    """One launch into ``_buffers``' outputs for contiguous f32 points
    [B, N, 3] that ``_check_kernel`` has checked."""
    B, N, _ = points.shape
    fn = _build.entry("fps", "t2p_fps_levels", [ctypes.c_void_p] * 4
                      + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    S = list(sizes) + [0] * (MAX_LEVELS - len(sizes))
    _build.launch(fn, points.device, "fps", points.data_ptr(),
                  idx.data_ptr(), cent.data_ptr(),
                  None if scratch is None else scratch.data_ptr(), B, N,
                  len(sizes), *S)
    _build.LAUNCHES["fps"] += 1


def _run(points: torch.Tensor, sizes: Sequence[int]) -> List[Level]:
    _check_kernel(points, sizes)
    points = points.contiguous()
    idx, cent, scratch, levels = _buffers(points, sizes)
    _launch(points, idx, cent, scratch, sizes)
    return levels


def _fps_kernel(points: torch.Tensor, num_samples: int) -> Level:
    return _run(points, (num_samples,))[0]


def _fps_levels_kernel(points: torch.Tensor, ratios: Sequence[float]
                       ) -> List[Level]:
    N = points.shape[1] if points.dim() == 3 else 0   # else _run raises
    return _run(points, level_sizes(N, ratios))


def farthest_point_sampling(points: torch.Tensor, num_samples: int
                            ) -> Level:
    """points [B, N, 3] f32 → (idx [B, num_samples] int64, the selected
    points [B, num_samples, 3]); the CUDA kernel on the card, the plain
    version on the CPU."""
    if points.is_cuda:
        return _fps_kernel(points, num_samples)
    return farthest_point_sampling_plain(points, num_samples)


def farthest_point_sampling_levels(points: torch.Tensor,
                                   ratios: Sequence[float]) -> List[Level]:
    """points [B, N, 3] f32 → [(idx_l [B, S_l], cent_l [B, S_l, 3])] for
    up to three chained levels, ``S_l`` by ``level_sizes``: one kernel
    launch on the card, the plain version on the CPU."""
    if points.is_cuda:
        return _fps_levels_kernel(points, ratios)
    return farthest_point_sampling_levels_plain(points, ratios)


def chain_step_time(device: torch.device, iters: int = 1 << 16
                    ) -> Tuple[float, float]:
    """(clocks, ns) of one step of the dependent chain that no FPS design
    avoids (``t2p_fps_chain_clocks``: the shuffle of the last centroid, the
    subtraction, the product, two FMAs, the min, the warp's max, the ballot
    and ``__ffs``), over ``iters`` steps of one warp on ``device``'s card.
    A measurement of the card, not an FPS launch: ``LAUNCHES`` does not
    count it."""
    out = torch.zeros(3, dtype=torch.long, device=device)
    fn = _build.entry("fps", "t2p_fps_chain_clocks",
                      [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    _build.launch(fn, out.device, "fps chain clocks", out.data_ptr(), iters)
    clocks, ns, _ = out.tolist()
    return clocks / iters, ns / iters
