"""One PointNet++ set-abstraction level after FPS (counterpart of
``text2pos_tpu/ops/pointconv_pallas.py`` and of ``SetAbstraction`` at
``train=False`` in ``text2pos_tpu/models/pointnet2.py``).

For each object b and centroid s the neighbours are the first ``k_cap``
points n by index with ``d2(cent_s, pos_n) ≤ r²``; the output is the max
over them of ``relu(BN1(relu(BN0(a_n − c_s))·W2 + b2))``, 0 where there are
none. ``a = [x, pos]·W1 + b1`` and ``c = cent·W1[-3:]`` are the separable
first layer, computed by the caller.

The kernel ``csrc/pointconv.cu`` (replacing the Pallas kernel
``pointconv_pallas.py:91``) selects the neighbours first and runs the MLP on
those rows only. ``pointconv_max_plain`` repeats its arithmetic in PyTorch,
gather-based: the neighbour indices come from a stable sort of the in-ball
flags, so no [B, S, K, N] one-hot is built. Both take f32 or bf16 ``a``,
``c`` and ``W2``; in bf16 they round where the JAX package's compiled model
does (XLA's CPU backend keeps f32 between matmuls): ``a − c`` and BN0 in
f32, BN0's output rounded as the second layer's input, the product rounded,
then bias, BN1, ReLU and the max in f32, the result rounded to bf16.

The ball boundary depends on ``d2`` bit for bit: ``neighbors.
pairwise_sqdist`` reproduces XLA's arithmetic with elementwise ops, never a
matmul. The plain version's second layer is an f32 matmul and needs TF32 off
on the card (``torch.backends.cuda.matmul.allow_tf32 = False``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from text2pos_torch.ops import _build
from text2pos_torch.ops.neighbors import pairwise_sqdist
from text2pos_torch.ops.pooling import gather_neighbors, masked_max

Affine = Tuple[torch.Tensor, torch.Tensor]   # (scale, shift), f32 [C]


def ball_neighbors(pos: torch.Tensor, cent: torch.Tensor, radius: float,
                   k_cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first ``k_cap`` in-ball points of each centroid by index.

    pos [B, N, 3], cent [B, S, 3] → (idx [B, S, k_cap] int64, valid
    [B, S, k_cap] bool); ``valid.sum(-1)`` is the neighbour count.
    """
    k_cap = min(k_cap, pos.shape[1])
    in_ball = pairwise_sqdist(cent, pos) <= radius * radius       # [B, S, N]
    order = torch.sort((~in_ball).to(torch.uint8), dim=-1, stable=True)
    idx = order.indices[..., :k_cap]
    valid = torch.gather(in_ball, -1, idx)
    return idx, valid


def pointconv_max_plain(a: torch.Tensor, pos: torch.Tensor, c: torch.Tensor,
                        cent: torch.Tensor, bn0: Affine, w2: torch.Tensor,
                        b2: torch.Tensor, bn1: Affine, radius: float,
                        k_cap: int) -> torch.Tensor:
    """Plain PyTorch twin of the kernel. a [B, N, C1], c [B, S, C1], w2
    [C1, C2] in the compute dtype (f32 or bf16); pos, cent, b2 and the BN
    affines f32 → [B, S, C2] in the compute dtype."""
    dt = a.dtype

    def rnd(x):
        return x.to(dt).float()

    idx, valid = ball_neighbors(pos, cent, radius, k_cap)
    d = gather_neighbors(a, idx).float() - c.float()[:, :, None, :]
    h = torch.relu(rnd(d * bn0[0] + bn0[1]))
    z = rnd(h @ w2.float()) + b2
    y = torch.relu(z * bn1[0] + bn1[1])
    return masked_max(y, valid[..., None], dim=2).to(dt)


def _pointconv_kernel(a, pos, c, cent, bn0, w2, b2, bn1, radius, k_cap):
    B, N, C1 = a.shape
    S = c.shape[1]
    C2 = w2.shape[1]
    dt = a.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"PointConv kernel: unsupported dtype {dt}")
    f32 = {"pos": pos, "cent": cent, "s0": bn0[0], "t0": bn0[1], "b2": b2,
           "s1": bn1[0], "t1": bn1[1]}
    for name, x in {"c": c, "w2": w2, **f32}.items():
        if x.device != a.device:
            raise ValueError(f"PointConv kernel: {name} is not on a's device")
        if name in f32 and x.dtype != torch.float32:
            raise TypeError(f"PointConv kernel: {name} must be float32")
    if c.dtype != dt or w2.dtype != dt:
        raise TypeError("PointConv kernel: a, c and w2 must share a dtype")
    shapes = {"pos": (B, N, 3), "c": (B, S, C1), "cent": (B, S, 3),
              "w2": (C1, C2), "s0": (C1,), "t0": (C1,), "b2": (C2,),
              "s1": (C2,), "t1": (C2,)}
    for name, want in shapes.items():
        got = tuple(({"c": c, "w2": w2, **f32})[name].shape)
        if got != want:
            raise ValueError(f"PointConv kernel: {name} has shape {got}, "
                             f"expected {want}")
    if (C1 % 4 or not 4 <= C1 <= 512 or C2 % 64 or not 64 <= C2 <= 1024
            or not 1 <= B <= 65535):
        raise ValueError(f"PointConv kernel: unsupported widths C1={C1}, "
                         f"C2={C2} or object count B={B} (C1 a multiple of "
                         "4 up to 512, C2 a multiple of 64 up to 1024, B up "
                         "to 65535)")
    k_cap = min(k_cap, N)
    if not 1 <= k_cap <= 32:
        raise ValueError(f"PointConv kernel: k_cap {k_cap} not in [1, 32]")
    a, pos, c, cent, w2 = (x.contiguous() for x in (a, pos, c, cent, w2))
    vecs = [x.contiguous() for x in (bn0[0], bn0[1], b2, bn1[0], bn1[1])]
    out = torch.empty(B, S, C2, device=a.device, dtype=dt)
    fn = _build.entry("pointconv", "t2p_pointconv_max",
                      [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                      + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p])
    s0, t0, b2, s1, t1 = vecs
    _build.check(fn(a.data_ptr(), pos.data_ptr(), c.data_ptr(),
                    cent.data_ptr(), s0.data_ptr(), t0.data_ptr(),
                    w2.data_ptr(), b2.data_ptr(), s1.data_ptr(),
                    t1.data_ptr(), out.data_ptr(), B, N, S, C1, C2,
                    radius * radius, k_cap, int(dt == torch.bfloat16),
                    _build.stream_ptr(a.device)), "pointconv_max")
    _build.LAUNCHES["pointconv"] += 1
    return out


def pointconv_max(a: torch.Tensor, pos: torch.Tensor, c: torch.Tensor,
                  cent: torch.Tensor, bn0: Affine, w2: torch.Tensor,
                  b2: torch.Tensor, bn1: Affine, radius: float,
                  k_cap: int = 32) -> torch.Tensor:
    """One SA level's grouped MLP and max; the CUDA kernel on the card, the
    plain version on the CPU."""
    if a.is_cuda:
        return _pointconv_kernel(a, pos, c, cent, bn0, w2, b2, bn1, radius,
                                 k_cap)
    return pointconv_max_plain(a, pos, c, cent, bn0, w2, b2, bn1, radius,
                               k_cap)
