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
those rows only; in bf16 on the tensor cores, with W2 handed over in the
``mma.sync`` B operand's fragment order (``w2_fragments``; the model packs
it once a level, ``SetAbstraction.w2_fragments``) and staged once per CTA
in shared memory. ``pointconv_max_plain`` repeats its arithmetic in
PyTorch, gather-based: the neighbour indices come from a stable sort of the
in-ball flags, so no [B, S, K, N] one-hot is built. Both take f32 or bf16 ``a``,
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
from typing import Optional, Tuple

import torch

from text2pos_torch.ops import _build
from text2pos_torch.ops.neighbors import pairwise_sqdist
from text2pos_torch.ops.pooling import gather_neighbors, masked_max

Affine = Tuple[torch.Tensor, torch.Tensor]   # (scale, shift), f32 [C]

BF16_C1 = (16, 32, 64, 128, 256)   # the bf16 kernel's instantiations
BF16_MAX_W2 = 65536                # C1·C2: W2 in at most 128 KB of shared memory
_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


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


def w2_fragments(w2: torch.Tensor) -> torch.Tensor:
    """Row-major W2 [C1, C2] → the B operand's fragment order of
    ``mma.sync.m16n8k16``, ``[C2/8, C1/16, 32, 4]``: lane ``4·g + t`` of the
    (n-tile, k-step) block holds column ``g`` at k = 2t, 2t+1, 2t+8, 2t+9
    (the layout of ``superglue_gnn.to_fragment_order``)."""
    C1, C2 = w2.shape
    if C1 % 16 or C2 % 8:
        raise ValueError(f"fragment order needs C1 % 16 == 0 and C2 % 8 == 0,"
                         f" got [{C1}, {C2}]")
    # k = 16·ks + 8·h + 2·t + e, n = 8·nt + g  →  [nt, ks, g, t, h, e]
    return (w2.reshape(C1 // 16, 2, 4, 2, C2 // 8, 8)
            .permute(4, 0, 5, 2, 1, 3).reshape(C2 // 8, C1 // 16, 32, 4)
            .contiguous())


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


def _pointconv_kernel(a, pos, c, cent, bn0, w2, b2, bn1, radius, k_cap,
                      w2f=None):
    _build.refuse_grad("PointConv kernel", a, pos, c, cent, *bn0, w2, b2,
                       *bn1, w2f)
    B, N, C1 = a.shape
    S = c.shape[1]
    C2 = w2.shape[1]
    dt = a.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"PointConv kernel: unsupported dtype {dt}")
    f32 = (("pos", pos, (B, N, 3)), ("cent", cent, (B, S, 3)),
           ("s0", bn0[0], (C1,)), ("t0", bn0[1], (C1,)), ("b2", b2, (C2,)),
           ("s1", bn1[0], (C2,)), ("t1", bn1[1], (C2,)))
    for name, x, want in (("c", c, (B, S, C1)), ("w2", w2, (C1, C2)), *f32):
        if x.device != a.device:
            raise ValueError(f"PointConv kernel: {name} is not on a's device")
        if x.shape != want:
            raise ValueError(f"PointConv kernel: {name} has shape "
                             f"{tuple(x.shape)}, expected {want}")
    for name, x, _ in f32:
        if x.dtype != torch.float32:
            raise TypeError(f"PointConv kernel: {name} must be float32")
    if c.dtype != dt or w2.dtype != dt:
        raise TypeError("PointConv kernel: a, c and w2 must share a dtype")
    if (C1 % 4 or not 4 <= C1 <= 512 or C2 % 64 or not 64 <= C2 <= 1024
            or not 1 <= B <= 65535):
        raise ValueError(f"PointConv kernel: unsupported widths C1={C1}, "
                         f"C2={C2} or object count B={B} (C1 a multiple of "
                         "4 up to 512, C2 a multiple of 64 up to 1024, B up "
                         "to 65535)")
    bf16 = dt == torch.bfloat16
    if bf16 and (C1 not in BF16_C1 or C1 * C2 > BF16_MAX_W2):
        raise ValueError(f"PointConv kernel: bf16 widths C1={C1}, C2={C2} "
                         f"unsupported (C1 one of {BF16_C1}, C1·C2 at most "
                         f"{BF16_MAX_W2})")
    k_cap = min(k_cap, N)
    if not 1 <= k_cap <= 32:
        raise ValueError(f"PointConv kernel: k_cap {k_cap} not in [1, 32]")
    a, pos, c, cent = (x.contiguous() for x in (a, pos, c, cent))
    vecs = [x.contiguous() for x in (bn0[0], bn0[1], b2, bn1[0], bn1[1])]
    # Vector loads: rows of a and c, BN0's columns, pairs of b2 and BN1
    # columns (bf16), f32 W2's rows.
    a, c, *vecs = (x if x.data_ptr() % 16 == 0 else x.clone()
                   for x in (a, c, *vecs))
    if not bf16:
        w2 = w2.contiguous()
        if w2.data_ptr() % 16:
            w2 = w2.clone()
    elif w2f is None:
        w2 = w2_fragments(w2)
    else:
        want = (C2 // 8, C1 // 16, 32, 4)
        if (tuple(w2f.shape) != want or w2f.dtype != torch.bfloat16
                or w2f.device != a.device or not w2f.is_contiguous()):
            raise ValueError(f"PointConv kernel: w2f must be w2_fragments(w2)"
                             f", contiguous bf16 {list(want)} on a's device, "
                             f"got {w2f.dtype} {list(w2f.shape)}")
        w2 = w2f
    out = torch.empty(B, S, C2, device=a.device, dtype=dt)
    fn = _build.entry("pointconv", "t2p_pointconv_max", _ARGTYPES)
    s0, t0, b2, s1, t1 = vecs
    _build.launch(fn, a.device, "pointconv_max", a.data_ptr(),
                  pos.data_ptr(), c.data_ptr(), cent.data_ptr(),
                  s0.data_ptr(), t0.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                  s1.data_ptr(), t1.data_ptr(), out.data_ptr(), B, N, S, C1,
                  C2, radius * radius, k_cap, int(bf16))
    _build.LAUNCHES["pointconv"] += 1
    return out


def pointconv_max(a: torch.Tensor, pos: torch.Tensor, c: torch.Tensor,
                  cent: torch.Tensor, bn0: Affine, w2: torch.Tensor,
                  b2: torch.Tensor, bn1: Affine, radius: float,
                  k_cap: int = 32, w2f: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """One SA level's grouped MLP and max; the CUDA kernel on the card, the
    plain version on the CPU. ``w2f``, ``w2_fragments(w2)`` packed once by
    the caller, spares the bf16 kernel's wrapper packing W2 at every call;
    the other paths ignore it."""
    if a.is_cuda:
        return _pointconv_kernel(a, pos, c, cent, bn0, w2, b2, bn1, radius,
                                 k_cap, w2f)
    return pointconv_max_plain(a, pos, c, cent, bn0, w2, b2, bn1, radius,
                               k_cap)
