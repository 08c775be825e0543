"""Fused SuperGlue attention GNN in eval mode (counterpart of
``text2pos_tpu/ops/superglue_gnn_pallas.py``).

``fold_gnn_params`` stacks the 2·num_layers blocks' weights and folds the
calibrated per-set BatchNorm (``bn_stat_groups=2``) into per-set affines
``s0``/``t0``; ``pack_gnn_params`` lays them out for the kernels. Two CUDA
forms replace the Pallas kernel ``superglue_gnn_pallas.py:253``; each runs
every self/cross block, the final projection and the ``[N, T0, T1]`` score
matrix scaled by 1/√E in one launch. ``gnn_scores_plain`` repeats their
arithmetic, rounding included, in PyTorch.

- ``csrc/superglue_gnn.cu``, tuned for ``KERNEL_SHAPE`` (E = 128, 16
  objects, 6 hints): bf16 on the tensor cores (``mma.sync`` m16n8k16, f32
  accumulation, ``TC_PAIRS`` pairs a CTA), f32 on the CUDA cores (1, 2 or 4
  pairs a CTA by the launch's size, ``f32_pairs``).
- ``csrc/superglue_gnn_any.cu`` at every other shape JAX's kernel takes
  (any E a multiple of 4 and 1 ≤ T1 ≤ T0, as the model asks: JAX's
  default E = 300, ``pad_size`` 24, 32 and past). ``any_plan`` picks its
  route and the pairs a CTA holds: bf16 on the tensor cores, f32 on the
  CUDA cores with G pairs sharing each weight read (both counted as
  ``superglue_gnn_any``, up to ``MAX_SHARED_SET`` objects), and
  ``superglue_gnn_any_wide`` where a pair's rows do not fit in shared
  memory or a cell holds more objects: G pairs a CTA, their rows in a
  global workspace, weight k-slices staged through shared memory, bf16
  products on the tensor cores (``wide_plan``).

Operations bound the function on the H100 (about 20·E²·(T0 + T1) a block a
pair against (T0 + T1)·E·4 bytes of descriptors). The layout the kernels
read is decided here, in index code that runs anywhere:

- every head is padded to ``Dp`` channels, a multiple of 16 in bf16 (so
  that QKᵀ's depth and P·V's width fit ``m16n8k16``) and of 4 in f32 (16-byte
  loads), the model width to ``Ep = 4·Dp`` (``padded_width``: 320 and 304 at
  E = 300; multiples of 64 are not padded). The pads are zero in every
  weight, bias and BN affine, so padded channels stay exactly 0 through
  every block; q|k|v and the messages are laid out by head, the residual,
  the merge output, h1 and the final projection with their real channels
  first.
- bf16 matmul weights are stored in the order of the instruction's B
  fragments (``to_fragment_order``), so that a warp reads its operand from
  global memory as one contiguous 8-byte load per lane and keeps no weight
  in shared memory. At E = 128 the pack is the tuned kernel's, and both
  forms read the same one. f32 weights are row-major.
- a CTA of the tensor-core kernels holds its pairs' rows set-major: all
  object rows, then all hint rows, each set padded to a multiple of 16, so
  that a 16-row tile belongs to one set.

``gnn_weights`` strips the pads again: the plain version runs at the real
widths, at unchanged arithmetic.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from text2pos_torch.ops import _build

HEADS = 4
KERNEL_SHAPE = (128, 16, 6)   # E, objects per cell, hints per query
# The second form's shared routes keep a query row's attention over the
# source set in registers, up to this many objects (superglue_gnn_any.cu
# SHARED_MAX_T); past it every shape takes the wide route.
MAX_SHARED_SET = 32
TC_PAIRS = 4                  # pairs per CTA of the tuned bf16 kernel
SMEM_OPTIN = 232448           # an H100 CTA's dynamic shared memory, bytes
MATMUL_WEIGHTS = ("wqkv", "wm", "w0", "w1", "wf")
# The final projection and the pack's real width; the rest are per block.
UNSTACKED = ("wf", "bf", "width")


def fold_gnn_params(params: Dict, batch_stats: Dict, num_layers: int,
                    eps: float = 1e-5) -> Dict[str, np.ndarray]:
    """Stacked block weights and per-set folded BN affines, f32 numpy.

    ``params``/``batch_stats`` are JAX-layout trees holding ``superglue``;
    the GNN BN statistics must be the calibrated ``[2, 2E]`` rows.
    """
    sg = params["superglue"]
    gnn = sg["gnn"]
    L = 2 * num_layers

    def stack(getter, tree=gnn):
        return np.stack([np.asarray(getter(tree[f"layer_{i}"]), np.float32)
                         for i in range(L)])

    out = {name: stack(lambda l, n=name: l["attn"][f"proj_{n[1]}"][
        "kernel" if n[0] == "w" else "bias"])
        for name in ("wq", "bq", "wk", "bk", "wv", "bv")}
    out.update(
        wm=stack(lambda l: l["attn"]["merge"]["kernel"]),
        bm=stack(lambda l: l["attn"]["merge"]["bias"]),
        w0=stack(lambda l: l["mlp"]["dense_0"]["kernel"]),
        w1=stack(lambda l: l["mlp"]["dense_1"]["kernel"]),
        b1=stack(lambda l: l["mlp"]["dense_1"]["bias"]),
        wf=np.asarray(sg["final_proj"]["kernel"], np.float32),
        bf=np.asarray(sg["final_proj"]["bias"], np.float32),
    )
    # Per set g: (x·W0 + b0 − mean_g)·scale/√(var_g+eps) + bias
    #          = (x·W0)·s_g + t_g
    scale = stack(lambda l: l["mlp"]["bn_0"]["scale"])           # [L, 2E]
    bias = stack(lambda l: l["mlp"]["bn_0"]["bias"])
    b0 = stack(lambda l: l["mlp"]["dense_0"]["bias"])
    bs = batch_stats["superglue"]["gnn"]
    mean = stack(lambda l: l["mlp"]["bn_0"]["mean"], bs)          # [L, 2, 2E]
    var = stack(lambda l: l["mlp"]["bn_0"]["var"], bs)
    if mean.ndim != 3:
        raise ValueError("fold_gnn_params needs bn_stat_groups=2 calibrated "
                         f"stats, got mean shape {mean.shape}")
    inv = scale[:, None, :] / np.sqrt(var + eps)
    out["s0"] = inv
    out["t0"] = bias[:, None, :] + (b0[:, None, :] - mean) * inv
    return out


def widen_gnn_stats(gnn_stats: Dict) -> Dict:
    """The GNN layers' flat ``[F]`` BN statistics rows (a trainer's
    checkpoint) widened in place to the ``[2, F]`` per-set rows that
    serving and the fold keep, one copy for each set (JAX's
    ``widen_gnn_stats`` in ``calibrated_for_serving``). ``gnn_stats`` is the
    ``superglue/gnn`` subtree of a JAX-layout ``batch_stats``."""
    for layer in gnn_stats.values():
        bn = layer["mlp"]["bn_0"]
        for key in ("mean", "var"):
            v = np.asarray(bn[key])
            if v.ndim == 1:
                bn[key] = np.tile(v[None], (2, 1))
    return gnn_stats


def _fragment_index(K: int, N: int):
    """Index arrays (k [K/16, 32, 4], n [N/8, 32]) of the B operand of
    ``mma.sync.m16n8k16``: lane ``4·g + t`` of a tile of 16 k-values and 8
    columns holds column ``g`` at k = 8·u + 2·t + v for its two registers u
    and the two halves v of a register, in that order."""
    if K % 16 or N % 8:
        raise ValueError(f"fragment order needs K % 16 == 0 and N % 8 == 0, "
                         f"got [{K}, {N}]")
    lane, e = np.arange(32), np.arange(4)
    k_in = (8 * (e // 2) + e % 2)[None, :] + 2 * (lane % 4)[:, None]  # [32, 4]
    k = 16 * np.arange(K // 16)[:, None, None] + k_in[None]     # [K/16, 32, 4]
    n = 8 * np.arange(N // 8)[:, None] + (lane // 4)[None, :]   # [N/8, 32]
    return k, n


def to_fragment_order(w: np.ndarray) -> np.ndarray:
    """Row-major ``[..., K, N]`` → ``[..., N/8, K/16, 32, 4]``."""
    k, n = _fragment_index(*w.shape[-2:])
    return w[..., k[None], n[:, None, :, None]]


def from_fragment_order(w: torch.Tensor) -> torch.Tensor:
    """``[..., N/8, K/16, 32, 4]`` → row-major ``[..., K, N]``."""
    K, N = 16 * w.shape[-3], 8 * w.shape[-4]
    k, n = (torch.as_tensor(i, device=w.device)
            for i in _fragment_index(K, N))
    out = w.new_empty(*w.shape[:-4], K, N)
    out[..., k[None], n[:, None, :, None]] = w
    return out


def random_folded_params(num_blocks: int, seed: int = 1,
                         width: int = KERNEL_SHAPE[0]
                         ) -> Dict[str, np.ndarray]:
    """Folded weights of ``num_blocks`` blocks drawn from a seed, in the
    layout ``fold_gnn_params`` gives: what checks of the kernel use where no
    checkpoint is at hand."""
    rng = np.random.default_rng(seed)
    L, E = num_blocks, width
    shapes = {"wq": (L, E, E), "wk": (L, E, E), "wv": (L, E, E),
              "wm": (L, E, E), "w0": (L, 2 * E, 2 * E), "w1": (L, 2 * E, E),
              "wf": (E, E), "bq": (L, E), "bk": (L, E), "bv": (L, E),
              "bm": (L, E), "b1": (L, E), "bf": (E,), "s0": (L, 2, 2 * E),
              "t0": (L, 2, 2 * E)}
    return {k: (rng.standard_normal(s) / np.sqrt(s[-2]) if k[0] == "w"
                else rng.random(s)).astype(np.float32)
            for k, s in shapes.items()}


def padded_width(E: int, dtype: torch.dtype) -> int:
    """``Ep``: E with every head padded to a multiple of 16 channels in bf16
    (a multiple of 64 in all) and of 4 in f32 (a multiple of 16)."""
    unit = 64 if dtype == torch.bfloat16 else 16
    return -(-E // unit) * unit


def head_index(E: int, Ep: int) -> np.ndarray:
    """Where the real channel c of q, k, v and the messages lies in the
    padded width: head c // (E/4) at a stride of Ep/4."""
    D, Dp = E // HEADS, Ep // HEADS
    c = np.arange(E)
    return (c // D) * Dp + c % D


def _pad_index(E: int, Ep: int) -> Dict[str, tuple]:
    """(rows, columns) in the padded pack of each folded array's last two
    axes (a vector's single axis as columns): head layout (q|k|v, messages),
    real channels first (residual, m, h1, md), [a | m] as two halves."""
    hi = head_index(E, Ep)
    real, real2 = np.arange(E), np.arange(2 * E)
    am = np.concatenate([real, Ep + real])
    qkv = np.concatenate([hi, Ep + hi, 2 * Ep + hi])
    return {"wqkv": (real, qkv), "bqkv": (None, qkv), "wm": (hi, real),
            "bm": (None, real), "w0": (am, real2), "s0": (None, real2),
            "t0": (None, real2), "w1": (real2, real), "b1": (None, real),
            "wf": (real, real), "bf": (None, real)}


def _padded_shape(name: str, lead, Ep: int):
    kn = {"wqkv": (Ep, 3 * Ep), "wm": (Ep, Ep), "w0": (2 * Ep, 2 * Ep),
          "w1": (2 * Ep, Ep), "wf": (Ep, Ep)}
    n = {"bqkv": 3 * Ep, "bm": Ep, "s0": 2 * Ep, "t0": 2 * Ep, "b1": Ep,
         "bf": Ep}
    return (*lead, *kn[name]) if name in kn else (*lead, n[name])


def pack_gnn_params(folded: Dict[str, np.ndarray], dtype: torch.dtype,
                    device) -> Dict[str, torch.Tensor]:
    """Kernel layout, padded to ``Ep = padded_width(E, dtype)`` with zeros:
    q|k|v fused to ``wqkv`` ([L, Ep, 3Ep] before ordering); matmul weights
    in the compute dtype, in fragment order ``[.., N/8, K/16, 32, 4]`` in
    bf16 (at E = 128 the tuned kernel's) and row-major ``[.., K, N]`` in
    f32; biases and BN affines in f32; ``width`` the real E (a 0-d int64
    tensor on the CPU, so that reading it does not synchronize)."""
    E = folded["wq"].shape[-1]
    Ep = padded_width(E, dtype)
    fused = {
        "wqkv": np.concatenate([folded["wq"], folded["wk"], folded["wv"]],
                               axis=2),
        "bqkv": np.concatenate([folded["bq"], folded["bk"], folded["bv"]],
                               axis=1),
        **{k: folded[k] for k in ("wm", "bm", "w0", "s0", "t0", "w1", "b1",
                                  "wf", "bf")}}
    out = {}
    for name, (rows, cols) in _pad_index(E, Ep).items():
        a = np.asarray(fused[name], np.float32)
        lead = a.shape[:-2] if rows is not None else a.shape[:-1]
        p = np.zeros(_padded_shape(name, lead, Ep), np.float32)
        if rows is None:
            p[..., cols] = a
        else:
            p[..., rows[:, None], cols[None, :]] = a
        if name in MATMUL_WEIGHTS:
            if dtype == torch.bfloat16:
                p = to_fragment_order(p)
            out[name] = torch.as_tensor(np.ascontiguousarray(p)).to(
                device=device, dtype=dtype)
        else:
            out[name] = torch.as_tensor(p).to(device=device)
    out["width"] = torch.tensor(E)
    return out


def fragment_ordered(packed: Dict[str, torch.Tensor]) -> bool:
    """Whether ``packed``'s matmul weights are in fragment order (stacked
    ``[L, N/8, K/16, 32, 4]``) rather than row-major ``[L, K, N]``."""
    return packed["wqkv"].dim() == 5


def packed_width(packed: Dict[str, torch.Tensor]) -> int:
    """``Ep``, the padded width of a pack."""
    return packed["bf"].shape[-1]


def real_width(packed: Dict[str, torch.Tensor]) -> int:
    """E, the width the pack was made at."""
    return int(packed["width"])


def gnn_weights(packed: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every array of ``packed`` as f32 at its real width, the pads stripped:
    matmul weights row-major ``[.., K, N]`` (the folded weights rounded to
    the pack's dtype, ``wqkv`` fused), biases and BN affines."""
    E, Ep = real_width(packed), packed_width(packed)
    frag = fragment_ordered(packed)
    out = {}
    for name, (rows, cols) in _pad_index(E, Ep).items():
        x = packed[name]
        if name in MATMUL_WEIGHTS and frag:
            x = from_fragment_order(x)
        x = x.float()
        if rows is not None:
            x = x.index_select(-2, torch.as_tensor(rows, device=x.device))
        out[name] = x.index_select(-1, torch.as_tensor(cols, device=x.device))
    return out


def matmul_weights(packed: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """The packed matmul weights as row-major ``[.., K, N]`` f32 at the real
    width."""
    w = gnn_weights(packed)
    return {k: w[k] for k in MATMUL_WEIGHTS}


class AnyPlan(NamedTuple):
    """How ``csrc/superglue_gnn_any.cu`` runs a shape: the route (also the
    launch's name), the padded width, the pairs a CTA holds, its rows, its
    shared memory in bytes, and the row of the CTA's first hint where its
    rows are set-major (the tensor-core route and the wide route: objects
    of all its pairs, then their hints, each set in 16-row tiles; ``None``
    on the f32 shared route, whose rows go pair by pair)."""
    route: str
    width: int
    pairs: int
    rows: int
    smem: int
    hint_row: Optional[int]


MAX_TC_ROWS = 64    # 4 m-tiles: the tensor-core route's accumulators
MAX_F32_ROWS = 64   # 8 row lanes of 8 rows: the f32 route's thread tiles
# The wide route (superglue_gnn_any.cu, namespace wide): one persistent CTA
# an SM of an H100; its rows in a global workspace slice, at most one
# m-chunk of 128 rows, so that each weight k-slice it stages serves all of
# them; its stages' shared memory by dtype.
H100_SMS = 132
WIDE_MAX_ROWS = 128
WIDE_SMEM = {torch.bfloat16: 204800, torch.float32: 86016}
# What the wide route's CTAs re-read from L2 within a product (its input
# rows, R x K, read again for every n-chunk of columns) is held under this
# many bytes over all resident CTAs at the largest K, 2·Ep: H100's L2
# holds 50 MB, and the weights stream through it beside the rows.
WIDE_L2_BUDGET = 40_000_000


def set_major_rows(G: int, T0: int, T1: int) -> int:
    """Rows of G pairs set-major: their objects, then their hints, each set
    padded to a multiple of 16."""
    return 16 * (-(-G * T0 // 16) + -(-G * T1 // 16))


def wide_hot_bytes(Ep: int, rows: int, dtype: torch.dtype) -> int:
    """Bytes the wide route's resident CTAs (one an SM) re-read from L2
    within a product: every CTA's rows at K = 2·Ep."""
    return H100_SMS * rows * 2 * Ep * (2 if dtype == torch.bfloat16 else 4)


def wide_plan(E: int, T0: int, T1: int, dtype: torch.dtype) -> AnyPlan:
    """The wide route's plan: the most pairs G whose set-major rows fit in
    one m-chunk (``WIDE_MAX_ROWS``) and whose re-read rows stay within
    ``WIDE_L2_BUDGET`` (``wide_hot_bytes``), and at least one."""
    Ep = padded_width(E, dtype)
    g = 1
    while set_major_rows(g + 1, T0, T1) <= WIDE_MAX_ROWS and wide_hot_bytes(
            Ep, set_major_rows(g + 1, T0, T1), dtype) <= WIDE_L2_BUDGET:
        g += 1
    return AnyPlan("superglue_gnn_any_wide", Ep, g,
                   set_major_rows(g, T0, T1), WIDE_SMEM[dtype],
                   16 * -(-g * T0 // 16))


def any_plan(E: int, T0: int, T1: int, dtype: torch.dtype) -> AnyPlan:
    """The second form's route at (E, T0, T1): the most pairs G whose rows
    fit in a CTA's rows and in an H100 CTA's shared memory (bf16: objects
    then hints, each set padded to a multiple of 16, at most 64 rows of
    2·(2·Ep + 8) bf16; f32: G·(T0 + T1) rows of 2·(2·Ep + 4) floats, at
    most 64), or the wide route (``wide_plan``: G pairs a CTA, their rows
    in global memory) where not even one pair fits or T0 passes
    ``MAX_SHARED_SET``. The kernel computes its layout from G and fails a
    launch whose rows it has no instantiation for."""
    Ep = padded_width(E, dtype)
    bf16 = dtype == torch.bfloat16
    if T0 > MAX_SHARED_SET:
        return wide_plan(E, T0, T1, dtype)
    if bf16:
        def rows(g):
            return set_major_rows(g, T0, T1)
        cap, row_bytes = MAX_TC_ROWS, 2 * (2 * Ep + 8) * 2
    else:
        def rows(g):
            return g * (T0 + T1)
        cap, row_bytes = MAX_F32_ROWS, 2 * (2 * Ep + 4) * 4
    g = 0
    while rows(g + 1) <= cap and rows(g + 1) * row_bytes <= SMEM_OPTIN:
        g += 1
    if g == 0:
        return wide_plan(E, T0, T1, dtype)
    return AnyPlan("superglue_gnn_any", Ep, g, rows(g), rows(g) * row_bytes,
                   16 * -(-g * T0 // 16) if bf16 else None)


def gnn_scores_plain(desc0: torch.Tensor, desc1: torch.Tensor,
                     packed: Dict[str, torch.Tensor],
                     acc: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch twin of the kernels: desc0 [N, T0, E], desc1 [N, T1, E]
    → scores [N, T0, T1] f32, on the pack's weights stripped to the real
    width E. The residual stream is f32; values the JAX eval path rounds to
    the compute dtype are rounded here too. ``acc=torch.float64`` keeps the
    sums and the residual in float64, at the same rounding points: an
    evaluation nearly free of summation-order error, against which checks
    on the card weigh the kernels and this f32 version alike."""
    dt = packed["wqkv"].dtype

    def rnd(x):
        return x.to(dt).to(acc)

    N, T0, E = desc0.shape
    if real_width(packed) != E:
        raise ValueError(f"GNN weights of width {real_width(packed)} on "
                         f"descriptors of width {E}")
    weights = {k: v.to(acc) for k, v in gnn_weights(packed).items()}

    def w(name, l=None):
        x = weights[name]
        return x if l is None else x[l]

    D = E // HEADS
    res = torch.cat([desc0, desc1], dim=1).to(acc)     # [N, T0+T1, E]
    set1 = torch.arange(res.shape[1], device=res.device) >= T0
    L = packed["wqkv"].shape[0]
    for l in range(L):
        cross = l % 2 == 1
        a = rnd(res)
        qkv = rnd(a @ w("wqkv", l) + w("bqkv", l))
        q, k, v = (x.unflatten(-1, (HEADS, D)) for x in qkv.split(E, -1))
        sets = ((slice(0, T0), slice(T0, None)), (slice(T0, None),
                                                  slice(0, T0)))
        msg = torch.empty_like(q)
        for own, other in sets:
            src = other if cross else own
            s = torch.einsum("bnhd,bmhd->bhnm", q[:, own], k[:, src])
            p = rnd(torch.softmax(s / math.sqrt(D), dim=-1))
            msg[:, own] = torch.einsum("bhnm,bmhd->bnhd", p, v[:, src])
        m = rnd(rnd(msg.flatten(2)) @ w("wm", l) + w("bm", l))
        h = torch.cat([a, m], dim=-1) @ w("w0", l)
        s0 = torch.where(set1[:, None], w("s0", l)[1], w("s0", l)[0])
        t0 = torch.where(set1[:, None], w("t0", l)[1], w("t0", l)[0])
        h1 = rnd(torch.relu(h * s0 + t0))
        res = res + rnd(h1 @ w("w1", l) + w("b1", l))
    md = rnd(rnd(res) @ w("wf") + w("bf"))
    return (md[:, :T0] @ md[:, T0:].transpose(1, 2) / math.sqrt(E)).float()


def _check_any_shape(desc0, desc1) -> None:
    """What JAX's kernel and model refuse: 4 heads of whole channels (E a
    positive multiple of 4, ``d_model % num_heads``), T1 > T0 or empty
    sets, mismatched batches or widths."""
    N, T0, E = desc0.shape
    T1 = desc1.shape[1]
    if tuple(desc1.shape) != (N, T1, E) or E % 4 or E < 4 \
            or not 1 <= T1 <= T0:
        raise ValueError(
            f"GNN kernel takes [N, T0, E] x [N, T1, E] with E a positive "
            f"multiple of 4 and 1 <= T1 <= T0, got {tuple(desc0.shape)} x "
            f"{tuple(desc1.shape)}")


def _check_weights(packed, E, L, dt, desc0) -> int:
    """Raises unless ``packed`` is a pack of width E in dtype ``dt``, L
    blocks, on the descriptors' device; returns its padded width."""
    Ep = padded_width(E, dt)
    frag = dt == torch.bfloat16
    for name in MATMUL_WEIGHTS:
        k, n = _padded_shape(name, (), Ep)
        want = (n // 8, k // 16, 32, 4) if frag else (k, n)
        want = want if name == "wf" else (L, *want)
        if packed[name].dtype != dt or tuple(packed[name].shape) != want:
            raise ValueError(f"GNN kernel: weight {name} must be {dt} "
                             f"{want}, got {packed[name].dtype} "
                             f"{tuple(packed[name].shape)}")
    for name in ("bqkv", "bm", "s0", "t0", "b1", "bf"):
        lead = () if name == "bf" else (L, 2) if name in ("s0", "t0") \
            else (L,)
        want = _padded_shape(name, lead, Ep)
        if packed[name].dtype != torch.float32 or \
                tuple(packed[name].shape) != want:
            raise ValueError(f"GNN kernel: {name} must be float32 {want}, "
                             f"got {packed[name].dtype} "
                             f"{tuple(packed[name].shape)}")
    if real_width(packed) != E:
        raise ValueError(f"GNN kernel: weights of width {real_width(packed)}"
                         f" on descriptors of width {E}")
    for name, x in packed.items():
        if name != "width" and (x.device != desc0.device
                                or not x.is_contiguous()):
            raise ValueError(f"GNN kernel: weight {name} must be contiguous "
                             "on the descriptors' device")
    return Ep


def any_workspace_bytes(E: int, T0: int, T1: int, plan: AnyPlan,
                        n_pairs: int, bf16: int, device) -> int:
    """``t2p_superglue_gnn_any_workspace``: the bytes of global workspace a
    launch of ``plan`` on ``n_pairs`` pairs needs on the card ``device``."""
    nbytes = ctypes.c_longlong(0)
    size = _build.entry("superglue_gnn_any", "t2p_superglue_gnn_any_workspace",
                        [ctypes.c_int] * 8 + [ctypes.c_void_p])
    with torch.cuda.device(device):
        _build.check(size(E, plan.width, T0, T1, bf16,
                          int(plan.route == "superglue_gnn_any_wide"),
                          plan.pairs, n_pairs, ctypes.byref(nbytes)),
                     f"{plan.route} workspace")
    return nbytes.value


def _gnn_any_kernel(desc0, desc1, packed):
    """``csrc/superglue_gnn_any.cu``: any shape ``_check_any_shape`` takes,
    on the route ``any_plan`` gives; the launch is counted under the
    route's name."""
    _build.refuse_grad("GNN kernel", desc0, desc1, *packed.values())
    _check_any_shape(desc0, desc1)
    N, T0, E = desc0.shape
    T1 = desc1.shape[1]
    dt = packed["wqkv"].dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"GNN kernel: unsupported compute dtype {dt}")
    L = packed["wqkv"].shape[0]
    Ep = _check_weights(packed, E, L, dt, desc0)
    if desc1.device != desc0.device:
        raise ValueError("GNN kernel: desc0 and desc1 on different devices")
    desc0 = desc0.float().contiguous()
    desc1 = desc1.float().contiguous()
    out = torch.empty(N, T0, T1, device=desc0.device, dtype=torch.float32)
    if N == 0:
        return out
    plan = any_plan(E, T0, T1, dt)
    bf16 = int(dt == torch.bfloat16)
    route = int(plan.route == "superglue_gnn_any_wide")
    nbytes = any_workspace_bytes(E, T0, T1, plan, N, bf16, desc0.device)
    ws = (torch.empty(nbytes, dtype=torch.uint8, device=desc0.device)
          if nbytes else None)
    fn = _build.entry("superglue_gnn_any", "t2p_superglue_gnn_any",
                      [ctypes.c_void_p] * 13 + [ctypes.c_int] * 9
                      + [ctypes.c_void_p] * 3)
    p = packed
    _build.launch(fn, desc0.device, plan.route, desc0.data_ptr(),
                  desc1.data_ptr(), p["wqkv"].data_ptr(),
                  p["bqkv"].data_ptr(), p["wm"].data_ptr(),
                  p["bm"].data_ptr(), p["w0"].data_ptr(),
                  p["s0"].data_ptr(), p["t0"].data_ptr(),
                  p["w1"].data_ptr(), p["b1"].data_ptr(),
                  p["wf"].data_ptr(), p["bf"].data_ptr(), L, N, E, Ep, T0,
                  T1, bf16, route, plan.pairs,
                  None if ws is None else ws.data_ptr(), out.data_ptr())
    _build.LAUNCHES[plan.route] += 1
    return out


def _gnn_kernel(desc0, desc1, packed):
    """The tuned kernel at ``KERNEL_SHAPE``, the second form elsewhere."""
    N, T0, E = desc0.shape
    T1 = desc1.shape[1]
    if (E, T0, T1) != KERNEL_SHAPE:
        return _gnn_any_kernel(desc0, desc1, packed)
    _build.refuse_grad("GNN kernel", desc0, desc1, *packed.values())
    if tuple(desc1.shape) != (N, T1, E):
        raise ValueError(f"GNN kernel: desc1 {tuple(desc1.shape)} does not "
                         f"pair with desc0 {tuple(desc0.shape)}")
    dt = packed["wqkv"].dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"GNN kernel: unsupported compute dtype {dt}")
    L = packed["wqkv"].shape[0]
    _check_weights(packed, E, L, dt, desc0)
    if desc1.device != desc0.device:
        raise ValueError("GNN kernel: desc0 and desc1 on different devices")
    desc0 = desc0.float().contiguous()
    desc1 = desc1.float().contiguous()
    out = torch.empty(N, T0, T1, device=desc0.device, dtype=torch.float32)
    if N == 0:
        return out
    fn = _build.entry("superglue_gnn", "t2p_superglue_gnn",
                      [ctypes.c_void_p] * 13 + [ctypes.c_int] * 3
                      + [ctypes.c_void_p] * 2)
    p = packed
    _build.launch(fn, desc0.device, "superglue_gnn", desc0.data_ptr(),
                  desc1.data_ptr(), p["wqkv"].data_ptr(),
                  p["bqkv"].data_ptr(), p["wm"].data_ptr(),
                  p["bm"].data_ptr(), p["w0"].data_ptr(),
                  p["s0"].data_ptr(), p["t0"].data_ptr(),
                  p["w1"].data_ptr(), p["b1"].data_ptr(),
                  p["wf"].data_ptr(), p["bf"].data_ptr(), L, N,
                  int(dt == torch.bfloat16), out.data_ptr())
    _build.LAUNCHES["superglue_gnn"] += 1
    return out


def f32_pairs(n_pairs: int, device=None) -> int:
    """The pairs a CTA of the tuned f32 kernel for a launch on ``n_pairs``
    pairs on the card ``device`` (the kernel's own rule,
    ``t2p_superglue_gnn_f32_pairs``: 4, or 2 or 1 where 4 would leave SMs
    idle)."""
    g = ctypes.c_int(0)
    fn = _build.entry("superglue_gnn", "t2p_superglue_gnn_f32_pairs",
                      [ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(device):
        _build.check(fn(n_pairs, ctypes.byref(g)), "superglue_gnn f32 pairs")
    return g.value


def gnn_scores(desc0: torch.Tensor, desc1: torch.Tensor,
               packed: Dict[str, torch.Tensor]) -> torch.Tensor:
    """All GNN blocks + final projection + score matrix; a CUDA kernel on
    the card (the tuned one at ``KERNEL_SHAPE``, ``superglue_gnn_any.cu``
    at other shapes), the plain version on the CPU."""
    if desc0.is_cuda:
        return _gnn_kernel(desc0, desc1, packed)
    return gnn_scores_plain(desc0, desc1, packed)
