"""Fused SuperGlue attention GNN in eval mode (counterpart of
``text2pos_tpu/ops/superglue_gnn_pallas.py``).

``fold_gnn_params`` stacks the 2·num_layers blocks' weights and folds the
calibrated per-set BatchNorm (``bn_stat_groups=2``) into per-set affines
``s0``/``t0``; ``pack_gnn_params`` lays them out for the kernel. The kernel
``csrc/superglue_gnn.cu`` (replacing the Pallas kernel
``superglue_gnn_pallas.py:253``) runs every self/cross block, the final
projection and the ``[N, 16, 6]`` score matrix scaled by 1/√E in one launch.
``gnn_scores_plain`` repeats its arithmetic, rounding included, in PyTorch.

Operations bound the function on the H100 (about 89 MFLOP a pair against
14.7 KB moved), so the bf16 kernel runs its dense products on the tensor
cores (``mma.sync`` m16n8k16, f32 accumulation). Two things of its design
live here, in index code that runs anywhere:

- bf16 matmul weights are stored in the order of the instruction's B
  fragments (``to_fragment_order``), so that a warp reads its operand from
  global memory as one contiguous 8-byte load per lane and keeps no weight
  in shared memory; ``from_fragment_order`` is the inverse, which the plain
  version uses.
- a CTA holds ``TC_PAIRS`` pairs' rows set-major: all object rows, then all
  hint rows, then zero rows up to a multiple of 16, so that a 16-row tile
  belongs to one set. The kernel computes that layout itself; the wrapper
  only needs the pair count a CTA takes to say what "ragged" means.

The f32 kernel (f32 FMAs on the CUDA cores) keeps row-major weights.

Both kernels of ``csrc/superglue_gnn.cu`` are built for ``KERNEL_SHAPE``
alone. Every other shape JAX's configurations give (E a multiple of 4 up to
``MAX_WIDTH``, 1 ≤ T1 ≤ T0 ≤ ``MAX_SET``: JAX's default E = 300, ``pad_size``
24) goes to the second form, ``csrc/superglue_gnn_any.cu``, in f32 or bf16,
with row-major weights (``pack_gnn_params`` gives bf16 weights fragment
order where E is a multiple of 16, and the wrapper unpacks them for that
form). That
form pads nothing: its heads are E/4 channels wide, the scales 1/√(E/4)
and 1/√E.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict

import numpy as np
import torch

from text2pos_torch.ops import _build

HEADS = 4
KERNEL_SHAPE = (128, 16, 6)   # E, objects per cell, hints per query
MAX_WIDTH = 512               # superglue_gnn_any.cu: E a multiple of 4
MAX_SET = 32                  # and 1 <= T1 <= T0 <= MAX_SET
TC_PAIRS = 4                  # pairs per CTA of the bf16 kernel
MATMUL_WEIGHTS = ("wqkv", "wm", "w0", "w1", "wf")
UNSTACKED = ("wf", "bf")      # the final projection; the rest are per block


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


def pack_gnn_params(folded: Dict[str, np.ndarray], dtype: torch.dtype,
                    device) -> Dict[str, torch.Tensor]:
    """Kernel layout: q|k|v fused to ``wqkv`` ([L, E, 3E] before ordering);
    matmul weights in the compute dtype, row-major ``[.., K, N]`` in f32 and
    at widths that are no multiple of 16 (300), in fragment order
    ``[.., N/8, K/16, 32, 4]`` in bf16 otherwise (the tuned kernel's at
    E = 128); biases and BN affines in f32."""
    def t(a, dt=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device,
                                                           dtype=dt)

    frag = dtype == torch.bfloat16 and folded["wq"].shape[-1] % 16 == 0
    order = to_fragment_order if frag else (lambda a: a)
    out = {
        "wqkv": np.concatenate([folded["wq"], folded["wk"], folded["wv"]],
                               axis=2),
        "bqkv": np.concatenate([folded["bq"], folded["bk"], folded["bv"]],
                               axis=1),
        **{k: folded[k] for k in ("wm", "bm", "w0", "s0", "t0", "w1", "b1",
                                  "wf", "bf")}}
    return {k: t(order(a), dtype) if k in MATMUL_WEIGHTS else t(a)
            for k, a in out.items()}


def fragment_ordered(packed: Dict[str, torch.Tensor]) -> bool:
    """Whether ``packed``'s matmul weights are in fragment order (stacked
    ``[L, N/8, K/16, 32, 4]``) rather than row-major ``[L, K, N]``."""
    return packed["wqkv"].dim() == 5


def matmul_weights(packed: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """The packed matmul weights as row-major ``[.., K, N]`` f32."""
    frag = fragment_ordered(packed)
    return {k: (from_fragment_order(packed[k]) if frag else packed[k]).float()
            for k in MATMUL_WEIGHTS}


def gnn_scores_plain(desc0: torch.Tensor, desc1: torch.Tensor,
                     packed: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: desc0 [N, T0, E], desc1 [N, T1, E]
    → scores [N, T0, T1] f32. The residual stream is f32; values the JAX
    eval path rounds to the compute dtype are rounded here too."""
    dt = packed["wqkv"].dtype

    def rnd(x):
        return x.to(dt).float()

    mats = matmul_weights(packed)

    def w(name, l=None):
        x = mats[name] if name in mats else packed[name].float()
        return x if l is None else x[l]

    N, T0, E = desc0.shape
    D = E // HEADS
    res = torch.cat([desc0, desc1], dim=1).float()     # [N, T0+T1, E]
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
    return md[:, :T0] @ md[:, T0:].transpose(1, 2) / math.sqrt(E)


def _check_any_shape(desc0, desc1) -> None:
    N, T0, E = desc0.shape
    T1 = desc1.shape[1]
    if tuple(desc1.shape) != (N, T1, E) or E % 4 or not 4 <= E <= MAX_WIDTH \
            or not 1 <= T1 <= T0 <= MAX_SET:
        raise ValueError(
            f"GNN kernel takes [N, T0, E] x [N, T1, E] with E a multiple of 4 "
            f"in [4, {MAX_WIDTH}] and 1 <= T1 <= T0 <= {MAX_SET}, got "
            f"{tuple(desc0.shape)} x {tuple(desc1.shape)}")


def _check_weights(packed, E, L, dt, frag, desc0) -> None:
    kn = {"wqkv": (E, 3 * E), "wm": (E, E), "w0": (2 * E, 2 * E),
          "w1": (2 * E, E), "wf": (E, E)}
    for name, (k, n) in kn.items():
        want = (n // 8, k // 16, 32, 4) if frag else (k, n)
        want = want if name == "wf" else (L, *want)
        if packed[name].dtype != dt or tuple(packed[name].shape) != want:
            raise ValueError(f"GNN kernel: weight {name} must be {dt} "
                             f"{want}, got {packed[name].dtype} "
                             f"{tuple(packed[name].shape)}")
    for name, x in packed.items():
        if x.device != desc0.device or not x.is_contiguous():
            raise ValueError(f"GNN kernel: weight {name} must be contiguous "
                             "on the descriptors' device")


def _gnn_any_kernel(desc0, desc1, packed):
    """``csrc/superglue_gnn_any.cu``: any shape ``_check_any_shape`` takes,
    row-major weights (fragment-ordered ones unpacked first)."""
    _build.refuse_grad("GNN kernel", desc0, desc1, *packed.values())
    _check_any_shape(desc0, desc1)
    N, T0, E = desc0.shape
    T1 = desc1.shape[1]
    dt = packed["wqkv"].dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"GNN kernel: unsupported compute dtype {dt}")
    L = packed["wqkv"].shape[0]
    frag = fragment_ordered(packed)
    _check_weights(packed, E, L, dt, frag, desc0)
    if frag:
        packed = dict(packed, **{k: v.to(dt).contiguous()
                                 for k, v in matmul_weights(packed).items()})
    if desc1.device != desc0.device:
        raise ValueError("GNN kernel: desc0 and desc1 on different devices")
    desc0 = desc0.float().contiguous()
    desc1 = desc1.float().contiguous()
    out = torch.empty(N, T0, T1, device=desc0.device, dtype=torch.float32)
    if N == 0:
        return out
    bf16 = int(dt == torch.bfloat16)
    nbytes = ctypes.c_longlong(0)
    size = _build.entry("superglue_gnn_any", "t2p_superglue_gnn_any_workspace",
                        [ctypes.c_int] * 5 + [ctypes.c_void_p])
    with torch.cuda.device(desc0.device):
        _build.check(size(E, T0, T1, bf16, N, ctypes.byref(nbytes)),
                     "superglue_gnn_any workspace")
    ws = (torch.empty(nbytes.value, dtype=torch.uint8, device=desc0.device)
          if nbytes.value else None)
    fn = _build.entry("superglue_gnn_any", "t2p_superglue_gnn_any",
                      [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6
                      + [ctypes.c_void_p] * 3)
    p = packed
    _build.launch(fn, desc0.device, "superglue_gnn_any", desc0.data_ptr(),
                  desc1.data_ptr(), p["wqkv"].data_ptr(),
                  p["bqkv"].data_ptr(), p["wm"].data_ptr(),
                  p["bm"].data_ptr(), p["w0"].data_ptr(),
                  p["s0"].data_ptr(), p["t0"].data_ptr(),
                  p["w1"].data_ptr(), p["b1"].data_ptr(),
                  p["wf"].data_ptr(), p["bf"].data_ptr(), L, N, E, T0, T1,
                  bf16, None if ws is None else ws.data_ptr(),
                  out.data_ptr())
    _build.LAUNCHES["superglue_gnn_any"] += 1
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
    _check_weights(packed, E, L, dt, dt == torch.bfloat16, desc0)
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


def gnn_scores(desc0: torch.Tensor, desc1: torch.Tensor,
               packed: Dict[str, torch.Tensor]) -> torch.Tensor:
    """All GNN blocks + final projection + score matrix; a CUDA kernel on
    the card (the tuned one at ``KERNEL_SHAPE``, ``superglue_gnn_any.cu``
    at other shapes), the plain version on the CPU."""
    if desc0.is_cuda:
        return _gnn_kernel(desc0, desc1, packed)
    return gnn_scores_plain(desc0, desc1, packed)
