"""SuperGlue attentional matching for inference (counterpart of
``text2pos_tpu/models/superglue.py``).

Descriptors are [B, N, E]. Heads are contiguous channel blocks
(``reshape(B, N, heads, E/heads)``), as in JAX, not torch's interleaved
split. On the card, a calibrated ``SuperGlue.forward`` runs the fused GNN
kernel (``ops/superglue_gnn.py``) on the folded weights and then the
Sinkhorn kernel; on the CPU it runs the module form below, which the tests
hold against the flax model. ``forward(..., num_layers=p)`` runs the first
p block pairs of the same weights (the cascade's cheap pass; JAX's
truncated clone), on the card through the same kernel with the first 2p
entries of the one folded stack.

With ``eval_batch_stats`` (``blocks.set_eval_batch_stats``: the
uncalibrated JAX fine model) the block BNs
normalize each descriptor set by its batch's statistics. The kernel folds
calibrated per-set statistics into its weights and cannot take those, and
JAX runs no Pallas GNN kernel in that mode either, so the module form then
runs on the card too; Sinkhorn still runs its kernel. ``calibrating``
(``blocks.py``) writes the two sets' statistics into the BN rows 0 and 1
(``stat_groups=2``). ``fast_graph`` is JAX's opt-in module form: q/k/v as
one product over the concatenated kernels (k/v as one in cross-attention,
``blocks.DenseParams``) and the concat-free block MLP
(``blocks.FastSuperGlueMLP``), the same parameters and the same function up
to f32 reassociation. The serving pipeline takes it under JAX's switch
``T2P_FAST_GRAPH=1`` (``with_fast_graph``). The kernel reads the same
folded weights either way, so the form changes the module form's
arithmetic only: the plain path and the batch-statistics calibration.

In train mode (``blocks.train_mode``) the GNN runs as PyTorch ops on batch
statistics, as JAX trains it, and the Sinkhorn goes through its autograd
Function (``ops.sinkhorn.LogOptimalTransport``): the kernel forward, the
plain version's gradient. The kernel's fold is cached against the
parameters' and statistics' ``_version`` counters, so an optimizer step or
a running-statistics update makes the next eval-mode call fold again.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional

import torch
from torch import nn

from text2pos_torch.models.blocks import (DenseParams, FastSuperGlueMLP,
                                          SuperGlueMLP, dense,
                                          set_eval_batch_stats, tensor_slots,
                                          weights_key)
from text2pos_torch.ops.sinkhorn import extract_matches, log_optimal_transport
from text2pos_torch.ops.superglue_gnn import (UNSTACKED, fold_gnn_params,
                                              gnn_scores, pack_gnn_params,
                                              widen_gnn_stats)


class MultiHeadedAttention(nn.Module):
    def __init__(self, num_heads: int, d_model: int,
                 dtype: Optional[torch.dtype] = None,
                 fast_graph: bool = False):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.fast_graph = fast_graph
        proj = DenseParams if fast_graph else nn.Linear
        for name in ("proj_q", "proj_k", "proj_v"):
            self.add_module(name, proj(d_model, d_model))
        self.merge = nn.Linear(d_model, d_model)

    def _fused(self, query, key):
        """q, k, v [B, N, E] in the compute dtype from one product over the
        concatenated kernels (self-attention), or q alone and k|v as one
        (cross-attention)."""
        dt = self.dtype or torch.float32
        (kq, bq), (kk, bk), (kv, bv) = (self.proj_q(), self.proj_k(),
                                        self.proj_v())

        def mm(x, w, b):
            return ((x.to(dt) @ w.to(dt)).float() + b.to(dt).float()).to(dt)

        if query is key:
            return mm(query, torch.cat([kq, kk, kv], 1),
                      torch.cat([bq, bk, bv])).chunk(3, -1)
        k, v = mm(key, torch.cat([kk, kv], 1), torch.cat([bk, bv])).chunk(
            2, -1)
        return mm(query, kq, bq), k, v

    def forward(self, query, key, value):
        dim = query.shape[-1] // self.num_heads
        dt = self.dtype or torch.float32
        heads = lambda h: h.unflatten(-1, (self.num_heads, dim))
        if self.fast_graph:
            q, k, v = map(heads, self._fused(query, key))
        else:
            q, k, v = (heads(dense(layer, x, dt).to(dt)) for layer, x in (
                (self.proj_q, query), (self.proj_k, key),
                (self.proj_v, value)))
        # Logits and softmax in f32 whatever the compute dtype.
        scores = torch.einsum("bnhd,bmhd->bnmh", q.float(), k.float())
        prob = torch.softmax(scores / math.sqrt(dim), dim=2).to(v.dtype)
        out = torch.einsum("bnmh,bmhd->bnhd", prob, v).flatten(2)
        return dense(self.merge, out, dt).to(dt)


class AttentionalPropagation(nn.Module):
    """delta = MLP([x, attn(x, source)])."""

    def __init__(self, feature_dim: int, num_heads: int = 4,
                 dtype: Optional[torch.dtype] = None, stat_groups: int = 1,
                 fast_graph: bool = False):
        super().__init__()
        self.fast_graph = fast_graph
        self.attn = MultiHeadedAttention(num_heads, feature_dim, dtype,
                                         fast_graph)
        self.mlp = (FastSuperGlueMLP(feature_dim, dtype, stat_groups)
                    if fast_graph else
                    SuperGlueMLP(2 * feature_dim,
                                 (2 * feature_dim, feature_dim), dtype,
                                 stat_groups))

    def forward(self, x, source, stat_group: int = 0):
        message = self.attn(x, source, source)
        if self.fast_graph:
            return self.mlp(x, message.to(x.dtype), stat_group)
        return self.mlp(torch.cat([x, message.to(x.dtype)], dim=-1),
                        stat_group)


class AttentionalGNN(nn.Module):
    """Alternating self/cross blocks; each block's weights serve both sets,
    each set normalized by its own statistics row."""

    def __init__(self, feature_dim: int, num_blocks: int,
                 dtype: Optional[torch.dtype] = None, stat_groups: int = 1,
                 fast_graph: bool = False):
        super().__init__()
        self.num_blocks, self.stat_groups = num_blocks, stat_groups
        for i in range(num_blocks):
            self.add_module(f"layer_{i}", AttentionalPropagation(
                feature_dim, dtype=dtype, stat_groups=stat_groups,
                fast_graph=fast_graph))

    def forward(self, desc0, desc1, num_blocks: Optional[int] = None):
        """The first ``num_blocks`` blocks (all when None)."""
        for i in range(self.num_blocks if num_blocks is None
                       else num_blocks):
            layer = getattr(self, f"layer_{i}")
            src0, src1 = (desc1, desc0) if i % 2 else (desc0, desc1)
            delta0 = layer(desc0, src0, stat_group=0)
            delta1 = layer(desc1, src1,
                           stat_group=min(1, self.stat_groups - 1))
            desc0 = desc0 + delta0.to(desc0.dtype)
            desc1 = desc1 + delta1.to(desc1.dtype)
        return desc0, desc1


class SuperGlue(nn.Module):
    """GNN + final projection + scores + Sinkhorn + match extraction."""

    def __init__(self, descriptor_dim: int, num_layers: int = 6,
                 sinkhorn_iterations: int = 50, match_threshold: float = 0.2,
                 dtype: Optional[torch.dtype] = None, stat_groups: int = 1,
                 fast_graph: bool = False):
        super().__init__()
        self.fast_graph = fast_graph
        self.descriptor_dim, self.num_layers = descriptor_dim, num_layers
        self.sinkhorn_iterations = sinkhorn_iterations
        self.match_threshold, self.dtype = match_threshold, dtype
        self.eval_batch_stats = False      # blocks.set_eval_batch_stats
        self.train_stats = False           # blocks.train_mode
        self.gnn = AttentionalGNN(descriptor_dim, 2 * num_layers, dtype,
                                  stat_groups, fast_graph)
        self.final_proj = nn.Linear(descriptor_dim, descriptor_dim)
        self.bin_score = nn.Parameter(torch.tensor(1.0))
        self._packed = None
        self._slots = tensor_slots(self)

    def packed_kernel_params(self, num_layers: Optional[int] = None
                             ) -> Dict[str, torch.Tensor]:
        """The GNN kernel's folded weights of the first ``num_layers`` block
        pairs (all when None): views of the first 2·num_layers entries of
        one cached fold of every block (stacks are ordered by block; the
        final projection is shared), kept until a weight or statistic
        changes (``weights_key``: loaded, moved, calibrated or stepped)."""
        dev = self.final_proj.weight.device
        key = weights_key(self._slots)
        if self._packed is None or self._packed[0] != key:
            from text2pos_torch.utils.convert_jax import module_to_jax

            params, stats = module_to_jax(self)
            widen_gnn_stats(stats["gnn"])         # one row → both sets
            folded = fold_gnn_params({"superglue": params},
                                     {"superglue": stats}, self.num_layers)
            self._packed = key, pack_gnn_params(
                folded, self.dtype or torch.float32, dev)
        p = self.num_layers if num_layers is None else num_layers
        self._check_depth(p)
        return {k: v if k in UNSTACKED else v[:2 * p]
                for k, v in self._packed[1].items()}

    def _check_depth(self, num_layers: int) -> None:
        if not 0 <= num_layers <= self.num_layers:
            raise ValueError(f"{num_layers} block pairs asked of a matcher "
                             f"of {self.num_layers}")

    def scores(self, desc0: torch.Tensor, desc1: torch.Tensor,
               num_layers: Optional[int] = None) -> torch.Tensor:
        """Pre-Sinkhorn [B, M, N] f32 scores after the first ``num_layers``
        block pairs (all when None): the fused GNN kernel on the card when
        calibrated, the module form otherwise."""
        if desc0.is_cuda and not (self.eval_batch_stats or self.train_stats):
            return gnn_scores(desc0, desc1,
                              self.packed_kernel_params(num_layers))
        p = self.num_layers if num_layers is None else num_layers
        self._check_depth(p)
        if p > 0:
            desc0, desc1 = self.gnn(desc0, desc1, 2 * p)
        dt = self.dtype or torch.float32
        md0 = dense(self.final_proj, desc0, dt).to(dt)
        md1 = dense(self.final_proj, desc1, dt).to(dt)
        s = torch.einsum("bmd,bnd->bmn", md0.float(), md1.float())
        return s / math.sqrt(self.descriptor_dim)

    def forward(self, desc0: torch.Tensor, desc1: torch.Tensor,
                num_layers: Optional[int] = None,
                sinkhorn_iterations: Optional[int] = None
                ) -> Dict[str, torch.Tensor]:
        """desc0 [B, M, E] objects, desc1 [B, N, E] hints → P, log_P
        [B, M+1, N+1], matches0/1 and matching_scores0/1. ``num_layers``
        and ``sinkhorn_iterations`` cut the depth (the model's when
        None)."""
        iters = (self.sinkhorn_iterations if sinkhorn_iterations is None
                 else sinkhorn_iterations)
        Z = log_optimal_transport(self.scores(desc0, desc1, num_layers),
                                  self.bin_score, iters)
        out = extract_matches(Z, self.match_threshold)
        out["P"] = Z.exp()
        out["log_P"] = Z
        return out


def fast_graph_requested() -> bool:
    """JAX's switch for the fast module form: ``T2P_FAST_GRAPH=1``."""
    return os.environ.get("T2P_FAST_GRAPH", "0") == "1"


def with_fast_graph(sg: SuperGlue, on: bool = True) -> SuperGlue:
    """A copy of ``sg`` in the fast module form (``on``) or the plain one:
    the same parameters and statistics, BN mode and device."""
    new = SuperGlue(sg.descriptor_dim, sg.num_layers, sg.sinkhorn_iterations,
                    sg.match_threshold, sg.dtype, sg.gnn.stat_groups,
                    fast_graph=on)
    new.load_state_dict(sg.state_dict())
    new.to(sg.final_proj.weight.device)
    set_eval_batch_stats(new, sg.eval_batch_stats)
    for m in new.modules():
        if hasattr(m, "train_stats"):
            m.train_stats = sg.train_stats
    return new.train(sg.training)

