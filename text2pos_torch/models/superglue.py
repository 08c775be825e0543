"""SuperGlue attentional matching in eval mode (counterpart of
``text2pos_tpu/models/superglue.py``).

Descriptors are [B, N, E]. Heads are contiguous channel blocks
(``reshape(B, N, heads, E/heads)``), as in JAX, not torch's interleaved
split. On the card, ``SuperGlue.forward`` runs the fused GNN kernel
(``ops/superglue_gnn.py``) on the folded calibrated weights and then the
Sinkhorn kernel; on the CPU it runs the module form below, which the tests
hold against the flax model. ``fast_graph`` is not ported (off by default in
JAX).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from text2pos_torch.models.blocks import SuperGlueMLP, dense
from text2pos_torch.ops.sinkhorn import extract_matches, log_optimal_transport
from text2pos_torch.ops.superglue_gnn import (fold_gnn_params, gnn_scores,
                                              pack_gnn_params)


class MultiHeadedAttention(nn.Module):
    def __init__(self, num_heads: int, d_model: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        for name in ("proj_q", "proj_k", "proj_v", "merge"):
            self.add_module(name, nn.Linear(d_model, d_model))

    def forward(self, query, key, value):
        dim = query.shape[-1] // self.num_heads
        dt = self.dtype or torch.float32

        def proj(layer, x):
            return dense(layer, x, dt).to(dt).unflatten(
                -1, (self.num_heads, dim))

        q, k, v = (proj(self.proj_q, query), proj(self.proj_k, key),
                   proj(self.proj_v, value))
        # Logits and softmax in f32 whatever the compute dtype.
        scores = torch.einsum("bnhd,bmhd->bnmh", q.float(), k.float())
        prob = torch.softmax(scores / math.sqrt(dim), dim=2).to(v.dtype)
        out = torch.einsum("bnmh,bmhd->bnhd", prob, v).flatten(2)
        return dense(self.merge, out, dt).to(dt)


class AttentionalPropagation(nn.Module):
    """delta = MLP([x, attn(x, source)])."""

    def __init__(self, feature_dim: int, num_heads: int = 4,
                 dtype: Optional[torch.dtype] = None, stat_groups: int = 1):
        super().__init__()
        self.attn = MultiHeadedAttention(num_heads, feature_dim, dtype)
        self.mlp = SuperGlueMLP(2 * feature_dim,
                                (2 * feature_dim, feature_dim), dtype,
                                stat_groups)

    def forward(self, x, source, stat_group: int = 0):
        message = self.attn(x, source, source)
        return self.mlp(torch.cat([x, message.to(x.dtype)], dim=-1),
                        stat_group)


class AttentionalGNN(nn.Module):
    """Alternating self/cross blocks; each block's weights serve both sets,
    each set normalized by its own statistics row."""

    def __init__(self, feature_dim: int, num_blocks: int,
                 dtype: Optional[torch.dtype] = None, stat_groups: int = 1):
        super().__init__()
        self.num_blocks, self.stat_groups = num_blocks, stat_groups
        for i in range(num_blocks):
            self.add_module(f"layer_{i}", AttentionalPropagation(
                feature_dim, dtype=dtype, stat_groups=stat_groups))

    def forward(self, desc0, desc1):
        for i in range(self.num_blocks):
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
                 dtype: Optional[torch.dtype] = None, stat_groups: int = 1):
        super().__init__()
        self.descriptor_dim, self.num_layers = descriptor_dim, num_layers
        self.sinkhorn_iterations = sinkhorn_iterations
        self.match_threshold, self.dtype = match_threshold, dtype
        self.gnn = AttentionalGNN(descriptor_dim, 2 * num_layers, dtype,
                                  stat_groups)
        self.final_proj = nn.Linear(descriptor_dim, descriptor_dim)
        self.bin_score = nn.Parameter(torch.tensor(1.0))
        self._packed = None

    def _load_from_state_dict(self, *args, **kwargs):
        self._packed = None   # folded kernel weights are stale
        super()._load_from_state_dict(*args, **kwargs)

    def packed_kernel_params(self) -> Dict[str, torch.Tensor]:
        """The GNN kernel's folded, stacked weights (cached)."""
        dev = self.final_proj.weight.device
        if self._packed is None or self._packed["wqkv"].device != dev:
            from text2pos_torch.utils.convert_jax import module_to_jax

            params, stats = module_to_jax(self)
            for layer in stats["gnn"].values():   # one row → both sets
                bn = layer["mlp"]["bn_0"]
                for key in ("mean", "var"):
                    if bn[key].ndim == 1:
                        bn[key] = bn[key][None].repeat(2, 0)
            folded = fold_gnn_params({"superglue": params},
                                     {"superglue": stats}, self.num_layers)
            self._packed = pack_gnn_params(folded,
                                           self.dtype or torch.float32, dev)
        return self._packed

    def scores(self, desc0: torch.Tensor, desc1: torch.Tensor
               ) -> torch.Tensor:
        """Pre-Sinkhorn [B, M, N] f32 scores: the fused GNN kernel on the
        card, the module form on the CPU."""
        if desc0.is_cuda:
            return gnn_scores(desc0, desc1, self.packed_kernel_params())
        if self.num_layers > 0:
            desc0, desc1 = self.gnn(desc0, desc1)
        dt = self.dtype or torch.float32
        md0 = dense(self.final_proj, desc0, dt).to(dt)
        md1 = dense(self.final_proj, desc1, dt).to(dt)
        s = torch.einsum("bmd,bnd->bmn", md0.float(), md1.float())
        return s / math.sqrt(self.descriptor_dim)

    def forward(self, desc0: torch.Tensor, desc1: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        """desc0 [B, M, E] objects, desc1 [B, N, E] hints → P, log_P
        [B, M+1, N+1], matches0/1 and matching_scores0/1."""
        Z = log_optimal_transport(self.scores(desc0, desc1), self.bin_score,
                                  self.sinkhorn_iterations)
        out = extract_matches(Z, self.match_threshold)
        out["P"] = Z.exp()
        out["log_P"] = Z
        return out
