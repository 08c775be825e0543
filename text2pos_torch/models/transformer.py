"""Transformer matcher ablation (counterpart of
``text2pos_tpu/models/transformer.py``): the reference's negative-result
alternates (its models/transformer.py ``TransformerMatch1`` and
models/tf_matcher.py ``TransformerMatch``, "kept for the sake of
completion"), runnable against the fine stage's batches.

Pre-LN transformer blocks run self-attention over the concatenated
[objects ‖ hints] sequence (a learned segment embedding tells them apart),
then the scaled object-hint scores go through log-domain Sinkhorn with a
learned dustbin and mutual-max match extraction, and an offset head reads
the hint tokens; ``with_aux_heads`` adds ``TransformerMatch1``'s class and
colour heads on the object tokens.

The kernels on this path: the hint encoder's bi-LSTM (``ops/lstm.py``),
PointNet++'s FPS and, in eval mode, PointConv (``models/pointnet2.py``),
and the Sinkhorn (``ops/sinkhorn.py``; in a training step through its
autograd Function, whose backward recomputes the plain version). Flax's
``MultiHeadDotProductAttention`` is plain XLA in JAX (no Pallas kernel), so
the attention here is explicit f32 products and a softmax, in flax's
layout: ``query``/``key``/``value`` kernels [E, heads, E/heads] (``DenseGeneral``),
``out`` [heads, E/heads, E], the query scaled by 1/√(E/heads) before its
product with the keys. ``LayerNorm`` is flax's: ε = 1e-6 and the variance
as E[x²] − E[x]². Module and parameter names follow the flax tree
(``block_0.LayerNorm_0.scale``, ``block_0.MultiHeadDotProductAttention_0.
query.kernel``, ``segment_embed``, ``bin_score``), so ``utils/convert_jax.py``
carries JAX's parameters over by name. All f32, as JAX's.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from text2pos_torch.models.blocks import HeadMLP, dense, l2_normalize, train_mode
from text2pos_torch.models.language import LanguageEncoder
from text2pos_torch.models.object_encoder import FEATURES, ObjectEncoder
from text2pos_torch.ops.sinkhorn import extract_matches, log_optimal_transport


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: ε = 1e-6, var = max(E[x²] − E[x]², 0)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.scale + self.bias


class DenseGeneral(nn.Module):
    """flax ``DenseGeneral`` onto (heads, head_dim): kernel [E, H, D]."""

    def __init__(self, in_features: int, heads: int, head_dim: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, heads, head_dim))
        self.bias = nn.Parameter(torch.zeros(heads, head_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, N, E] → [B, N, H, D]."""
        return torch.einsum("bne,ehd->bnhd", x, self.kernel) + self.bias


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention(num_heads, qkv_features=E)`` as
    explicit f32 products: q, k, v projections, q scaled by 1/√D, softmax
    over the keys, the output projection from [H, D] back to E."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"embed dim {dim} is not a multiple of "
                             f"{num_heads} heads")
        self.num_heads, self.head_dim = num_heads, dim // num_heads
        for name in ("query", "key", "value"):
            self.add_module(name, DenseGeneral(dim, num_heads, self.head_dim))
        self.out = nn.Module()
        self.out.kernel = nn.Parameter(torch.zeros(num_heads, self.head_dim,
                                                   dim))
        self.out.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self.query(x) / math.sqrt(self.head_dim)
        k, v = self.key(x), self.value(x)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v)
        return torch.einsum("bqhd,hde->bqe", o, self.out.kernel) + self.out.bias


class TransformerBlock(nn.Module):
    """x + attn(LN(x)), then + MLP(LN(x)) with a 2E hidden ReLU layer."""

    def __init__(self, dim: int, num_heads: int = 4, mlp_ratio: int = 2):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(dim)
        self.MultiHeadDotProductAttention_0 = MultiHeadAttention(dim,
                                                                 num_heads)
        self.LayerNorm_1 = LayerNorm(dim)
        self.Dense_0 = nn.Linear(dim, dim * mlp_ratio)
        self.Dense_1 = nn.Linear(dim * mlp_ratio, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x))
        h = torch.relu(dense(self.Dense_0, self.LayerNorm_1(x)))
        return x + dense(self.Dense_1, h)


class TransformerMatch(nn.Module):
    """Joint-sequence transformer + Sinkhorn matching (JAX's
    ``TransformerMatch``)."""

    def __init__(self, vocab_size: int, embed_dim: int, num_layers: int = 4,
                 sinkhorn_iters: int = 50, num_classes: int = 23,
                 num_colors: int = 9, use_features: Sequence[str] = FEATURES,
                 pointnet_features: int = 2, match_threshold: float = 0.2,
                 with_aux_heads: bool = False):
        super().__init__()
        self.embed_dim, self.num_layers = embed_dim, num_layers
        self.sinkhorn_iters, self.match_threshold = (sinkhorn_iters,
                                                     match_threshold)
        self.with_aux_heads = with_aux_heads
        self.language_encoder = LanguageEncoder(vocab_size, embed_dim)
        self.object_encoder = ObjectEncoder(
            embed_dim, None, (num_classes, num_colors), use_features,
            pointnet_features=pointnet_features)
        self.segment_embed = nn.Parameter(torch.zeros(2, embed_dim))
        for i in range(num_layers):
            self.add_module(f"block_{i}", TransformerBlock(embed_dim))
        self.bin_score = nn.Parameter(torch.tensor(1.0))
        self.mlp_offsets = HeadMLP(embed_dim, (embed_dim // 2, 2))
        if with_aux_heads:
            self.aux_class = nn.Linear(embed_dim, num_classes)
            self.aux_color = nn.Linear(embed_dim, num_colors)

    def forward(self, hint_tokens: torch.Tensor, hint_lengths: torch.Tensor,
                points_xyz: torch.Tensor, points_rgb: torch.Tensor,
                centers: torch.Tensor, colors: torch.Tensor,
                class_idx: Optional[torch.Tensor] = None,
                color_idx: Optional[torch.Tensor] = None,
                train: bool = True) -> Dict[str, torch.Tensor]:
        """[B, H, T] hints against [B, O, P, 3] cell objects → P, log_P
        [B, O+1, H+1], matches0/1, matching_scores0/1, offsets [B, H, 2]
        (and class_pred, color_pred with the aux heads). ``train``: every
        BN on batch statistics with running updates (JAX's ``train=True``),
        else on its running statistics."""
        B, H, T = hint_tokens.shape
        O, P = points_xyz.shape[1], points_xyz.shape[2]
        E = self.embed_dim
        flat = lambda t: None if t is None else t.reshape(B * O)
        with train_mode(self, train):
            hint_enc = self.language_encoder(hint_tokens.reshape(B * H, T),
                                             hint_lengths.reshape(B * H))
            hint_enc = l2_normalize(hint_enc.reshape(B, H, E))
            obj_enc = self.object_encoder(
                points_xyz.reshape(B * O, P, 3),
                points_rgb.reshape(B * O, P, 3), centers.reshape(B * O, 3),
                colors.reshape(B * O, 3), flat(class_idx), flat(color_idx))
            obj_enc = l2_normalize(obj_enc.reshape(B, O, E))
        seg = self.segment_embed
        x = torch.cat([obj_enc + seg[0], hint_enc + seg[1]], dim=1)
        for i in range(self.num_layers):
            x = getattr(self, f"block_{i}")(x)
        obj_out, hint_out = x[:, :O], x[:, O:]
        scores = torch.einsum("bod,bhd->boh", obj_out, hint_out) / (E ** 0.5)
        Z = log_optimal_transport(scores, self.bin_score,
                                  self.sinkhorn_iters)
        out = extract_matches(Z, self.match_threshold)
        out["P"] = Z.exp()
        out["log_P"] = Z
        out["offsets"] = self.mlp_offsets(hint_out)
        if self.with_aux_heads:
            out["class_pred"] = dense(self.aux_class, obj_out)
            out["color_pred"] = dense(self.aux_color, obj_out)
        return out


def init_extra_parameters(model: TransformerMatch, seed: int
                          ) -> TransformerMatch:
    """The parameters ``train.state.init_parameters`` does not draw, as
    flax initializes them, from a generator seeded with ``seed``: the
    attention's kernels LeCun-normal over their input width (truncated at
    two standard deviations), their biases zero, LayerNorm scale 1 and bias
    0, the segment embedding N(0, 0.02²)."""
    gen = torch.Generator().manual_seed(seed)

    def lecun(p: torch.Tensor, fan_in: int) -> None:
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        w = torch.empty(p.shape)
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)
        p.copy_(w)

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, MultiHeadAttention):
                for d in (mod.query, mod.key, mod.value):
                    lecun(d.kernel, d.kernel.shape[0])
                    d.bias.zero_()
                lecun(mod.out.kernel, mod.num_heads * mod.head_dim)
                mod.out.bias.zero_()
            elif isinstance(mod, LayerNorm):
                mod.scale.fill_(1.0)
                mod.bias.zero_()
        model.segment_embed.copy_(0.02 * torch.randn(
            model.segment_embed.shape, generator=gen))
    return model

