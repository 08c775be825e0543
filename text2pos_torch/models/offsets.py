"""Offset (direction) regressor (counterpart of
``text2pos_tpu/models/offsets.py``): each hint through the bi-LSTM language
encoder (the LSTM kernel on the card) and a two-layer head, the output
L2-normalized: one unit direction a hint."""

from __future__ import annotations

import torch
from torch import nn

from text2pos_torch.models.blocks import HeadMLP, l2_normalize
from text2pos_torch.models.language import LanguageEncoder


class OffsetRegressor(nn.Module):
    def __init__(self, vocab_size: int, regressor_dim: int = 128):
        super().__init__()
        self.regressor_dim = regressor_dim
        self.language_encoder = LanguageEncoder(vocab_size, regressor_dim)
        self.mlp_offsets = HeadMLP(regressor_dim, (regressor_dim // 2, 2))

    def forward(self, hint_tokens: torch.Tensor, hint_lengths: torch.Tensor
                ) -> torch.Tensor:
        """hint_tokens [B, H, T], hint_lengths [B, H] → [B, H, 2] unit
        direction vectors, f32."""
        B, H, T = hint_tokens.shape
        enc = self.language_encoder(hint_tokens.reshape(B * H, T),
                                    hint_lengths.reshape(B * H))
        return l2_normalize(self.mlp_offsets(enc).reshape(B, H, 2))
