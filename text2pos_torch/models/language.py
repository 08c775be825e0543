"""Language encoder (counterpart of ``text2pos_tpu/models/language.py``):
word embedding with token 0 (unk/pad) zeroed, then the length-masked
bidirectional LSTM of ``ops/lstm.py``; returns the mean of the two final
hidden states. Always f32, as in JAX (the encoder has no compute dtype)."""

from __future__ import annotations

import torch
from torch import nn

from text2pos_torch.ops.lstm import LSTMParams, bilstm_final_hidden


class LanguageEncoder(nn.Module):
    def __init__(self, vocab_size: int, embed_dim: int):
        super().__init__()
        e = embed_dim
        self.word_embedding = nn.Embedding(vocab_size, e)
        for d in ("fwd", "bwd"):
            self.register_parameter(f"lstm_{d}_w_ih",
                                    nn.Parameter(torch.zeros(e, 4 * e)))
            self.register_parameter(f"lstm_{d}_w_hh",
                                    nn.Parameter(torch.zeros(e, 4 * e)))
            self.register_parameter(f"lstm_{d}_b",
                                    nn.Parameter(torch.zeros(4 * e)))

    def _params(self, d: str) -> LSTMParams:
        return LSTMParams(getattr(self, f"lstm_{d}_w_ih"),
                          getattr(self, f"lstm_{d}_w_hh"),
                          getattr(self, f"lstm_{d}_b"))

    def forward(self, tokens: torch.Tensor, lengths: torch.Tensor
                ) -> torch.Tensor:
        """tokens [B, T] int, lengths [B] → [B, E] f32 (not normalized)."""
        x = self.word_embedding(tokens) * (tokens != 0)[..., None]
        return bilstm_final_hidden(x, lengths, self._params("fwd"),
                                   self._params("bwd"))
