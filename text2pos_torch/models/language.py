"""Language encoder (counterpart of ``text2pos_tpu/models/language.py``):
word embedding with token 0 (unk/pad) zeroed, then the length-masked
bidirectional LSTM of ``ops/lstm.py``; returns the mean of the two final
hidden states. Always f32, as in JAX (the encoder has no compute dtype).

The embedding and the input projections are folded into one gate-input
table per direction, ``[V, 4H] = emb·W_ih + b`` with row 0 built from the
zeroed embedding (the bias alone), which the LSTM kernel gathers by token
id; no ``[T, B, 4H]`` projection is formed."""

from __future__ import annotations

import torch
from torch import nn

from text2pos_torch.ops.lstm import LSTMParams, bilstm_tokens, token_tables


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

    def token_tables(self) -> list:
        """The two directions' gate-input tables [V, 4E] f32."""
        return token_tables(self.word_embedding.weight, self._params("fwd"),
                            self._params("bwd"))

    def forward(self, tokens: torch.Tensor, lengths: torch.Tensor
                ) -> torch.Tensor:
        """tokens [B, T] int, lengths [B] → [B, E] f32 (not normalized)."""
        return bilstm_tokens(self.token_tables(), self._params("fwd"),
                             self._params("bwd"), tokens, lengths)
