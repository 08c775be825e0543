"""Coarse cell-retrieval network (counterpart of
``text2pos_tpu/models/cell_retrieval.py``): the text tower only. Serving
reads the cell embeddings from the precomputed DB cache; the object tower
(ObjectEncoder, EdgeConv) comes with the offline-encoder slice."""

from __future__ import annotations

import torch
from torch import nn

from text2pos_torch.models.blocks import l2_normalize
from text2pos_torch.models.language import LanguageEncoder


class CellRetrievalNetwork(nn.Module):
    def __init__(self, vocab_size: int, embed_dim: int):
        super().__init__()
        self.language_encoder = LanguageEncoder(vocab_size, embed_dim)

    def encode_text(self, tokens: torch.Tensor, lengths: torch.Tensor
                    ) -> torch.Tensor:
        """[B, T] tokens → [B, E] L2-normalized text embeddings."""
        return l2_normalize(self.language_encoder(tokens, lengths))
