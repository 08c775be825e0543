"""Top-k retrieval (counterpart of ``text2pos_tpu/ops/retrieval.py:34``).

f32 scores from one ``torch.matmul``, then top-k with ``lax.top_k``'s rule
for ties: among equal scores the lower index comes first.
"""

from __future__ import annotations

from typing import Tuple

import torch


def topk_retrieval(text_encodings: torch.Tensor, cell_encodings: torch.Tensor,
                   k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """text [Q, E], cells [C, E] → (scores [Q, k] descending, indices
    [Q, k] int64)."""
    scores = torch.matmul(text_encodings.float(), cell_encodings.float().T)
    # A stable sort of the negated scores keeps equal scores in index order;
    # torch.topk does not document the order of ties.
    top, idx = torch.sort(-scores, dim=1, stable=True)
    return -top[:, :k], idx[:, :k]
