"""Top-k retrieval (counterpart of ``text2pos_tpu/ops/retrieval.py``).

f32 scores from one ``torch.matmul``, then top-k with ``lax.top_k``'s rule
for ties: among equal scores the lower index comes first.
``sharded_topk_retrieval`` splits the cell database over a mesh's devices
(``parallel.dp.make_mesh``): a local top-k a shard, then a merge of the
D·k candidates in the same order.
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


def two_key_topk(scores: torch.Tensor, index: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` best of candidates ``scores`` [Q, n] with global indices
    ``index`` [Q, n], by score descending and then index ascending: the
    order ``topk_retrieval`` gives over the whole database, whatever order
    the candidates come in (JAX's two-key ``lax.sort``, ``parallel/dp.py:
    330-343``)."""
    by_index = torch.sort(index, dim=1, stable=True).indices
    scores, index = scores.gather(1, by_index), index.gather(1, by_index)
    top = torch.sort(-scores, dim=1, stable=True).indices[:, :k]
    return scores.gather(1, top), index.gather(1, top)


def sharded_topk_retrieval(text_encodings: torch.Tensor,
                           cell_encodings: torch.Tensor, k: int, mesh
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``topk_retrieval`` with the cells split over ``mesh.devices``
    (JAX's ``sharded_topk_retrieval``): shard d scores every query against
    its C/D cells on its device and keeps its best min(k, C/D) with their
    global indices; the D·k candidates gathered on the first device give
    the k best by ``two_key_topk``. Any C ≥ k works: the cells are padded
    to a multiple of D with dummies scored −inf. Returns the same (scores,
    indices) as ``topk_retrieval``, on the first device."""
    D = len(mesh.devices)
    C, E = cell_encodings.shape
    if C < k:
        raise ValueError(f"top-{k} of {C} cells")
    pad = (-C) % D
    if pad:
        cell_encodings = torch.cat([cell_encodings,
                                    cell_encodings.new_zeros(pad, E)])
    shard = (C + pad) // D
    dev0 = mesh.devices[0]
    vals, idxs = [], []
    for d, dev in enumerate(mesh.devices):
        cells = cell_encodings[d * shard:(d + 1) * shard].to(dev)
        scores = torch.matmul(text_encodings.to(dev).float(),
                              cells.float().T)
        gidx = d * shard + torch.arange(shard, device=dev)
        scores = torch.where(gidx < C, scores, -torch.inf)
        top, i = torch.sort(-scores, dim=1, stable=True)
        kk = min(k, shard)
        vals.append((-top[:, :kk]).to(dev0))
        idxs.append(gidx[i[:, :kk]].to(dev0))
    return two_key_topk(torch.cat(vals, 1), torch.cat(idxs, 1), k)
