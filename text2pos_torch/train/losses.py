"""Losses (counterpart of ``text2pos_tpu/train/losses.py``). Only
``soft_mass_and_spread`` is ported so far: the cascade's soft cheap pass
(``serve_batch(prune_soft=True)``) scores with it."""

from __future__ import annotations

from typing import Tuple

import torch


def soft_mass_and_spread(P: torch.Tensor, centers_xy: torch.Tensor,
                         offsets: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(soft transport mass, soft vote spread) [...] f32, read straight off
    the transport matrix with no match extraction.

    P [..., M+1, N+1] (dustbins last), centers_xy [..., M, 2], offsets
    [..., N, 2]: hint n votes for the T-weighted mean of the object centres
    plus its offset; the spread is the weighted RMS distance of the votes
    to their weighted mean.
    """
    T = P[..., :-1, :-1].float()                            # [..., M, N]
    mass = T.sum((-2, -1))
    w_h = T.sum(-2)                                         # [..., N]
    denom = w_h.clamp_min(1e-9)[..., None]
    pos_h = torch.einsum("...mn,...md->...nd", T,
                         centers_xy.float()) / denom
    votes = pos_h + offsets.float()                         # [..., N, 2]
    wsum = w_h.sum(-1).clamp_min(1e-9)
    mean_v = (votes * w_h[..., None]).sum(-2) / wsum[..., None]
    d2 = ((votes - mean_v[..., None, :]) ** 2).sum(-1)
    spread = torch.sqrt((d2 * w_h).sum(-1) / wsum + 1e-12)
    return mass, spread
