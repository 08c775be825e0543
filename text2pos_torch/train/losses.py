"""Losses and match/pose metrics (counterpart of
``text2pos_tpu/train/losses.py``): the matching NLL, the ranking losses of
the coarse stage, batched recall/precision and the in-cell pose error, and
``soft_mass_and_spread``, which the cascade's soft cheap pass scores with
(``serve_batch(prune_soft=True)``), and the fine stage's rank-aware term:
``soft_rank_score`` of each (query, cell) transport and
``listwise_rank_loss`` over the true cell and its in-batch negatives."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from text2pos_torch.models.matcher import get_pos_in_cell


def matching_loss(log_P: torch.Tensor, all_matches: torch.Tensor,
                  match_counts: torch.Tensor) -> torch.Tensor:
    """Mean over samples of −log P at the ground-truth pairs.

    log_P [B, M+1, N+1]; all_matches [B, L, 2] (object, hint) pairs with
    dustbin rows, entries past ``match_counts`` [B] repeats that are masked
    out.
    """
    B, L, _ = all_matches.shape
    obj = all_matches[..., 0].long()
    hint = all_matches[..., 1].long()
    vals = log_P[torch.arange(B, device=log_P.device)[:, None], obj, hint]
    valid = (torch.arange(L, device=log_P.device)[None, :]
             < match_counts.to(log_P.device)[:, None])
    vf = valid.to(vals.dtype)
    per_sample = (-vals * vf).sum(1) / vf.sum(1).clamp_min(1.0)
    return per_sample.mean()


def _normalize_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=1,
                                        keepdim=True).clamp_min(1e-12)


def pairwise_ranking_loss(anchors: torch.Tensor, positives: torch.Tensor,
                          margin: float = 0.35) -> torch.Tensor:
    """Bidirectional margin ranking over the in-batch score matrix."""
    scores = _normalize_rows(anchors) @ _normalize_rows(positives).T
    diagonal = torch.diagonal(scores)
    eye = torch.eye(scores.shape[0], dtype=torch.bool, device=scores.device)
    cost_s = torch.relu((margin - diagonal)[:, None] + scores)
    cost_im = torch.relu((margin - diagonal)[:, None] + scores.T)
    zero = scores.new_zeros(())
    cost_s = torch.where(eye, zero, cost_s)
    cost_im = torch.where(eye, zero, cost_im)
    return (cost_s.sum() + cost_im.sum()) / scores.shape[0]


def hardest_ranking_loss(images: torch.Tensor, captions: torch.Tensor,
                         margin: float = 0.35) -> torch.Tensor:
    """Hardest-negative variant of the ranking loss."""
    scores = _normalize_rows(images) @ _normalize_rows(captions).T
    diagonal = torch.diagonal(scores)
    eye = torch.eye(scores.shape[0], dtype=torch.bool, device=scores.device)
    zero = scores.new_zeros(())
    cost_images = torch.where(
        eye, zero, torch.relu(margin + scores - diagonal[:, None]))
    cost_captions = torch.where(
        eye, zero, torch.relu(margin + scores.T - diagonal[:, None]))
    return (cost_images.amax(1).mean() + cost_captions.amax(1).mean())


def triplet_margin_loss(anchor: torch.Tensor, positive: torch.Tensor,
                        negative: torch.Tensor, margin: float = 0.35
                        ) -> torch.Tensor:
    """``torch.nn.TripletMarginLoss`` (p=2) without its eps."""
    dp = torch.linalg.vector_norm(anchor - positive, dim=1)
    dn = torch.linalg.vector_norm(anchor - negative, dim=1)
    return torch.relu(dp - dn + margin).mean()


def _masked_mean(x: torch.Tensor, sample_mask: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    if sample_mask is None:
        return x.mean()
    mf = sample_mask.to(x.dtype)
    return (x * mf).sum() / mf.sum().clamp_min(1.0)


def calc_recall_precision(gt_obj_for_hint: torch.Tensor,
                          matches0: torch.Tensor, matches1: torch.Tensor,
                          sample_mask: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Recall over the ground-truth pairs (a pair counts if either
    direction recovers it) and precision over the predicted object → hint
    matches, each the mean over samples (those of ``sample_mask``).

    gt_obj_for_hint [B, H] (−1 unmatched), matches0 [B, O], matches1 [B, H].
    """
    B, H = gt_obj_for_hint.shape
    O = matches0.shape[1]
    gt = gt_obj_for_hint.long()
    m0, m1 = matches0.long(), matches1.long()
    dev = gt.device
    has_gt = gt >= 0
    pred_hint_at_gt = torch.gather(m0, 1, gt.clamp_min(0))
    hit0 = pred_hint_at_gt == torch.arange(H, device=dev)[None]
    hit1 = m1 == gt
    recalled = (hit0 | hit1) & has_gt
    gt_count = has_gt.sum(1)
    recall = torch.where(gt_count > 0,
                         recalled.sum(1) / gt_count.clamp_min(1),
                         torch.zeros((), device=dev))

    pred = m0 >= 0
    gt_at_pred = torch.gather(gt, 1, m0.clamp_min(0))
    correct = pred & (gt_at_pred == torch.arange(O, device=dev)[None])
    pred_count = pred.sum(1)
    precision = torch.where(pred_count > 0,
                            correct.sum(1) / pred_count.clamp_min(1),
                            torch.zeros((), device=dev))
    return (_masked_mean(recall.float(), sample_mask),
            _masked_mean(precision.float(), sample_mask))


def calc_pose_error(centers_xy: torch.Tensor, matches0: torch.Tensor,
                    poses_xy: torch.Tensor,
                    offsets: Optional[torch.Tensor] = None,
                    use_mid_pred: bool = False,
                    sample_mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Mean in-cell localization error: the cell middle (``use_mid_pred``)
    or ``get_pos_in_cell`` with ``offsets`` (zero when None) against the
    true positions poses_xy [B, 2]."""
    B, O, _ = centers_xy.shape
    if use_mid_pred:
        preds = torch.full((B, 2), 0.5, dtype=centers_xy.dtype,
                           device=centers_xy.device)
    else:
        if offsets is None:
            offsets = centers_xy.new_zeros(B, O, 2)
        preds = get_pos_in_cell(centers_xy, matches0.long(), offsets)
    err = torch.linalg.vector_norm(poses_xy - preds, dim=1)
    return _masked_mean(err, sample_mask)


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


def soft_rank_score(P: torch.Tensor, centers_xy: torch.Tensor,
                    offsets: torch.Tensor, gamma: float = 0.0
                    ) -> torch.Tensor:
    """The serving re-rank score's differentiable surrogate [...] f32:
    the soft transport mass, less ``gamma`` times the soft vote spread
    (``soft_mass_and_spread``; the spread is not formed when ``gamma`` is
    0)."""
    mass, spread = soft_mass_and_spread(P, centers_xy, offsets)
    return mass - gamma * spread if gamma else mass


def listwise_rank_loss(pos_score: torch.Tensor, neg_scores: torch.Tensor,
                       tau: float = 1.0) -> torch.Tensor:
    """Mean over queries of −log softmax(s⁺/τ over {s⁺, s⁻…}): pos_score
    [B], neg_scores [R, B] (−inf drops a negative from the softmax)."""
    logits = torch.cat([pos_score[None], neg_scores], 0) / tau
    return -torch.log_softmax(logits, 0)[0].mean()
