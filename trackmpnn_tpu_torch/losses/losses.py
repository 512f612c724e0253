"""Training losses of the row layout as masked segment reductions (the
counterpart of trackmpnn_tpu/losses/losses.py).

  * targets (ref loss.py:8-44): a detection's target is its label; among the
    positive-LABEL edges incident to a detection, the latest (highest row)
    past edge and the earliest (lowest row) future edge get target 1.
  * CE (ref loss.py:77-115): for every detection with a positive-TARGET edge
    in its past (resp. future) incident set, cross-entropy of that set's
    logits against the chosen positive, weighted by 1/|set|.
  * focal (ref loss.py:47-74): gamma=0, alpha=None => mean BCE with the
    reference's log(p + 1e-10) epsilon placement.

The block train step (train/block.py) computes the same losses in block
layout itself and takes only EPS from here.
"""

from __future__ import annotations

import torch

from trackmpnn_tpu_torch.ops.segment import (
    segment_argmax,
    segment_logsumexp,
    segment_max,
    segment_sum,
)

EPS = 1e-10  # added inside log(p) of the BCE terms (losses.py:32 of the JAX package)


def _clip(ids, n):
    return ids.long().clamp(0, n - 1)


def make_targets(label, is_det, past, fut, live):
    """Binary target per row (ref create_targets, loss.py:8-44), int32."""
    n = label.shape[0]
    idx = torch.arange(n, device=label.device)
    edge_live = live & ~is_det
    pos = edge_live & (label == 1)
    ones = torch.ones(n, device=label.device)
    # latest positive-label edge into each det (segment over future endpoint)
    past_sel = segment_argmax(ones, fut, n, mask=pos, tie="high")
    # earliest positive-label edge out of each det (segment over past endpoint)
    fut_sel = segment_argmax(ones, past, n, mask=pos, tie="low")
    edge_t = (idx == past_sel[_clip(fut, n)]) | (idx == fut_sel[_clip(past, n)])
    det_t = (label == 1) & is_det
    t = torch.where(live, torch.where(is_det, det_t, edge_t & edge_live), False)
    return t.to(torch.int32)


def ce_loss(logits, targets, is_det, past, fut, live):
    """Per-detection softmax CE over incident edge sets (ref CELoss)."""
    n = logits.shape[0]
    edge_live = live & ~is_det
    tpos = edge_live & (targets == 1)
    ones = torch.ones(n, device=logits.device)
    det_live = live & is_det

    def one_side(seg, tie):
        size = segment_sum(ones, seg, n, mask=edge_live)
        sel = segment_argmax(ones, seg, n, mask=tpos, tie=tie)
        has = (sel >= 0) & det_live
        lse = segment_logsumexp(logits, seg, n, mask=edge_live)
        sel_logit = logits[_clip(sel, n)]
        per_det = torch.where(has, (lse - sel_logit) / torch.clamp(size, min=1.0), 0.0)
        return per_det.sum()

    # past sets: edges whose future endpoint is d (chosen positive = latest);
    # future sets: edges whose past endpoint is d (chosen positive = earliest)
    return one_side(fut, "high") + one_side(past, "low")


def bce_loss(probs, targets, mask):
    """Mean BCE with the reference's epsilon inside the log (FocalLoss g=0)."""
    pt = torch.where(targets == 1, probs, 1.0 - probs)
    lp = torch.log(pt + EPS)
    cnt = torch.clamp(mask.sum().to(probs.dtype), min=1.0)
    return -torch.where(mask, lp, 0.0).sum() / cnt


def focal_loss(probs, targets, mask, gamma: float = 0.0):
    """General focal loss; gamma=0 reduces to bce_loss."""
    pt = torch.where(targets == 1, probs, 1.0 - probs)
    lp = torch.log(pt + EPS)
    w = (1.0 - pt) ** gamma if gamma > 0 else 1.0
    cnt = torch.clamp(mask.sum().to(probs.dtype), min=1.0)
    return -torch.where(mask, w * lp, 0.0).sum() / cnt


def f1_counts(scores, targets, is_det, live, tp_classifier: bool):
    """Confusion counts of the per-step F1 (ref train.py:77-88): scores
    threshold at 0.5; with the TP-classifier head off, only edges count."""
    pred = scores >= 0.5
    mask = live if tp_classifier else live & ~is_det
    t = targets == 1
    return (mask & pred & t).sum(), (mask & pred & ~t).sum(), (mask & ~pred & t).sum()


def targets_and_ce(logits, label, is_det, past, fut, live):
    """make_targets + ce_loss on doubled rows (losses.py:107-170 of the JAX
    package): the first half holds the past-side sets (bucket fut), the
    second the future-side sets (bucket past + n); a signed row index makes
    "latest" and "earliest" both a max.  The logsumexp shift is one global
    max over the live edge logits, without gradient (the value does not
    depend on it).  Returns (targets int32[n], CE summed over detections)."""
    n = logits.shape[0]
    n2 = 2 * n
    dev = logits.device
    idx = torch.arange(n, device=dev)
    edge_live = live & ~is_det
    det_live = live & is_det
    seg2 = torch.cat([fut.long(), past.long() + n])
    mask2 = torch.cat([edge_live, edge_live])
    sidx = torch.cat([idx, -idx]).to(torch.float32)
    clip2 = seg2.clamp(0, n2 - 1)
    logits2 = torch.cat([logits, logits])

    # label-positive selections (targets)
    pos = label == 1
    pos2 = mask2 & torch.cat([pos, pos])
    m1 = segment_max(torch.where(pos2, sidx, -1e30), seg2, n2, mask=mask2)
    win1 = (sidx == m1[clip2]) & pos2
    edge_t = (win1[:n] | win1[n:]) & edge_live
    targets = torch.where(live, torch.where(is_det, pos & is_det, edge_t), False)
    targets = targets.to(torch.int32)

    # target selection max; [count, exp] sums
    tpos2 = mask2 & torch.cat([targets == 1, targets == 1])
    sel_m = segment_max(torch.where(tpos2, sidx, -1e30), seg2, n2, mask=mask2)
    gmax = torch.clamp(torch.where(mask2, logits2, -torch.inf).max(), min=0.0).detach()
    shifted = torch.exp(logits2 - gmax)
    sums = segment_sum(torch.stack([torch.ones_like(logits2), shifted], 1), seg2, n2,
                       mask=mask2)
    dl2 = torch.cat([det_live, det_live])
    bucket = torch.stack([sel_m, sums[:, 0], sums[:, 1], dl2.to(torch.float32)], dim=1)
    rowb = bucket[clip2]
    row_sel, size, expsum, row_dl = rowb[:, 0], rowb[:, 1], rowb[:, 2], rowb[:, 3]
    lse = gmax + torch.log(torch.clamp(expsum, min=1e-30))

    # one winner row per nonempty positive set: the per-detection sum is a
    # sum over rows
    win2 = (torch.where(tpos2, sidx, -1e30) == row_sel) & tpos2
    counted = win2 & (row_dl > 0) & (size > 0)
    per_row = torch.where(counted, (lse - logits2) / torch.clamp(size, min=1.0), 0.0)
    return targets, per_row.sum()


def step_losses(out_scores, out_logits, label, is_det, past, fut, live, tp_classifier: bool):
    """One step's (loss_ce, loss_focal, (tp, fp, fn), targets) as in ref
    train.py:70-88."""
    targets, l_ce = targets_and_ce(out_logits, label, is_det, past, fut, live)
    edge_mask = live & ~is_det
    node_mask = live & is_det
    if tp_classifier:
        l_f = (bce_loss(out_scores, targets, node_mask)
               + bce_loss(out_scores, targets, edge_mask))
    else:
        l_f = bce_loss(out_scores, targets, edge_mask)
    tp, fp, fn = f1_counts(out_scores, targets, is_det, live, tp_classifier)
    return l_ce, l_f, (tp, fp, fn), targets
