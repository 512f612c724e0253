"""Masked segment reductions, arg-reductions and the segment softmax (the
counterpart of trackmpnn_tpu/ops/segment.py).

Every function takes an optional validity mask: masked rows go to a scratch
bucket at `num_segments`, so their ids never matter, and the scratch is
dropped.  Empty buckets of segment_max/segment_min hold `initial` (-1e30 /
+1e30), as in the JAX package.  These are plain tensor ops there too,
outside every Pallas kernel.  Differentiable through autograd.
"""

from __future__ import annotations

import torch

_NEG_LARGE = -1e30
_POS_LARGE = 1e30


def _route(values, segment_ids, num_segments, mask, fill):
    ids = segment_ids.long()
    if mask is not None:
        shape = values.shape[:1] + (1,) * (values.dim() - 1)
        values = torch.where(mask.reshape(shape), values, fill)
        ids = torch.where(mask, ids, num_segments)
    return values, ids


def segment_sum(values, segment_ids, num_segments, mask=None):
    """Sum `values` rows into `num_segments` buckets; masked rows contribute 0."""
    values, ids = _route(values, segment_ids, num_segments, mask, 0.0)
    out = values.new_zeros((num_segments + 1,) + values.shape[1:])
    return out.index_add(0, ids, values)[:num_segments]


def _segment_reduce(values, segment_ids, num_segments, mask, initial, reduce):
    values, ids = _route(values, segment_ids, num_segments, mask, initial)
    out = values.new_full((num_segments + 1,) + values.shape[1:], initial)
    index = ids.reshape(ids.shape + (1,) * (values.dim() - 1)).expand_as(values)
    out = out.scatter_reduce(0, index, values, reduce=reduce, include_self=True)
    return out[:num_segments]


def segment_max(values, segment_ids, num_segments, mask=None, initial=_NEG_LARGE):
    """Max-reduce into buckets.  Empty buckets hold `initial`."""
    return _segment_reduce(values, segment_ids, num_segments, mask, initial, "amax")


def segment_min(values, segment_ids, num_segments, mask=None, initial=_POS_LARGE):
    """Min-reduce into buckets.  Empty buckets hold `initial`."""
    return _segment_reduce(values, segment_ids, num_segments, mask, initial, "amin")


def _clipped(segment_ids, num_segments):
    return segment_ids.long().clamp(0, num_segments - 1)


def segment_argmax(values, segment_ids, num_segments, mask=None, tie="high"):
    """Row index of the max element per segment; -1 if empty.

    tie="high" breaks ties toward the largest index (the reference's "latest
    positive" rule on 0/1 indicators), tie="low" toward the smallest."""
    n = values.shape[0]
    idx = torch.arange(n, device=values.device)
    v = values.float()
    m = segment_max(v, segment_ids, num_segments, mask=mask)
    has = m > _NEG_LARGE / 2
    winner = v == m[_clipped(segment_ids, num_segments)]
    if mask is not None:
        winner = winner & mask
    if tie == "high":
        out = segment_max(torch.where(winner, idx, -1), segment_ids, num_segments, mask=mask,
                          initial=-1)
    else:
        out = segment_min(torch.where(winner, idx, n + 1), segment_ids, num_segments,
                          mask=mask, initial=n + 1)
        out = torch.where(out > n, -1, out)
    return torch.where(has, out, -1).to(torch.int32)


def segment_argmin(values, segment_ids, num_segments, mask=None, tie="low"):
    """Row index of the min element per segment; -1 if empty.  Ties go to
    the smallest index by default."""
    return segment_argmax(-values, segment_ids, num_segments, mask=mask, tie=tie)


def segment_logsumexp(logits, segment_ids, num_segments, mask=None):
    """Per-segment logsumexp, shifted by the segment's max; empty segments
    hold -1e30.  The shift carries no gradient (the value does not depend
    on it)."""
    m = segment_max(logits, segment_ids, num_segments, mask=mask).detach()
    safe_m = torch.where(m > _NEG_LARGE / 2, m, 0.0)
    e = torch.exp(logits - safe_m[_clipped(segment_ids, num_segments)])
    s = segment_sum(e, segment_ids, num_segments, mask=mask)
    out = safe_m + torch.log(torch.clamp(s, min=1e-30))
    return torch.where(m > _NEG_LARGE / 2, out, _NEG_LARGE)


def segment_softmax(logits, segment_ids, num_segments, mask=None):
    """Per-segment softmax over rows; masked rows get 0.  The lse is clamped
    before the exp: a masked row whose clipped id lands on an empty bucket
    would otherwise see exp(x + 1e30) = inf, and its gradient inf * 0 = NaN.
    Unmasked rows always belong to a nonempty segment, so the clamp never
    changes a real output."""
    lse = segment_logsumexp(logits, segment_ids, num_segments, mask=mask)
    safe_lse = torch.where(lse > _NEG_LARGE / 2, lse, 0.0)
    out = torch.exp(logits - safe_lse[_clipped(segment_ids, num_segments)])
    if mask is not None:
        out = torch.where(mask, out, 0.0)
    return out
