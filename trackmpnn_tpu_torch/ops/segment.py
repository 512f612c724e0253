"""Masked segment reductions (the counterpart of
trackmpnn_tpu/ops/segment.py:22-52).

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
