"""Teacher-forced window schedules: the training graph, precomputed on the
host (the counterpart of trackmpnn_tpu/graph/schedule.py).

In train mode the graph's evolution is driven only by GT labels (teacher
forcing, ref graph.py:229-245): model scores are never consulted.  So the
whole rolling window's sequence of graphs is computed here once and packed
into padded arrays; the train step then runs every step of the window on
the device without a host round trip.

A schedule holds the FINAL graph's static per-slot arrays (slots only grow
during training: decode_tracks is never called there, ref train.py:49-137)
plus per-step live/new row counts.  Step s sees rows [0, n_after[s]) with
rows [n_before[s], n_after[s]) fresh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from trackmpnn_tpu_torch.graph import engine
from trackmpnn_tpu_torch.graph.view import pack_slots


@dataclass
class BipartiteBlock:
    """One step's complete-bipartite edge block (ref graph.py:281 semantics).

    Edge rows [edge_base, edge_base + na*nt) are laid out i*nt + j with
    past endpoint active_rows[i] and future endpoint det_base + j."""

    edge_base: int
    na: int
    nt: int
    det_base: int
    active_rows: np.ndarray  # int32[na] past-endpoint row ids


@dataclass
class WindowSchedule:
    """Padded description of one training window (chunk)."""

    # static per-slot [cap]
    is_det: np.ndarray
    past: np.ndarray   # int32, self-index for non-edges (inert under masks)
    fut: np.ndarray
    label: np.ndarray  # int32
    feat: np.ndarray   # float32 [cap, F]
    # per-step [t_cap]
    n_before: np.ndarray  # int32
    n_after: np.ndarray   # int32
    step_valid: np.ndarray  # bool
    n_rows: int
    n_steps: int
    n_edges: int  # total live edge rows (for edges/s accounting)
    # per-step bipartite block descriptors (None entry = step added no rows)
    blocks: list = None


def round_up(x: int, multiple: int) -> int:
    """x rounded up to a multiple of `multiple` (at least one multiple)."""
    return ((max(x, 1) + multiple - 1) // multiple) * multiple


def build_window_schedule(
    X: np.ndarray,
    y: np.ndarray,
    t_st: int = 0,
    cap: Optional[int] = None,
    t_cap: Optional[int] = None,
    bucket: int = 128,
) -> Optional[WindowSchedule]:
    """Run the teacher-forced engine over a chunk and pack the result.

    X: float32[num_dets, F] normalized features; y: int64[num_dets, 2]
    (ts, track_id).  Returns None when the chunk can't seed a graph
    (mirrors initialize_graph's None return, ref graph.py:132-133).
    """
    g = engine.initialize(y, t_st=t_st, mode="train")
    if g is None:
        return None

    counts = [(0, g.n)]
    for t in range(g.t_next, g.t_end):
        n_before = g.n
        engine.update(g, y, t, None, mode="train")
        counts.append((n_before, g.n))

    n = g.n
    n_steps = len(counts)
    cap = cap if cap is not None else round_up(n, bucket)
    if cap < n:
        raise ValueError(f"capacity {cap} < required rows {n}")
    t_cap = t_cap if t_cap is not None else n_steps
    if t_cap < n_steps:
        raise ValueError(f"t_cap {t_cap} < required steps {n_steps}")

    is_det, past, fut, feat = pack_slots(g, X, cap)
    label = np.zeros(cap, np.int32)
    label[:n] = g.label

    n_before = np.full(t_cap, n, np.int32)
    n_after = np.full(t_cap, n, np.int32)
    step_valid = np.zeros(t_cap, bool)
    for s, (b, a) in enumerate(counts):
        n_before[s], n_after[s], step_valid[s] = b, a, True

    blocks = [_derive_block(is_det, past, b, a) for (b, a) in counts]

    return WindowSchedule(
        is_det=is_det, past=past, fut=fut, label=label, feat=feat,
        n_before=n_before, n_after=n_after, step_valid=step_valid,
        n_rows=n, n_steps=n_steps, n_edges=int(np.sum(g.ts == -1)),
        blocks=blocks,
    )


def _derive_block(is_det, past, b: int, a: int) -> Optional[BipartiteBlock]:
    """Recover the step's complete-bipartite block from the slot layout.

    Rows [b, a) are [optional dets | edges (i*nt + j) | new-frame dets]
    (init step carries the t0 dets in front; updates start with edges)."""
    span = np.arange(b, a)
    er = span[~is_det[b:a]]
    if er.size == 0:
        return None
    edge_base = int(er[0])
    det_base = int(er[-1]) + 1
    nt = a - det_base
    if nt <= 0 or er.size % nt != 0:
        return None
    na = er.size // nt
    active = past[edge_base + np.arange(na) * nt].astype(np.int32)
    return BipartiteBlock(edge_base=edge_base, na=na, nt=nt,
                          det_base=det_base, active_rows=active)
