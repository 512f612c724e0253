"""Rolling-window graph engine (host side), the counterpart of
trackmpnn_tpu/graph/engine.py.

Association and decode planning go to the port's native C++ planner
(csrc/graph_planner.cpp through graph/native.py, built with g++ on first
use), as the JAX engine sends them to its own; the numpy functions below
are the semantic reference, fuzz-equal to it, and TM_NATIVE=0 (read at
each call) makes the engine take them instead.  Slot order and every
tie-break are kept exactly.

Reproduces the behavioral contract of the reference's dynamic graph module
(the reference's utils/graph.py) on compact record arrays instead of dense
N x N adjacency matrices.  Rows ("slots") are numbered in exactly the
reference's append order - [dets_t0 | edges | dets_t1 | new edges | dets_t2
| ...] - so every index-order-dependent rule (nearest-future-timestep greedy
association, latest/earliest positive-edge tie-breaks, prefix finalization)
reproduces identically.  Per-row records:

    ts[i]      timestep of a detection row; -1 for association ("edge") rows
    det_id[i]  global detection index within the sequence; -1 for edges
    ass_id[i]  det_id of the associated next detection; -1 if none
    past[i]    row index of the edge's past detection endpoint; -1 for dets
    fut[i]     row index of the edge's future detection endpoint; -1
    label[i]   GT binary class (det: is-TP; edge: endpoints same GT track)

Device code never sees any of this - it receives padded index tensors
(see graph/view.py) and streams back per-row scores.  While serving, the
numpy association and decode planning took most of each step's wall time
(PERF.md); the planner is their native form.  In training mode association
is teacher-forced from labels (graph.py:229-245).

Semantics cross-references (reference file:line):
  initialize   graph.py:96-186      update        graph.py:189-334
  greedy assoc graph.py:251-268     hungarian     graph.py:33-93
  decode       graph.py:392-539     prune         graph.py:337-389
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
from scipy.optimize import linear_sum_assignment


def _native():
    """graph/native.py, or None where TM_NATIVE=0 asks for the numpy paths
    (read at each call, so one process can run both)."""
    if os.environ.get("TM_NATIVE", "1") == "0":
        return None
    from trackmpnn_tpu_torch.graph import native

    return native


@dataclass
class RollingGraph:
    """Live window of the frame graph, in reference row order."""

    ts: np.ndarray       # int64[N]
    det_id: np.ndarray   # int64[N]
    ass_id: np.ndarray   # int64[N]
    past: np.ndarray     # int64[N]
    fut: np.ndarray      # int64[N]
    label: np.ndarray    # int64[N]
    t_next: int = 0      # next timestep to process
    t_end: int = 0       # one past the last timestep of the sequence

    @property
    def n(self) -> int:
        return len(self.ts)

    @property
    def is_det(self) -> np.ndarray:
        return self.ts != -1

    def det_rows(self) -> np.ndarray:
        return np.where(self.ts != -1)[0]

    def edge_rows(self) -> np.ndarray:
        return np.where(self.ts == -1)[0]

    def row_of_det(self, det_id: int) -> int:
        r = np.where(self.det_id == det_id)[0]
        return int(r[0]) if r.size else -1


def _empty(n):
    return np.full((n,), -1, dtype=np.int64)


def initialize(y: np.ndarray, t_st: int = 0, mode: str = "test") -> Optional[RollingGraph]:
    """Build the two-frame seed graph (ref graph.py:96-186).

    y: int64[num_dets, 2] rows (ts, track_id); track_id -1 = false positive.
    Returns None when no two distinct non-empty frames exist at/after t_st,
    or (train mode) when every detection is a false positive.
    """
    if y.shape[0] == 0:
        return None
    times = np.sort(y[:, 0])
    cand = times[times >= t_st]
    if cand.size == 0:
        return None
    t0 = int(cand[0])
    later = cand[cand > t0]
    if later.size == 0:
        return None
    t1 = int(later[0])
    tN = int(times[-1])
    if mode == "train" and np.all(y[:, 1] == -1):
        return None

    ids_t0 = np.where(y[:, 0] == t0)[0]
    ids_t1 = np.where(y[:, 0] == t1)[0]
    n0, n1 = len(ids_t0), len(ids_t1)
    n = n0 + n0 * n1 + n1

    g = RollingGraph(
        ts=_empty(n), det_id=_empty(n), ass_id=_empty(n),
        past=_empty(n), fut=_empty(n), label=np.zeros(n, np.int64),
        t_next=t1 + 1, t_end=tN + 1,
    )
    g.ts[:n0] = t0
    g.det_id[:n0] = ids_t0
    g.ts[n0 + n0 * n1 :] = t1
    g.det_id[n0 + n0 * n1 :] = ids_t1
    for i in range(n0):
        for j in range(n1):
            e = n0 + i * n1 + j
            g.past[e] = i
            g.fut[e] = n0 + n0 * n1 + j

    g.label[:n0] = (y[ids_t0, 1] >= 0).astype(np.int64)
    g.label[n0 + n0 * n1 :] = (y[ids_t1, 1] >= 0).astype(np.int64)
    y0, y1 = y[ids_t0], y[ids_t1]
    for j in range(n1):
        if y1[j, 1] == -1:
            continue
        src = np.where(y0[:, 1] == y1[j, 1])[0]
        if src.size > 1:
            raise AssertionError("more than one detection from same timestep on same track")
        if src.size == 1:
            g.label[n0 + src[0] * n1 + j] = 1
    return g


# ------------------------------------------------------------ association ----
def _edge_block_ts(g: RollingGraph) -> np.ndarray:
    """Per-edge creation timestep = ts of its future endpoint (frame blocks)."""
    out = np.full(g.n, -1, dtype=np.int64)
    er = g.edge_rows()
    out[er] = g.ts[g.fut[er]]
    return out


def associate_teacher_forced(g: RollingGraph) -> None:
    """Train-mode association from GT labels (ref graph.py:229-245).

    TP detections follow their (unique) positive future edge; false
    positives self-associate so they stay frozen out.
    """
    g.ass_id[:] = -1
    for i in np.where(g.ts != -1)[0]:
        if g.label[i] == 1:
            fut_edges = np.where((g.ts == -1) & (g.past == i))[0]
            pos = fut_edges[g.label[fut_edges] == 1]
            if pos.size == 0:
                continue
            if pos.size > 1:
                raise AssertionError("more than one GT edge from same node")
            g.ass_id[i] = g.det_id[g.fut[pos[0]]]
        else:
            g.ass_id[i] = g.det_id[i]


def associate_greedy(g: RollingGraph, scores: np.ndarray) -> None:
    """Prediction-driven greedy association (ref graph.py:251-268).

    scores: float32[N, 2] = (1-p, p) per row.  For each TP detection
    (p >= 0.5), among score-positive future edges whose future endpoint is
    also TP, keep only those in the nearest future frame and take the
    highest-probability one (np.argmax ties -> lowest row index).
    """
    g.ass_id[:] = -1
    block = _edge_block_ts(g)
    for i in np.where(g.ts != -1)[0]:
        if scores[i, 1] < 0.5:
            continue
        fut_edges = np.where((g.ts == -1) & (g.past == i))[0]
        cand = fut_edges[scores[fut_edges, 1] >= 0.5]
        cand = cand[scores[g.fut[cand], 1] >= 0.5]
        if cand.size == 0:
            continue
        # nearest future frame = block of the lowest-index candidate edge
        # (row order is frame order, ref graph.py:261-263)
        nearest = block[cand[0]]
        cand = cand[block[cand] == nearest]
        best = cand[int(np.argmax(scores[cand, 1]))]
        g.ass_id[i] = g.det_id[g.fut[best]]


def _hungarian_step(g: RollingGraph, scores: np.ndarray, t: int, threshold: float = 0.5) -> None:
    """Optimal per-frame assignment (ref graph.py:33-93).

    For frame t's detections, build cost = scores[edge, 0] (= 1 - p) over
    all *unassociated* past endpoints connected by an edge (missing edge =
    cost 100), solve LSA, accept matches with cost <= threshold.
    """
    idx_t = np.where(g.ts == t)[0]
    if idx_t.size == 0:
        return
    in_edges = np.where((g.ts == -1) & np.isin(g.fut, idx_t))[0]
    if in_edges.size == 0:
        return
    idx_prev = np.unique(g.past[in_edges])
    idx_prev = idx_prev[g.ass_id[idx_prev] == -1]
    if idx_prev.size == 0:
        return
    C = np.full((idx_prev.size, idx_t.size), 100.0, dtype=np.float32)
    col_of = {int(r): j for j, r in enumerate(idx_t)}
    row_of = {int(r): i for i, r in enumerate(idx_prev)}
    for e in in_edges:
        i = row_of.get(int(g.past[e]))
        if i is None:
            continue
        C[i, col_of[int(g.fut[e])]] = scores[e, 0]
    rows, cols = linear_sum_assignment(C)
    for i, j in zip(rows, cols):
        if C[i, j] > threshold:
            continue
        g.ass_id[idx_prev[i]] = g.det_id[idx_t[j]]


def associate_hungarian(g: RollingGraph, scores: np.ndarray) -> None:
    """Frame-by-frame Hungarian over the live window (ref graph.py:247-249).

    Iterates t over [ts of first row, ts of last row]; rows outside any
    frame are skipped by _hungarian_step.
    """
    g.ass_id[:] = -1
    t_lo, t_hi = int(g.ts[0]), int(g.ts[-1])
    for t in range(t_lo, t_hi + 1):
        _hungarian_step(g, scores, t)


def associate(g, scores, mode: str, use_hungarian: bool) -> None:
    nat = _native()
    if mode == "train":
        (nat.associate_teacher_forced if nat else associate_teacher_forced)(g)
    elif use_hungarian:
        (nat.associate_hungarian if nat else associate_hungarian)(g, scores)
    else:
        (nat.associate_greedy if nat else associate_greedy)(g, scores)


# ----------------------------------------------------------------- update ----
def update(
    g: RollingGraph,
    y: np.ndarray,
    t: int,
    scores: Optional[np.ndarray],
    mode: str = "test",
    use_hungarian: bool = True,
) -> int:
    """Associate the current window, then append frame t (ref graph.py:189-334).

    Returns the number of newly-appended rows (edge block then det block).
    Active past detections get a complete bipartite edge block to frame t's
    detections; in train mode active = unassociated TPs plus the whole
    previous frame (including its self-associated FPs, graph.py:273-274);
    in test mode active = unassociated score-positive detections.
    """
    associate(g, scores, mode, use_hungarian)

    if mode == "train":
        prev_ts = g.ts[(g.ts != -1) & (g.ts < t)]
        t_prev = int(prev_ts.max()) if prev_ts.size else -1
        active = np.where(((g.ts != -1) & (g.ass_id == -1)) | (g.ts == t_prev))[0]
    else:
        active = np.where((g.ts != -1) & (g.ass_id == -1) & (scores[:, 1] >= 0.5))[0]

    ids_t = np.where(y[:, 0] == t)[0]
    na, nt = len(active), len(ids_t)
    n_new = na * nt + nt
    if nt == 0:
        g.t_next = t + 1
        return 0

    n_old = g.n
    grow = lambda a, fill: np.concatenate([a, np.full(n_new, fill, a.dtype)])
    g.ts = grow(g.ts, -1)
    g.det_id = grow(g.det_id, -1)
    g.ass_id = grow(g.ass_id, -1)
    g.past = grow(g.past, -1)
    g.fut = grow(g.fut, -1)
    g.label = grow(g.label, 0)

    det_base = n_old + na * nt
    g.ts[det_base:] = t
    g.det_id[det_base:] = ids_t
    for k in range(na):
        for j in range(nt):
            e = n_old + k * nt + j
            g.past[e] = active[k]
            g.fut[e] = det_base + j

    y_t = y[ids_t]
    g.label[det_base:] = (y_t[:, 1] >= 0).astype(np.int64)
    y_active = y[g.det_id[active]]
    for j in range(nt):
        if y_t[j, 1] == -1:
            continue
        for k in np.where(y_active[:, 1] == y_t[j, 1])[0]:
            g.label[n_old + k * nt + j] = 1

    g.t_next = t + 1
    return n_new


# ----------------------------------------------------------------- decode ----
def decode_tracks(
    g: RollingGraph,
    scores: np.ndarray,
    y_out: np.ndarray,
    t_upto: int,
    ret_win_size: int,
    use_hungarian: bool = True,
) -> np.ndarray:
    """Finalize tracks before t_upto and shrink the window (graph.py:392-539).

    Mutates y_out[:, 1] with finalized track ids and g in place (rows
    renumbered).  Returns the old-row indices that were KEPT, in order -
    the hidden-state gather plan for the device.
    """
    associate(g, scores, "test", use_hungarian)
    nat = _native()
    plan = nat.decode_plan if nat is not None else _decode_plan_py
    keep = plan(g, scores, y_out, t_upto, ret_win_size)
    _apply_keep(g, keep)
    return keep


def _decode_plan_py(g, scores, y_out, t_upto, ret_win_size):
    """numpy reference for chain-walking + deletion planning."""
    next_track_id = int(y_out[:, 1].max()) + 1
    visited = np.zeros(y_out.shape[0], dtype=np.int64)
    for start in range(y_out.shape[0]):
        det_id = start
        node = g.row_of_det(det_id)
        if node == -1:
            visited[det_id] = 1
            continue
        if g.ts[node] >= t_upto or scores[node, 1] < 0.5:
            visited[det_id] = 1
            continue
        if visited[det_id]:
            continue
        if y_out[det_id, 1] == -1:
            cur_track = next_track_id
            next_track_id += 1
        else:
            cur_track = int(y_out[det_id, 1])
        while True:
            visited[det_id] = 1
            y_out[det_id, 1] = cur_track
            nxt = int(g.ass_id[node])
            if nxt == -1:
                break
            if y_out[det_id, 0] >= t_upto and y_out[nxt, 0] >= t_upto:
                break
            det_id = nxt
            node = g.row_of_det(det_id)

    # ----- shrink: delete the pre-t_upto prefix, retaining re-id candidates
    pre = np.where((g.ts < t_upto) & (g.ts != -1))[0]
    max_id = int(pre[-1]) + 1 if pre.size else 0
    delete = set(range(max_id))
    for idx in range(max_id):
        if g.ts[idx] == -1:
            continue
        if (
            g.ass_id[idx] == -1
            and scores[idx, 1] >= 0.5
            and g.ts[idx] >= t_upto - ret_win_size
        ):
            delete.discard(idx)  # retained unassociated TP within window
        else:
            # drop this det's dangling future edges living past the prefix
            for e in np.where((g.ts == -1) & ((g.past == idx) | (g.fut == idx)))[0]:
                if e >= max_id:
                    delete.add(int(e))

    return np.array([i for i in range(g.n) if i not in delete], dtype=np.int64)


def _apply_keep(g: RollingGraph, keep: np.ndarray) -> None:
    """Filter rows to `keep` (old-row order) and renumber edge endpoints."""
    remap = np.full(g.n, -1, dtype=np.int64)
    remap[keep] = np.arange(len(keep))
    g.ts = g.ts[keep]
    g.det_id = g.det_id[keep]
    g.ass_id = g.ass_id[keep]
    g.label = g.label[keep]
    old_past, old_fut = g.past[keep], g.fut[keep]
    g.past = np.where(old_past >= 0, remap[np.clip(old_past, 0, None)], -1)
    g.fut = np.where(old_fut >= 0, remap[np.clip(old_fut, 0, None)], -1)


# ------------------------------------------------------------------ prune ----
def prune(
    g: RollingGraph,
    scores: np.ndarray,
    t_st: int,
    t_ed: int,
    threshold: float = 0.5,
) -> np.ndarray:
    """Drop low-probability edge rows created within [t_st, t_ed]
    (ref graph.py:337-389; dead code there, optional feature here).

    Returns kept old-row indices (hidden-state gather plan).
    """
    assert t_st <= t_ed
    in_range = np.where((g.ts >= t_st) & (g.ts <= t_ed))[0]
    if in_range.size == 0:
        return np.arange(g.n)
    lo, hi = int(in_range[0]), int(in_range[-1])
    idx = np.arange(g.n)
    keep_mask = (scores[:, 1] >= threshold) | (g.ts != -1) | (idx < lo) | (idx > hi)
    # an edge whose endpoint vanished cannot survive; endpoints are dets and
    # dets are always kept, so endpoints are safe here
    keep = np.where(keep_mask)[0]
    _apply_keep(g, keep)
    return keep
