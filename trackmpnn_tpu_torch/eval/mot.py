"""CLEAR-MOT + identity (IDF1) metrics in numpy and scipy (the counterpart
of trackmpnn_tpu/eval/mot.py).

The reference delegates to the `motmetrics` package (ref
utils/metrics.py:7-61); that package is not vendored here, so the metrics
are first-party.  Semantics follow the standard
definitions (Bernardin & Stiefelhagen CLEAR-MOT; Ristani et al. identity
metrics), matching py-motmetrics' accumulator behavior:

  * per-frame correspondence first re-establishes each gt's LAST KNOWN
    hyp (persisting across frames where either was absent, exactly like
    py-motmetrics' `self.m`) when both are present and within the distance
    gate, then solves min-cost assignment (Hungarian) for the rest;
  * SWITCH counts a matched gt whose hyp differs from its last known hyp;
  * MOTA = 1 - (FN + FP + IDSW) / num_gt; MOTP = mean matched distance;
  * IDF1 via a global trajectory-level min-cost bipartite matching.

Distances are 1 - IoU with a max_iou gate (entries beyond the gate are
forbidden), as the reference feeds them (metrics.py:40).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment

INVALID = np.nan
_BIG = 1e9


def iou_distance_matrix(gt_boxes: np.ndarray, hyp_boxes: np.ndarray, max_iou: float = 0.5):
    """1 - IoU, gated: entries whose distance (1 - IoU) exceeds max_iou are
    invalid, NaN (py-motmetrics' convention: max_iou is the largest allowed
    *distance*).  Boxes are (x, y, w, h)."""
    if gt_boxes.shape[0] == 0 or hyp_boxes.shape[0] == 0:
        return np.zeros((gt_boxes.shape[0], hyp_boxes.shape[0]))
    g = gt_boxes.astype(np.float64)
    h = hyp_boxes.astype(np.float64)
    gx2, gy2 = g[:, 0] + g[:, 2], g[:, 1] + g[:, 3]
    hx2, hy2 = h[:, 0] + h[:, 2], h[:, 1] + h[:, 3]
    xa = np.maximum(g[:, None, 0], h[None, :, 0])
    ya = np.maximum(g[:, None, 1], h[None, :, 1])
    xb = np.minimum(gx2[:, None], hx2[None, :])
    yb = np.minimum(gy2[:, None], hy2[None, :])
    inter = np.maximum(xb - xa, 0) * np.maximum(yb - ya, 0)
    union = (g[:, 2] * g[:, 3])[:, None] + (h[:, 2] * h[:, 3])[None, :] - inter
    iou = np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)
    dist = 1.0 - iou
    return np.where(dist > max_iou, INVALID, dist)


@dataclass
class MOTAccumulator:
    """Event accumulator for one sequence."""

    num_gt: int = 0
    num_misses: int = 0
    num_false_positives: int = 0
    num_switches: int = 0
    num_matches: int = 0
    num_fragmentations: int = 0
    dist_sum: float = 0.0
    # bookkeeping
    last_match: Dict[int, int] = field(default_factory=dict)   # gt -> hyp (last known)
    gt_frames: Dict[int, int] = field(default_factory=dict)    # gt -> #frames seen
    gt_matched_frames: Dict[int, int] = field(default_factory=dict)
    gt_was_matched_prev: Dict[int, bool] = field(default_factory=dict)
    hyp_frames: Dict[int, int] = field(default_factory=dict)
    # identity bookkeeping: (gt, hyp) -> #frames gated-matchable
    pair_overlap: Dict[Tuple[int, int], int] = field(default_factory=dict)

    def update(self, gt_ids, hyp_ids, dists: np.ndarray):
        gt_ids = [int(i) for i in gt_ids]
        hyp_ids = [int(i) for i in hyp_ids]
        n, m = len(gt_ids), len(hyp_ids)
        self.num_gt += n
        for o in gt_ids:
            self.gt_frames[o] = self.gt_frames.get(o, 0) + 1
        for h in hyp_ids:
            self.hyp_frames[h] = self.hyp_frames.get(h, 0) + 1

        valid = ~np.isnan(dists) if dists.size else np.zeros((n, m), bool)
        # identity-metric overlap counts (gate only, no assignment)
        for i, o in enumerate(gt_ids):
            for j, h in enumerate(hyp_ids):
                if n and m and valid[i, j]:
                    k = (o, h)
                    self.pair_overlap[k] = self.pair_overlap.get(k, 0) + 1

        matches: Dict[int, Tuple[int, float]] = {}
        used_h = set()
        # 1) re-establish last-known correspondences still inside the gate
        #    (in gt order; each hyp claimed at most once - py-motmetrics
        #    mot.py update step 1 semantics)
        for i, o in enumerate(gt_ids):
            h_prev = self.last_match.get(o)
            if h_prev is not None and h_prev in hyp_ids and h_prev not in used_h:
                j = hyp_ids.index(h_prev)
                if valid[i, j]:
                    matches[o] = (h_prev, float(dists[i, j]))
                    used_h.add(h_prev)
        # 2) Hungarian on the rest
        free_i = [i for i, o in enumerate(gt_ids) if o not in matches]
        free_j = [j for j, h in enumerate(hyp_ids) if h not in used_h]
        if free_i and free_j:
            C = np.full((len(free_i), len(free_j)), _BIG)
            for a, i in enumerate(free_i):
                for b, j in enumerate(free_j):
                    if valid[i, j]:
                        C[a, b] = dists[i, j]
            rows, cols = linear_sum_assignment(C)
            for a, b in zip(rows, cols):
                if C[a, b] >= _BIG:
                    continue
                o, h = gt_ids[free_i[a]], hyp_ids[free_j[b]]
                matches[o] = (h, float(C[a, b]))
                used_h.add(h)

        # 3) events
        for o in gt_ids:
            if o in matches:
                h, d = matches[o]
                prev_h = self.last_match.get(o)
                if prev_h is not None and prev_h != h:
                    self.num_switches += 1
                else:
                    self.num_matches += 1
                self.dist_sum += d
                self.last_match[o] = h
                # fragmentation: re-acquired after a gap of being unmatched
                if self.gt_was_matched_prev.get(o) is False and prev_h is not None:
                    self.num_fragmentations += 1
                self.gt_was_matched_prev[o] = True
                self.gt_matched_frames[o] = self.gt_matched_frames.get(o, 0) + 1
            else:
                self.num_misses += 1
                self.gt_was_matched_prev[o] = False
        self.num_false_positives += len(hyp_ids) - len(used_h)


def _identity_scores(accs: List[MOTAccumulator]):
    """Global trajectory matching for IDF1/IDP/IDR (per-sequence, summed)."""
    idtp = 0
    total_gt = 0
    total_hyp = 0
    for acc in accs:
        gts = sorted(acc.gt_frames)
        hyps = sorted(acc.hyp_frames)
        total_gt += sum(acc.gt_frames.values())
        total_hyp += sum(acc.hyp_frames.values())
        if not gts or not hyps:
            continue
        nG, nH = len(gts), len(hyps)
        # maximize matched frames == minimize (-overlap)
        C = np.zeros((nG, nH))
        for (o, h), cnt in acc.pair_overlap.items():
            C[gts.index(o), hyps.index(h)] = -cnt
        rows, cols = linear_sum_assignment(C)
        idtp += int(-C[rows, cols].sum())
    idfp = total_hyp - idtp
    idfn = total_gt - idtp
    idf1 = 2 * idtp / max(2 * idtp + idfp + idfn, 1)
    idp = idtp / max(total_hyp, 1)
    idr = idtp / max(total_gt, 1)
    return idf1, idp, idr


def summarize(accs: List[MOTAccumulator]) -> Dict[str, float]:
    """Pooled ("OVERALL") metrics across sequences, like the reference's
    generate_overall aggregation (metrics.py:58-59)."""
    num_gt = sum(a.num_gt for a in accs)
    fn = sum(a.num_misses for a in accs)
    fp = sum(a.num_false_positives for a in accs)
    idsw = sum(a.num_switches for a in accs)
    frag = sum(a.num_fragmentations for a in accs)
    matches = sum(a.num_matches for a in accs) + idsw
    dist = sum(a.dist_sum for a in accs)

    mt = pt = ml = 0
    uniq = 0
    for a in accs:
        for o, nf in a.gt_frames.items():
            uniq += 1
            ratio = a.gt_matched_frames.get(o, 0) / nf
            if ratio >= 0.8:
                mt += 1
            elif ratio >= 0.2:
                pt += 1
            else:
                ml += 1

    idf1, idp, idr = _identity_scores(accs)
    recall = matches / max(num_gt, 1)
    precision = matches / max(matches + fp, 1)
    return {
        "mota": 1.0 - (fn + fp + idsw) / max(num_gt, 1),
        "motp": dist / max(matches, 1),
        "idf1": idf1,
        "idp": idp,
        "idr": idr,
        "recall": recall,
        "precision": precision,
        "num_unique_objects": uniq,
        "mostly_tracked": mt,
        "partially_tracked": pt,
        "mostly_lost": ml,
        "num_false_positives": fp,
        "num_misses": fn,
        "num_switches": idsw,
        "num_fragmentations": frag,
    }


def accumulate_sequence(bbox_pred, bbox_gt, y_out, y_gt, max_iou: float = 0.5):
    """Build an accumulator for one sequence (ref create_mot_accumulator,
    metrics.py:7-44): boxes arrive as [cat, alpha, x1, y1, x2, y2, ...] and
    tracks as (frame, track_id) with -1 = untracked."""
    if y_gt.shape[0] == 0 or y_out.shape[0] == 0:
        return None
    t_st = int(min(y_gt[:, 0].min(), y_out[:, 0].min()))
    t_ed = int(max(y_gt[:, 0].max(), y_out[:, 0].max()))
    acc = MOTAccumulator()
    for t in range(t_st, t_ed + 1):
        oids = np.where((y_gt[:, 0] == t) & (y_gt[:, 1] >= 0))[0]
        hids = np.where((y_out[:, 0] == t) & (y_out[:, 1] >= 0))[0]
        go = bbox_gt[oids, 2:6].copy()
        gh = bbox_pred[hids, 2:6].copy()
        go[:, 2:] -= go[:, :2]  # xyxy -> xywh
        gh[:, 2:] -= gh[:, :2]
        D = iou_distance_matrix(go, gh, max_iou)
        acc.update(y_gt[oids, 1], y_out[hids, 1], D)
    return acc
