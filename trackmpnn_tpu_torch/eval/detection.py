"""Detection mAP (faster-rcnn style; the counterpart of
trackmpnn_tpu/eval/detection.py), reproducing the reference's custom
evaluator semantics (ref utils/metrics.py:93-229):
per class, detections are matched to annotations per frame in stored
order (each annotation claimable once, IoU >= threshold), then tp/fp are
sorted globally by score, cumsummed, and AP computed with the precision
envelope over recall change points."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _iou_1_to_many(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """+1-convention IoU, as the reference's vectorized_iou (misc.py:4-22)."""
    xa = np.maximum(box[0], boxes[:, 0])
    ya = np.maximum(box[1], boxes[:, 1])
    xb = np.minimum(box[2], boxes[:, 2])
    yb = np.minimum(box[3], boxes[:, 3])
    inter = np.maximum(xb - xa + 1, 0) * np.maximum(yb - ya + 1, 0)
    a1 = (box[2] - box[0] + 1) * (box[3] - box[1] + 1)
    a2 = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
    return inter / (a1 + a2 - inter)


def _average_precision(recall: np.ndarray, precision: np.ndarray) -> float:
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([0.0], precision, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    changed = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[changed + 1] - mrec[changed]) * mpre[changed + 1]))


def _index_by_frame_class(bbox_dict):
    """{seq: (y[N,2], bbox[N,14])} -> {(seq, frame): {class: [x1,y1,x2,y2,score]}}"""
    out: Dict[Tuple[str, int], Dict[int, list]] = {}
    classes = set()
    frames = set()
    for seq, (y, bbox) in bbox_dict.items():
        for i in range(y.shape[0]):
            key = (seq, int(y[i, 0]))
            cls = int(bbox[i, 0])
            classes.add(cls)
            frames.add(key)
            out.setdefault(key, {}).setdefault(cls, []).append(
                [bbox[i, 2], bbox[i, 3], bbox[i, 4], bbox[i, 5], bbox[i, 13]]
            )
    return out, frames, classes


def compute_map(bbox_pred_dict, bbox_gt_dict, iou_threshold: float = 0.5) -> float:
    """bbox rows: (cat, alpha, x1, y1, x2, y2, h, w, l, x, y, z, rot, score)."""
    dets, _, _ = _index_by_frame_class(bbox_pred_dict)
    anns, ann_frames, classes = _index_by_frame_class(bbox_gt_dict)
    # the reference iterates unique_ids built from the GT dict ONLY
    # (metrics.py:136): a frame with detections but zero GT rows is never
    # visited, so those detections are neither FPs nor PR-curve entries.
    # It builds those ids as np.unique of "seq_frame" STRINGS
    # (metrics.py:104), i.e. LEXICOGRAPHIC order ("0_10" < "0_2") — under
    # tied detection scores the tp/fp visit order changes the cumsum and
    # hence AP, so we must walk frames in the same order to be
    # bit-identical (pinned by the BDD parity tree: 94.3240 both).
    all_frames = sorted(ann_frames, key=lambda k: f"{k[0]}_{k[1]}")

    aps = {}
    for cls in sorted(classes):
        tp, fp, scores = [], [], []
        num_ann = 0
        for key in all_frames:
            d = dets.get(key, {}).get(cls, [])
            a = np.array(anns.get(key, {}).get(cls, []), np.float64)
            num_ann += len(a)
            claimed = set()
            for box in d:
                scores.append(box[4])
                if len(a) == 0:
                    fp.append(1)
                    tp.append(0)
                    continue
                ious = _iou_1_to_many(np.array(box[:4], np.float64), a[:, :4])
                j = int(np.argmax(ious))
                if ious[j] >= iou_threshold and j not in claimed:
                    tp.append(1)
                    fp.append(0)
                    claimed.add(j)
                else:
                    fp.append(1)
                    tp.append(0)
        if num_ann == 0:
            aps[cls] = (0.0, 0)
            continue
        order = np.argsort(-np.asarray(scores))
        tp_c = np.cumsum(np.asarray(tp)[order])
        fp_c = np.cumsum(np.asarray(fp)[order])
        recall = tp_c / num_ann
        precision = tp_c / np.maximum(tp_c + fp_c, np.finfo(np.float64).eps)
        aps[cls] = (_average_precision(recall, precision), num_ann)

    present = [(ap, n) for ap, n in aps.values() if n > 0]
    if not present:
        return 0.0
    return float(sum(ap for ap, _ in present) / len(present))
