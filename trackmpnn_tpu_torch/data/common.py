"""Shared dataset machinery (numpy; the counterpart of
trackmpnn_tpu/data/common.py): IoU/IoM, GT track-id assignment,
augmentations and chunking for the training and validation splits, and the
feature assembly of every split.
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence, Tuple

import numpy as np


# ------------------------------------------------------------- geometry ----
def pairwise_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU with the reference's +1 pixel convention (misc.py:4-22)."""
    xa = np.maximum(a[:, None, 0], b[None, :, 0])
    ya = np.maximum(a[:, None, 1], b[None, :, 1])
    xb = np.minimum(a[:, None, 2], b[None, :, 2])
    yb = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.maximum(xb - xa + 1, 0) * np.maximum(yb - ya + 1, 0)
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def pairwise_iom(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Intersection over min-area (for ignore regions, misc.py:24-42)."""
    xa = np.maximum(a[:, None, 0], b[None, :, 0])
    ya = np.maximum(a[:, None, 1], b[None, :, 1])
    xb = np.minimum(a[:, None, 2], b[None, :, 2])
    yb = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.maximum(xb - xa + 1, 0) * np.maximum(yb - ya + 1, 0)
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    return inter / np.minimum(area_a[:, None], area_b[None, :])


# -------------------------------------------------- track id assignment ----
def assign_track_ids(
    bbox_pred: np.ndarray,
    bbox_gt: np.ndarray,
    ignore_iom_cats: Sequence[int] = (),
    remove_iou_cats: Sequence[int] = (),
    iou_thresh: float = 0.5,
    iom_thresh: float = 0.8,
) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy descending-IoU assignment of GT track ids to detections
    (ref kitti_mot.py:422-486 / bdd100k_mot.py get_track_ids).

    ignore_iom_cats: GT category ids treated as ignore regions - unassigned
    detections overlapping them by IoM >= iom_thresh are dropped (KITTI
    DontCare=9 / BDD crowd=-1).
    remove_iou_cats: GT category ids whose boxes delete unassigned
    detections by IoU >= iou_thresh (KITTI Van=4 / BDD distractors=9).
    Both category groups are removed from the returned GT.
    """
    if bbox_gt.size == 0:
        return bbox_pred, bbox_gt

    ignore_boxes = bbox_gt[np.isin(bbox_gt[:, 2], ignore_iom_cats)]
    remove_boxes = bbox_gt[np.isin(bbox_gt[:, 2], remove_iou_cats)]
    keep_mask = ~np.isin(bbox_gt[:, 2], list(ignore_iom_cats) + list(remove_iou_cats))
    bbox_gt = bbox_gt[keep_mask]

    if bbox_pred.size == 0:
        return bbox_pred, bbox_gt

    if bbox_gt.size > 0:
        ious = pairwise_iou(bbox_pred[:, 4:8], bbox_gt[:, 4:8])
        order = np.unravel_index(np.argsort(ious, axis=None)[::-1], ious.shape)
        gt_taken = np.zeros(ious.shape[1], bool)
        for r, c in zip(*order):
            if ious[r, c] < iou_thresh:
                break
            if bbox_pred[r, 1] < 0 and not gt_taken[c] and bbox_pred[r, 2] == bbox_gt[c, 2]:
                bbox_pred[r, 1] = bbox_gt[c, 1]
                gt_taken[c] = True

    if ignore_boxes.size > 0:
        ioms = pairwise_iom(bbox_pred[:, 4:8], ignore_boxes[:, 4:8]).max(axis=1)
        bbox_pred = bbox_pred[~((bbox_pred[:, 1] < 0) & (ioms >= iom_thresh))]
    if remove_boxes.size > 0 and bbox_pred.size > 0:
        ious = pairwise_iou(bbox_pred[:, 4:8], remove_boxes[:, 4:8]).max(axis=1)
        bbox_pred = bbox_pred[~((bbox_pred[:, 1] < 0) & (ious >= iou_thresh))]
    return bbox_pred, bbox_gt


# --------------------------------------------------------- augmentations ----
def hflip_box(box: List[float], im_w: int) -> List[float]:
    """Horizontal flip of [x1, y1, x2, y2] (ref kitti_mot.py:288-289)."""
    return [im_w - box[2] - 1, box[1], im_w - box[0] - 1, box[3]]


def hflip_rotation_y(ry: float) -> float:
    """KITTI rotation_y remap under horizontal flip (kitti_mot.py:291-298)."""
    if -np.pi <= ry <= -np.pi / 2:
        return np.pi / 2 + ry
    if -np.pi / 2 < ry <= 0:
        return -np.pi / 2 + ry
    if 0 < ry <= np.pi / 2:
        return np.pi / 2 + ry
    return -np.pi / 2 + ry


def time_reverse(frames: np.ndarray, fr_list: Sequence[int]) -> np.ndarray:
    """Reverse the chunk's time axis (ref kitti_mot.py:522-524)."""
    return fr_list[-1] - frames + fr_list[0]


# --------------------------------------------------------------- chunking ----
def make_chunks(
    seqs: Sequence[str],
    num_frames: Sequence[int],
    split: str,
    cur_win_size: int,
    ret_win_size: int,
    stride: Optional[int] = None,
    rng: Optional[random.Random] = None,
):
    """Training chunks: cur_win_size frames at `stride`, plus a random
    skip-pair teaching long-gap re-association (ref kitti_mot.py:218-227;
    BDD uses stride = cur_win_size, bdd100k_mot.py:210).  Eval: whole
    sequences."""
    rng = rng or random
    chunks = []
    if split == "train":
        for seq, nf in zip(seqs, num_frames):
            for st in range(0, nf, stride if stride is not None else max(cur_win_size // 2, 1)):
                frs = list(range(st, min(st + cur_win_size, nf)))
                skip = rng.randint(st + cur_win_size, st + cur_win_size + ret_win_size)
                if skip < nf - 1:
                    frs += [skip, skip + 1]
                chunks.append((seq, frs))
    else:
        for seq, nf in zip(seqs, num_frames):
            chunks.append((seq, list(range(nf))))
    return chunks



# --------------------------------------------------------------- features ----
def temporal_features(frames: np.ndarray, fr_range: int = 30) -> np.ndarray:
    """Bounded cyclic frame encoding [sin, cos] (ref kitti_mot.py:414-420)."""
    phase = np.mod(frames, fr_range) * np.pi / fr_range
    return np.concatenate([np.sin(phase), np.cos(phase)], axis=1)


def softmax_rows(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def assemble_features(bbox_pred: np.ndarray, feats: str, ncategories: int,
                      mean: np.ndarray, std: np.ndarray,
                      vis_feats: Optional[np.ndarray] = None,
                      fr_range: int = 30) -> np.ndarray:
    """[one-hot cat | score,xc,yc,w,h | sin,cos | softmax(vis)] standardized
    (ref kitti_mot.py:545-566); the one-hot columns are there whatever
    `feats` says, as in the reference."""
    n = bbox_pred.shape[0]
    cols = [np.eye(ncategories, dtype=np.float32)[
        np.clip(bbox_pred[:, 2].astype(np.int64) - 1, 0, ncategories - 1)
    ]] if n else [np.zeros((0, ncategories), np.float32)]
    if "2d" in feats:
        xc = (bbox_pred[:, 4] + bbox_pred[:, 6]) / 2
        yc = (bbox_pred[:, 5] + bbox_pred[:, 7]) / 2
        w = bbox_pred[:, 6] - bbox_pred[:, 4]
        h = bbox_pred[:, 7] - bbox_pred[:, 5]
        cols.append(np.stack([bbox_pred[:, 15], xc, yc, w, h], axis=1).astype(np.float32))
    if "temp" in feats:
        cols.append(temporal_features(bbox_pred[:, 0:1], fr_range).astype(np.float32))
    if "vis" in feats:
        if vis_feats is None:
            raise ValueError("vis features requested but no embedding outputs given")
        cols.append(softmax_rows(vis_feats).astype(np.float32))
    if not n:
        return np.zeros((0, sum(c.shape[1] for c in cols)), np.float32)
    return (np.concatenate(cols, axis=1) - mean) / std


def feature_norm_table(feats: str, ncategories: int, mean_2d, std_2d, num_vis: int = 128):
    """Per-branch standardization constants (ref kitti_mot.py:154-177)."""
    mean = [0.5] * ncategories
    std = [0.5] * ncategories
    if "2d" in feats:
        mean += list(mean_2d)
        std += list(std_2d)
    if "temp" in feats:
        mean += [0.0, 0.0]
        std += [1.0, 1.0]
    if "vis" in feats:
        mean += [0.5] * num_vis
        std += [0.5] * num_vis
    return np.array(mean, np.float32), np.array(std, np.float32)


def center_indices(bboxes: np.ndarray, im_shape, input_hw, down_ratio: int):
    """(cy, cx) integer embedding-map coordinates of the box centres
    (ref kitti_mot.py:396-405); bboxes [N, 4] as x1, y1, x2, y2 in the
    image's pixels, im_shape its (h, w)."""
    if bboxes.shape[0] == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    in_h, in_w = input_hw
    cx = (bboxes[:, 0] + bboxes[:, 2]) / 2.0 * in_w / im_shape[1]
    cy = (bboxes[:, 1] + bboxes[:, 3]) / 2.0 * in_h / im_shape[0]
    cx = np.clip((cx / down_ratio).astype(np.int64), 0, in_w // down_ratio - 1)
    cy = np.clip((cy / down_ratio).astype(np.int64), 0, in_h // down_ratio - 1)
    return cy, cx
