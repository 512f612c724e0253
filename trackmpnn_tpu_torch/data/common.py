"""Feature assembly for the serving path (numpy; the counterpart of
trackmpnn_tpu/data/common.py:146-235).  The test split carries no labels,
so GT track-id assignment, training chunks and augmentations come with the
training split (ROADMAP.md queue 1, 'Training CLI').
"""

from __future__ import annotations

from typing import Optional

import numpy as np


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
