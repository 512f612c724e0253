"""Deterministic synthetic MOT sequences for tests and the chip smoke run
(numpy; the counterpart of trackmpnn_tpu/data/synthetic.py:19-167, same
generator, so one seed gives the same sequence in both packages).

Produces the same interface as the real datasets: per-sequence
(features, bbox_pred, bbox_gt) with bbox rows
[fr, trk_id, cat_id, alpha, x1, y1, x2, y2, h, w, l, x, y, z, rot, score]
(ref kitti_mot.py:304-308) and 2d-branch features
[one-hot category | score, xc, yc, w, h] (kitti_mot.py:547-552).
"""

from __future__ import annotations

import os

import numpy as np

IM_W, IM_H = 1242, 375


def make_sequence(
    num_tracks: int = 6,
    num_frames: int = 20,
    ncategories: int = 3,
    fp_rate: float = 0.15,
    miss_rate: float = 0.1,
    seed: int = 5,
    noise: float = 2.0,
):
    """Linear-motion tracks with noisy detections, misses, and FPs.

    Returns (features f32[N,F], bbox_pred f32[N,16], bbox_gt f32[M,16]).
    bbox_pred[:, 1] already carries the GT-assigned track id (-1 for FPs),
    i.e. the output of the IoU assignment stage (kitti_mot.py:422-486).
    """
    rng = np.random.default_rng(seed)
    # track birth/death, start boxes, velocities
    birth = rng.integers(0, max(num_frames // 3, 1), num_tracks)
    death = rng.integers(2 * num_frames // 3, num_frames, num_tracks) + 1
    cx0 = rng.uniform(100, IM_W - 100, num_tracks)
    cy0 = rng.uniform(100, IM_H - 100, num_tracks)
    w = rng.uniform(40, 120, num_tracks)
    h = rng.uniform(30, 90, num_tracks)
    vx = rng.uniform(-8, 8, num_tracks)
    vy = rng.uniform(-3, 3, num_tracks)
    cat = rng.integers(1, ncategories + 1, num_tracks)

    pred_rows, gt_rows = [], []
    for fr in range(num_frames):
        for k in range(num_tracks):
            if not (birth[k] <= fr < death[k]):
                continue
            cx = cx0[k] + vx[k] * fr
            cy = cy0[k] + vy[k] * fr
            box = [cx - w[k] / 2, cy - h[k] / 2, cx + w[k] / 2, cy + h[k] / 2]
            gt_rows.append([fr, k, cat[k], 0.0, *box, -1, -1, -1, -1000, -1000, -1000, -10, 1.0])
            if rng.random() < miss_rate:
                continue
            nb = [b + rng.normal(0, noise) for b in box]
            score = float(np.clip(rng.normal(0.9, 0.05), 0.5, 1.0))
            pred_rows.append([fr, k, cat[k], -10.0, *nb, -1, -1, -1, -1000, -1000, -1000, -10, score])
        # false positives
        n_fp = rng.poisson(fp_rate * num_tracks)
        for _ in range(n_fp):
            fw, fh = rng.uniform(30, 100), rng.uniform(20, 80)
            fx, fy = rng.uniform(0, IM_W - fw), rng.uniform(0, IM_H - fh)
            score = float(np.clip(rng.normal(0.6, 0.1), 0.3, 1.0))
            pred_rows.append(
                [fr, -1, rng.integers(1, ncategories + 1), -10.0,
                 fx, fy, fx + fw, fy + fh, -1, -1, -1, -1000, -1000, -1000, -10, score]
            )

    bbox_pred = np.array(pred_rows, np.float32) if pred_rows else np.zeros((0, 16), np.float32)
    bbox_gt = np.array(gt_rows, np.float32) if gt_rows else np.zeros((0, 16), np.float32)
    # stable frame-major order, FPs interleaved as produced
    if bbox_pred.shape[0]:
        order = np.argsort(bbox_pred[:, 0], kind="stable")
        bbox_pred = bbox_pred[order]
    features = features_2d(bbox_pred, ncategories)
    return features, bbox_pred, bbox_gt


CAT_NAMES = {1: "Pedestrian", 2: "Car", 3: "Cyclist"}


def write_kitti_tree(
    root: str,
    num_seqs: int = 21,
    num_frames: int = 30,
    num_tracks: int = 6,
    split_dir: str = "training",
    detections: str = "rrc",
    seed: int = 0,
    real_images: bool = False,
    **seq_kwargs,
):
    """Render synthetic sequences into a KITTI MOT file tree (image
    placeholders for frame counting, per-frame detection CSVs, 17-column
    label files) so the dataset pipeline - parsing, IoU track-id
    assignment, chunking - runs end-to-end without real data.

    With `real_images=True` every frame is a decodable IM_W x IM_H grey PNG
    (one encode, its bytes written for every frame; needs PIL), so the vis
    path, which opens the images, runs on the same tree."""
    png_bytes = None
    if real_images:
        import io

        from PIL import Image

        buf = io.BytesIO()
        Image.new("RGB", (IM_W, IM_H), (96, 96, 96)).save(buf, format="PNG")
        png_bytes = buf.getvalue()

    for s in range(num_seqs):
        seq = "%04d" % s
        imdir = os.path.join(root, split_dir, "image_02", seq)
        detdir = os.path.join(root, split_dir, f"{detections}_detections", seq)
        os.makedirs(imdir, exist_ok=True)
        os.makedirs(detdir, exist_ok=True)
        _, bbox_pred, bbox_gt = make_sequence(
            num_tracks=num_tracks, num_frames=num_frames, seed=seed + s,
            **seq_kwargs,
        )
        label_lines = []
        for fr in range(num_frames):
            if png_bytes is not None:
                with open(os.path.join(imdir, "%.6d.png" % fr), "wb") as imf:
                    imf.write(png_bytes)
            else:
                open(os.path.join(imdir, "%.6d.png" % fr), "ab").close()
            with open(os.path.join(detdir, "%.4d.txt" % fr), "w") as f:
                for b in bbox_pred[bbox_pred[:, 0] == fr]:
                    name = CAT_NAMES[int(b[2])]
                    f.write(f"{name},{b[4]:.2f},{b[5]:.2f},{b[6]:.2f},"
                            f"{b[7]:.2f},{b[15]:.3f}\n")
            for b in bbox_gt[bbox_gt[:, 0] == fr]:
                name = CAT_NAMES[int(b[2])]
                label_lines.append(
                    f"{fr} {int(b[1])} {name} 0 0 {b[3]:.2f} {b[4]:.2f} "
                    f"{b[5]:.2f} {b[6]:.2f} {b[7]:.2f} 1.5 1.6 3.7 1.0 1.0 "
                    f"10.0 0.1"
                )
        labdir = os.path.join(root, split_dir, "label_02")
        os.makedirs(labdir, exist_ok=True)
        with open(os.path.join(labdir, seq + ".txt"), "w") as f:
            f.write("\n".join(label_lines) + "\n")


def features_2d(bbox_pred: np.ndarray, ncategories: int) -> np.ndarray:
    """2d-branch features: one-hot category + [score, xc, yc, w, h], standardized."""
    n = bbox_pred.shape[0]
    if n == 0:
        return np.zeros((0, ncategories + 5), np.float32)
    onehot = np.eye(ncategories, dtype=np.float32)[
        np.clip(bbox_pred[:, 2].astype(np.int64) - 1, 0, ncategories - 1)
    ]
    xc = (bbox_pred[:, 4] + bbox_pred[:, 6]) / 2
    yc = (bbox_pred[:, 5] + bbox_pred[:, 7]) / 2
    bw = bbox_pred[:, 6] - bbox_pred[:, 4]
    bh = bbox_pred[:, 7] - bbox_pred[:, 5]
    two_d = np.stack([bbox_pred[:, 15], xc, yc, bw, bh], 1).astype(np.float32)
    feats = np.concatenate([onehot, two_d], 1)
    mean = np.array([0.5] * ncategories + [0.85, IM_W / 2, IM_H / 2, 80.0, 55.0], np.float32)
    std = np.array([0.5] * ncategories + [0.15, IM_W / 4, IM_H / 8, 60.0, 40.0], np.float32)
    return (feats - mean) / std
