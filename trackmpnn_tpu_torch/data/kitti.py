"""KITTI MOT dataset: parsing, augmentation, features and the result
writer (the counterpart of trackmpnn_tpu/data/kitti.py).  Layout:

  <root>/{training,testing}/image_02/<seq>/%06d.png   (frame count; vis input)
  <root>/training/label_02/<seq>.txt                  (17-column KITTI labels)
  <root>/{training,testing}/<detections>_detections/<seq>/%04d.txt
      CSV rows: category,x1,y1,x2,y2,score            (kitti_mot.py:342-364)

bbox rows, both GT and detections (kitti_mot.py:304-308, 360-364):
  [fr, trk_id, cat_id, alpha, x1, y1, x2, y2, h, w, l, x, y, z, rot_y, score]

The train split gives chunks of cur_win_size frames (plus a skip pair),
the val and test splits whole sequences.
"""

from __future__ import annotations

import glob
import os
import random
from typing import Optional

import numpy as np

from trackmpnn_tpu_torch.data import common

CLASS_DICT = {"Pedestrian": 1, "Car": 2, "Cyclist": 3}
ALL_CATS = ["Pedestrian", "Car", "Cyclist", "Van", "Truck", "Person", "Tram", "Misc", "DontCare"]
CAT_IDS = {c: i + 1 for i, c in enumerate(ALL_CATS)}
VAN_ID, DONTCARE_ID = CAT_IDS["Van"], CAT_IDS["DontCare"]
DEFAULT_IM_HW = (375, 1242)  # KITTI's frame (h, w), where a frame is no image

# standardization constants per detector (ref kitti_mot.py:154-177)
NORM_2D = {
    "centertrack": ([0.78, 544.57, 171.58, 71.54, 61.50], [0.14, 285.65, 13.94, 69.92, 47.39]),
    "rrc": ([0.91, 577.11, 178.39, 102.48, 58.36], [0.21, 301.75, 11.55, 78.83, 44.66]),
}


def split_sequences(seqs, split):
    """train/val sequence split: seqs 13, 16, 17 have few or no cars
    (ref kitti_mot.py:206-212)."""
    if split == "train":
        return seqs[0:16] + [seqs[17], seqs[19]]
    if split == "val":
        return [seqs[16], seqs[18], seqs[20]]
    return seqs


class KittiMOTDataset:
    """(features, bbox_pred, bbox_gt, vis) per chunk, as the JAX dataset
    gives them (bbox_gt is empty on the test split, which has no labels).

    With "vis" in feats the embedding net belongs to the caller
    (train/embed.py::EmbedTrainer), so defer_vis must be on: features then
    hold every other column and `vis` is the chunk's vis_meta (frame paths
    with their flip, the detections' feature-map centres, detections a
    frame), which cli/train.py::attach_vis turns into the vis columns.
    Otherwise vis is None.

    random_transforms (train split): each chunk is time-reversed and
    horizontally flipped with probability 0.5 each, and each detection
    dropped with probability 0.2, all drawn from one random.Random(seed) in
    the JAX dataset's order, so one seed gives the same chunks and samples
    in both packages."""

    def __init__(self, root: str, split: str = "train", cat: str = "All",
                 detections: str = "centertrack", feats: str = "2d", cur_win_size: int = 5,
                 ret_win_size: int = 0, random_transforms: bool = False, *,
                 down_ratio: int = 1, input_hw=(384, 1280), num_vis_feats: int = 128,
                 seed: Optional[int] = None, defer_vis: bool = False):
        if "vis" in feats and not defer_vis:
            raise ValueError("feats includes 'vis': the port computes the vis columns "
                             "through the embedding trainer, pass defer_vis=True")
        self.split = split
        self.class_dict = dict(CLASS_DICT)
        if cat == "All":
            self.cats = list(CLASS_DICT) + ["Van", "DontCare"]
        elif cat == "Car":
            self.cats = [cat, "Van", "DontCare"]
        else:
            self.cats = [cat, "DontCare"]
        self.feats = feats
        self.random_transforms = random_transforms
        self.down_ratio = down_ratio
        self.input_hw = input_hw
        self.num_vis_feats = num_vis_feats
        self.dropout_ratio = 0.2
        self.fr_range = 30
        self._label_cache: dict = {}
        self._im_hw_cache: dict = {}
        self._rng = random.Random(seed)

        sub = "testing" if split == "test" else "training"
        self.im_path = os.path.join(root, sub, "image_02")
        self.label_path = None if split == "test" else os.path.join(root, sub, "label_02")
        self.det_path = os.path.join(root, sub, detections + "_detections")
        seqs = split_sequences(sorted(os.listdir(self.im_path)), split)
        num_frames = [len(glob.glob(os.path.join(self.im_path, s, "*.png"))) for s in seqs]
        self.chunks = common.make_chunks(seqs, num_frames, split, cur_win_size, ret_win_size,
                                         stride=max(cur_win_size // 2, 1), rng=self._rng)
        # the vis block is standardised by the trainer (normalized_vis_features)
        self.mean, self.std = common.feature_norm_table(
            feats.replace("vis", ""), len(self.class_dict), *NORM_2D[detections])

    def __len__(self):
        return len(self.chunks)

    # ------------------------------------------------------------ parsing --
    def _im_size(self, seq, fr):
        """(h, w) of a sequence's frames, read from its first frame asked
        for and cached; DEFAULT_IM_HW where the file is no image (the
        placeholders of synthetic trees).  PIL is imported outside the
        fallback: without it the vis path cannot load frames at all
        (train/embed.py::load_image raises too)."""
        if seq not in self._im_hw_cache:
            import PIL.Image

            try:
                with PIL.Image.open(os.path.join(self.im_path, seq, "%.6d.png" % fr)) as im:
                    self._im_hw_cache[seq] = (im.size[1], im.size[0])
            except OSError:
                self._im_hw_cache[seq] = DEFAULT_IM_HW
        return self._im_hw_cache[seq]

    def _label_rows(self, seq):
        """Frame-indexed raw token rows of <seq>.txt, parsed once."""
        cached = self._label_cache.get(seq)
        if cached is None:
            cached = {}
            with open(os.path.join(self.label_path, seq + ".txt")) as f:
                for line in f:
                    t = line.strip().split(" ")
                    cached.setdefault(int(t[0]), []).append(t)
            self._label_cache[seq] = cached
        return cached

    def load_labels(self, seq, fr, im_shape, hflip):
        """GT rows of one frame (empty on the test split); with hflip the
        boxes, alpha, x and rotation_y mirrored in a frame im_shape (h, w)."""
        if self.label_path is None:
            return np.zeros((0, 16), np.float32)
        rows = []
        for t in self._label_rows(seq).get(fr, []):
            name = t[2]
            if name not in self.cats:
                continue
            alpha = float(t[5])
            box = [float(t[6]), float(t[7]), float(t[8]), float(t[9])]
            dim = [float(t[10]), float(t[11]), float(t[12])]
            loc = [float(t[13]), float(t[14]), float(t[15])]
            ry = float(t[16])
            if hflip:
                alpha = -alpha
                box = common.hflip_box(box, im_shape[1])
                loc = [-loc[0], loc[1], loc[2]]
                ry = common.hflip_rotation_y(ry)
            rows.append([fr, int(t[1]), CAT_IDS[name], alpha, *box, *dim, *loc, ry, 1.0])
        return np.array(rows, np.float32) if rows else np.zeros((0, 16), np.float32)

    def load_detections(self, seq, fr, im_shape=None, hflip=False):
        path = os.path.join(self.det_path, seq, "%.4d.txt" % fr)
        if not os.path.exists(path):
            return np.zeros((0, 16), np.float32)
        rows = []
        with open(path) as f:
            for line in f:
                t = line.strip().split(",")
                name = t[0]
                if name not in self.cats or name == "Van":
                    continue  # Vans stay GT-only (kitti_mot.py:357-358)
                box = [float(v) for v in t[1:5]]
                if hflip:
                    box = common.hflip_box(box, im_shape[1])
                rows.append([fr, -1, CAT_IDS[name], -10, *box,
                             -1, -1, -1, -1000, -1000, -1000, -10, float(t[5])])
        return np.array(rows, np.float32) if rows else np.zeros((0, 16), np.float32)

    # ------------------------------------------------------------ samples --
    def __getitem__(self, index):
        """(features, bbox_pred, bbox_gt, vis_meta or None) of one chunk."""
        seq, fr_list = self.chunks[index]
        tr = self.random_transforms and self._rng.random() < 0.5
        hf = self.random_transforms and self._rng.random() < 0.5
        vis_meta = {"images": [], "centers": [], "counts": []} if "vis" in self.feats else None
        preds, gts = [], []
        for fr in fr_list:
            # the frame size is read only where a flip or the vis centres need it
            im_shape = self._im_size(seq, fr) if hf or vis_meta is not None else None
            gt = self.load_labels(seq, fr, im_shape, hf)
            pred = self.load_detections(seq, fr, im_shape, hf)
            if tr:
                if gt.shape[0]:
                    gt[:, 0] = common.time_reverse(gt[:, 0], fr_list)
                if pred.shape[0]:
                    pred[:, 0] = common.time_reverse(pred[:, 0], fr_list)
            pred, gt = common.assign_track_ids(pred, gt, ignore_iom_cats=[DONTCARE_ID],
                                               remove_iou_cats=[VAN_ID])
            if self.random_transforms and pred.shape[0]:
                keep = np.array([self._rng.random() >= self.dropout_ratio
                                 for _ in range(pred.shape[0])])
                pred = pred[keep]
            if vis_meta is not None:
                cy, cx = common.center_indices(pred[:, 4:8], im_shape, self.input_hw,
                                               self.down_ratio)
                vis_meta["images"].append((os.path.join(self.im_path, seq, "%.6d.png" % fr), hf))
                vis_meta["centers"].append((cy, cx))
                vis_meta["counts"].append(pred.shape[0])
            preds.append(pred)
            gts.append(gt)
        bbox_pred = np.concatenate(preds, 0) if preds else np.zeros((0, 16), np.float32)
        bbox_gt = np.concatenate(gts, 0) if gts else np.zeros((0, 16), np.float32)
        features = common.assemble_features(bbox_pred, self.feats.replace("vis", ""),
                                            len(self.class_dict), self.mean, self.std, None,
                                            self.fr_range)
        return features, bbox_pred, bbox_gt, vis_meta


def store_kitti_results(bbox_pred, y_out, class_dict, output_path):
    """KITTI-format result writer with the low-score-Car track filter
    (ref kitti_mot.py:21-73: Car tracks whose max score < 0.7 are dropped).

    bbox_pred: [N, 14] rows (cat, alpha, x1..y2, h, w, l, x, y, z, rot, score);
    y_out: [N, 2] (frame, track_id)."""
    inv = {v: k for k, v in class_dict.items()}
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)

    y_out = y_out.copy()
    for trk in np.unique(y_out[:, 1]):
        if trk < 0:
            continue
        rows = np.where(y_out[:, 1] == trk)[0]
        if rows.size and inv[int(bbox_pred[rows, 0].max())] == "Car":
            if bbox_pred[rows, 13].max() < 0.7:
                y_out[rows, 1] = -1

    t_lo, t_hi = int(y_out[:, 0].min()), int(y_out[:, 0].max())
    with open(output_path, "w") as f:
        for t in range(t_lo, t_hi + 1):
            ids = np.where((y_out[:, 0] == t) & (y_out[:, 1] != -1))[0]
            tracks = y_out[ids, 1].astype(np.int64)
            if tracks.size != np.unique(tracks).size:
                raise ValueError(f"track id repeated within frame {t}")
            for i in ids:
                b = bbox_pred[i]
                f.write(
                    "%d %d %s -1 -1 %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f\n"
                    % (t, int(y_out[i, 1]), inv[int(b[0])], b[1], b[2], b[3], b[4],
                       b[5], b[6], b[7], b[8], b[9], b[10], b[11], b[12], b[13])
                )
    return y_out
