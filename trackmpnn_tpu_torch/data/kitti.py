"""KITTI MOT test split for serving: detection parsing, features (2d,
temp, and vis through a deferred embedding) and the result writer (the
counterpart of trackmpnn_tpu/data/kitti.py).  Layout:

  <root>/testing/image_02/<seq>/%06d.png              (frame count; vis input)
  <root>/testing/<detections>_detections/<seq>/%04d.txt
      CSV rows: category,x1,y1,x2,y2,score            (kitti_mot.py:342-364)

bbox rows (kitti_mot.py:360-364):
  [fr, trk_id, cat_id, alpha, x1, y1, x2, y2, h, w, l, x, y, z, rot_y, score]

Each sample is a whole sequence.  The training and validation splits, with
their labels, chunks and augmentations, come with the training CLI
(ROADMAP.md queue 1, 'Training CLI').
"""

from __future__ import annotations

import glob
import os

import numpy as np

from trackmpnn_tpu_torch.data import common

CLASS_DICT = {"Pedestrian": 1, "Car": 2, "Cyclist": 3}
ALL_CATS = ["Pedestrian", "Car", "Cyclist", "Van", "Truck", "Person", "Tram", "Misc", "DontCare"]
CAT_IDS = {c: i + 1 for i, c in enumerate(ALL_CATS)}
DEFAULT_IM_HW = (375, 1242)  # KITTI's frame (h, w), where a frame is no image

# standardization constants per detector (ref kitti_mot.py:154-177)
NORM_2D = {
    "centertrack": ([0.78, 544.57, 171.58, 71.54, 61.50], [0.14, 285.65, 13.94, 69.92, 47.39]),
    "rrc": ([0.91, 577.11, 178.39, 102.48, 58.36], [0.21, 301.75, 11.55, 78.83, 44.66]),
}


class KittiMOTDataset:
    """The test split: (features, bbox_pred, bbox_gt, vis) per sequence, as
    the JAX dataset gives them (bbox_gt is empty: the split has no labels).

    With "vis" in feats the embedding net belongs to the caller
    (train/embed.py::EmbedTrainer), so defer_vis must be on: features then
    hold every other column and `vis` is the sequence's vis_meta (frame
    paths, the detections' feature-map centres, detections a frame), which
    cli/train.py::attach_vis turns into the vis columns.  Otherwise vis is
    None."""

    def __init__(self, root: str, cat: str = "All", detections: str = "centertrack",
                 feats: str = "2d", *, down_ratio: int = 1, input_hw=(384, 1280),
                 defer_vis: bool = False):
        if "vis" in feats and not defer_vis:
            raise ValueError("feats includes 'vis': the port computes the vis columns "
                             "through the embedding trainer, pass defer_vis=True")
        self.class_dict = dict(CLASS_DICT)
        if cat == "All":
            self.cats = list(CLASS_DICT) + ["Van", "DontCare"]
        elif cat == "Car":
            self.cats = [cat, "Van", "DontCare"]
        else:
            self.cats = [cat, "DontCare"]
        self.feats = feats
        self.down_ratio = down_ratio
        self.input_hw = input_hw
        self.fr_range = 30
        self._im_hw_cache: dict = {}
        self.im_path = os.path.join(root, "testing", "image_02")
        self.det_path = os.path.join(root, "testing", detections + "_detections")
        self.chunks = [(s, list(range(len(glob.glob(os.path.join(self.im_path, s, "*.png"))))))
                       for s in sorted(os.listdir(self.im_path))]
        # the vis block is standardised by the trainer (normalized_vis_features)
        self.mean, self.std = common.feature_norm_table(
            feats.replace("vis", ""), len(self.class_dict), *NORM_2D[detections])

    def __len__(self):
        return len(self.chunks)

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

    def load_detections(self, seq, fr):
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
                rows.append([fr, -1, CAT_IDS[name], -10, *[float(v) for v in t[1:5]],
                             -1, -1, -1, -1000, -1000, -1000, -10, float(t[5])])
        return np.array(rows, np.float32) if rows else np.zeros((0, 16), np.float32)

    def __getitem__(self, index):
        """(features, bbox_pred, bbox_gt, vis_meta or None) of one whole sequence."""
        seq, fr_list = self.chunks[index]
        vis_meta = {"images": [], "centers": [], "counts": []} if "vis" in self.feats else None
        preds = []
        for fr in fr_list:
            pred = self.load_detections(seq, fr)
            if vis_meta is not None:
                cy, cx = common.center_indices(pred[:, 4:8], self._im_size(seq, fr),
                                               self.input_hw, self.down_ratio)
                vis_meta["images"].append((os.path.join(self.im_path, seq, "%.6d.png" % fr),
                                           False))
                vis_meta["centers"].append((cy, cx))
                vis_meta["counts"].append(pred.shape[0])
            preds.append(pred)
        bbox_pred = np.concatenate(preds, 0) if preds else np.zeros((0, 16), np.float32)
        features = common.assemble_features(bbox_pred, self.feats.replace("vis", ""),
                                            len(self.class_dict), self.mean, self.std, None,
                                            self.fr_range)
        return features, bbox_pred, np.zeros((0, 16), np.float32), vis_meta


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
