"""The port's KITTI train/val splits, their helpers and the prefetch
loader against the JAX package's, on the CPU: chunks (the skip pairs
drawn from one random.Random), labels, horizontal flip, time reversal and
detection dropout under one seed, DontCare and Van handling, and the vis
metadata.  Everything is numpy, so the comparisons are exact."""

import random

import numpy as np
import pytest
import torch

from trackmpnn_tpu.data import common as jcommon
from trackmpnn_tpu.data import kitti as jkitti
from trackmpnn_tpu.data.loader import PrefetchLoader as JLoader
from trackmpnn_tpu_torch.data import common, kitti
from trackmpnn_tpu_torch.data.loader import PrefetchLoader
from trackmpnn_tpu_torch.data.synthetic import write_kitti_tree

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """21 sequences (the split takes them by index) of 7 frames with real
    PNGs, plus DontCare and Van labels in sequence 0."""
    root = str(tmp_path_factory.mktemp("kitti") / "kitti")
    write_kitti_tree(root, num_seqs=21, num_frames=7, num_tracks=4, seed=11, real_images=True)
    with open(f"{root}/training/label_02/0000.txt", "a") as f:
        f.write("2 -1 DontCare -1 -1 -10 0 0 1241 374 -1 -1 -1 -1000 -1000 -1000 -10\n")
        f.write("3 7 Van 0 0 -1.2 0 0 1241 374 1.5 1.6 3.7 1.0 1.0 10.0 2.0\n")
    return root


def assert_samples_equal(got, want):
    for x, y in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(x, y)
    if want[3] is None:
        assert got[3] is None
        return
    assert got[3]["images"] == want[3]["images"] and got[3]["counts"] == want[3]["counts"]
    for (gy, gx), (wy, wx) in zip(got[3]["centers"], want[3]["centers"]):
        np.testing.assert_array_equal(gy, wy)
        np.testing.assert_array_equal(gx, wx)


@pytest.mark.parametrize("split,feats,transforms,cat", [
    ("train", "2d+temp", True, "All"), ("train", "2d+temp+vis", True, "Car"),
    ("train", "2d", False, "Pedestrian"), ("val", "2d+temp+vis", False, "All")])
def test_split_matches_jax(tree, split, feats, transforms, cat):
    """Every chunk of the split, in order, from one seed: the random draws
    (skip pairs, reversal, flip, dropout) consume the same stream."""
    kw = dict(down_ratio=1, input_hw=(64, 192), defer_vis=True, seed=7)
    got_ds = kitti.KittiMOTDataset(tree, split, cat, "rrc", feats, 4, 3, transforms, **kw)
    want_ds = jkitti.KittiMOTDataset(tree, split, cat, "rrc", feats, 4, 3,
                                     random_transforms=transforms, **kw)
    assert got_ds.chunks == want_ds.chunks and len(got_ds) >= (3 if split == "val" else 20)
    flipped = reversed_ = 0
    for i in range(len(got_ds)):
        got, want = got_ds[i], want_ds[i]
        assert_samples_equal(got, want)
        if got[3] is not None:
            flipped += any(hf for _, hf in got[3]["images"])
        reversed_ += bool(got[1].shape[0]) and got[1][0, 0] > got[1][-1, 0]
    if transforms and got[3] is not None:
        assert flipped > 0 and reversed_ > 0


def test_labels_flip_and_ignore_regions(tree):
    """load_labels with and without the flip; the DontCare region removes
    unassigned detections and the Van's box removes them by IoU."""
    got_ds = kitti.KittiMOTDataset(tree, "train", "All", "rrc", "2d", 4, 0)
    want_ds = jkitti.KittiMOTDataset(tree, "train", "All", "rrc", "2d", 4, 0)
    for fr in range(7):
        for hf in (False, True):
            np.testing.assert_array_equal(got_ds.load_labels("0000", fr, (375, 1242), hf),
                                          want_ds.load_labels("0000", fr, (375, 1242), hf))
    dets = got_ds.load_detections("0000", 2)
    labels = got_ds.load_labels("0000", 2, (375, 1242), False)
    pred, gt = common.assign_track_ids(dets.copy(), labels.copy(), [kitti.DONTCARE_ID],
                                       [kitti.VAN_ID])
    wpred, wgt = jcommon.assign_track_ids(dets.copy(), labels.copy(), [kitti.DONTCARE_ID],
                                          [kitti.VAN_ID])
    np.testing.assert_array_equal(pred, wpred)
    np.testing.assert_array_equal(gt, wgt)
    assert kitti.DONTCARE_ID not in gt[:, 2] and (pred[:, 1] >= 0).all()


def test_helpers_match_jax():
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 300, (6, 4)).astype(np.float32)
    a[:, 2:] += a[:, :2]
    b = rng.uniform(0, 300, (5, 4)).astype(np.float32)
    b[:, 2:] += b[:, :2]
    np.testing.assert_array_equal(common.pairwise_iou(a, b), jcommon.pairwise_iou(a, b))
    np.testing.assert_array_equal(common.pairwise_iom(a, b), jcommon.pairwise_iom(a, b))
    for ry in (-3.0, -1.0, 0.0, 1.0, 2.5):
        assert common.hflip_rotation_y(ry) == jcommon.hflip_rotation_y(ry)
    assert common.hflip_box([1, 2, 30, 40], 100) == jcommon.hflip_box([1, 2, 30, 40], 100)
    frs = [3, 4, 5, 9, 10]
    np.testing.assert_array_equal(common.time_reverse(np.array(frs, np.float32), frs),
                                  jcommon.time_reverse(np.array(frs, np.float32), frs))
    args = (["s0", "s1"], [9, 13], "train", 4, 5)
    r1, r2 = random.Random(2), random.Random(2)
    assert common.make_chunks(*args, stride=2, rng=r1) == jcommon.make_chunks(*args, stride=2,
                                                                              rng=r2)
    assert r1.random() == r2.random()  # the stream was consumed alike


@pytest.mark.parametrize("workers", [1, 2])
def test_prefetch_loader_keeps_order(workers):
    """Results come in `order`, whatever the workers; with random_transforms
    off (or one worker) a run repeats itself, as the JAX loader's does."""
    order = [5, 2, 7, 0, 3]
    got = list(PrefetchLoader(lambda i: i * i, order, depth=2, workers=workers))
    assert got == list(JLoader(lambda i: i * i, order, depth=2, workers=workers))
    assert got == [i * i for i in order] and len(PrefetchLoader(abs, order)) == 5


def test_one_worker_loader_repeats_the_jax_stream(tree):
    """With random_transforms on, the dataset's draws (reversal, flip,
    dropout) come from one random.Random in call order.  One worker calls
    in `order`, so the port's loader gives the JAX loader's samples; with
    two workers the draws follow the threads' timing in both packages (the
    training CLI's 2d/temp route), so such a run does not repeat itself."""
    kw = dict(down_ratio=1, input_hw=(64, 192), defer_vis=True, seed=5)
    got_ds = kitti.KittiMOTDataset(tree, "train", "All", "rrc", "2d+temp", 4, 2, True, **kw)
    want_ds = jkitti.KittiMOTDataset(tree, "train", "All", "rrc", "2d+temp", 4, 2,
                                     random_transforms=True, **kw)
    order = list(np.random.default_rng(5).permutation(len(got_ds)))[:12]
    got = list(PrefetchLoader(got_ds.__getitem__, order, depth=4, workers=1))
    want = list(JLoader(want_ds.__getitem__, order, depth=4, workers=1))
    for g, w in zip(got, want):
        assert_samples_equal(g, w)
