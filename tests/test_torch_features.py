"""The port's feature assembly (trackmpnn_tpu_torch/data/common.py) and
KITTI test split (data/kitti.py) against the JAX package's, on the same
numpy inputs and the same synthetic tree.  Both are numpy on both sides, so
features agree to 1e-6 (the same operations; sin/cos and exp may round in
the last bit) and everything else exactly."""

import numpy as np
import pytest

from trackmpnn_tpu.data import common as jcommon
from trackmpnn_tpu.data import kitti as jkitti
from trackmpnn_tpu_torch.data import common, kitti
from trackmpnn_tpu_torch.data.synthetic import make_sequence, write_kitti_tree

FEATS = ["2d", "temp", "2d+temp", "2d+vis", "2d+temp+vis", "vis"]


def bbox_rows(seed=0):
    _, bbox_pred, _ = make_sequence(num_tracks=5, num_frames=40, seed=seed)
    return bbox_pred


def test_temporal_features_and_softmax_rows():
    frames = np.arange(-3, 70, dtype=np.float32)[:, None]
    np.testing.assert_allclose(common.temporal_features(frames),
                               jcommon.temporal_features(frames), rtol=0, atol=1e-6)
    np.testing.assert_allclose(common.temporal_features(frames, 7),
                               jcommon.temporal_features(frames, 7), rtol=0, atol=1e-6)
    x = np.random.default_rng(0).normal(size=(9, 16)) * 5
    np.testing.assert_allclose(common.softmax_rows(x), jcommon.softmax_rows(x), rtol=1e-12)


@pytest.mark.parametrize("feats", FEATS)
def test_norm_table_and_assemble_features(feats):
    bp = bbox_rows(1)
    for mean_2d, std_2d in kitti.NORM_2D.values():
        got = common.feature_norm_table(feats, 3, mean_2d, std_2d, 16)
        want = jcommon.feature_norm_table(feats, 3, list(mean_2d), list(std_2d), 16)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    mean, std = got
    vis = np.random.default_rng(2).normal(size=(bp.shape[0], 16)).astype(np.float32)
    args = (feats, 3, mean, std, vis if "vis" in feats else None)
    f = common.assemble_features(bp, *args)
    assert f.dtype == np.float32 and f.shape == (bp.shape[0], mean.shape[0])
    np.testing.assert_allclose(f, jcommon.assemble_features(bp, *args), rtol=0, atol=1e-6)
    empty = common.assemble_features(bp[:0], *args[:4], None if "vis" not in feats else vis[:0])
    assert empty.shape == (0, mean.shape[0])
    if "vis" in feats:
        with pytest.raises(ValueError, match="vis"):
            common.assemble_features(bp, *args[:4], None)


@pytest.mark.parametrize("down_ratio,input_hw", [(1, (384, 1280)), (4, (384, 1280)),
                                                 (1, (64, 192))])
def test_center_indices(down_ratio, input_hw):
    bp = bbox_rows(3)
    boxes = np.concatenate([bp[:, 4:8], [[-50, -40, -10, -5], [1300, 400, 1400, 500]]])
    for im_shape in ((375, 1242), (370, 1224)):
        got = common.center_indices(boxes, im_shape, input_hw, down_ratio)
        want = jcommon.center_indices(boxes, im_shape, input_hw, down_ratio)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert all(a.size == 0 for a in common.center_indices(boxes[:0], (375, 1242), input_hw, 1))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Two small KITTI test trees of 2 sequences: placeholder frames (the
    image size falls back to the default) and real PNGs."""
    out = {}
    for real in (False, True):
        root = str(tmp_path_factory.mktemp("kitti") / "kitti")
        write_kitti_tree(root, num_seqs=2, num_frames=7, num_tracks=5, split_dir="testing",
                         seed=4, real_images=real)
        out[real] = root
    return out


@pytest.mark.parametrize("feats,real,arch", [
    ("2d", False, "espv2"), ("2d+temp", False, "espv2"), ("2d+temp+vis", False, "espv2"),
    ("2d+temp+vis", True, "espv2"), ("2d+vis", True, "dla34"), ("vis", True, "espv2")])
def test_test_split_matches_jax(trees, feats, real, arch):
    """KittiMOTDataset's test split with defer_vis, as both CLIs build it:
    features, bbox_pred, bbox_gt and vis_meta of every sequence."""
    down, hw = (1 if arch == "espv2" else 4), (64, 192)
    kw = dict(down_ratio=down, input_hw=hw, defer_vis=True)
    got_ds = kitti.KittiMOTDataset(trees[real], "test", "All", "rrc", feats, **kw)
    want_ds = jkitti.KittiMOTDataset(trees[real], "test", "All", "rrc", feats, 5, 0, **kw)
    assert len(got_ds) == len(want_ds) == 2
    np.testing.assert_array_equal(got_ds.mean, want_ds.mean)
    np.testing.assert_array_equal(got_ds.std, want_ds.std)
    for i in range(2):
        got, want = got_ds[i], want_ds[i]
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        if "vis" not in feats:
            assert got[3] is None and want[3] is None
            continue
        assert got[3]["images"] == want[3]["images"] and got[3]["counts"] == want[3]["counts"]
        assert sum(got[3]["counts"]) == got[1].shape[0] > 0
        for (gy, gx), (wy, wx) in zip(got[3]["centers"], want[3]["centers"]):
            np.testing.assert_array_equal(gy, wy)
            np.testing.assert_array_equal(gx, wx)
    im_hw = got_ds._im_size("0000", 0)
    assert im_hw == ((375, 1242) if real else kitti.DEFAULT_IM_HW)


def test_test_split_refusals(trees):
    with pytest.raises(ValueError, match="defer_vis"):
        kitti.KittiMOTDataset(trees[False], "test", "All", "rrc", "2d+vis")
