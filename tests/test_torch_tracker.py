"""The port's Tracker against the JAX package's, on the CPU, with the same
converted weights.  The weights are numpy-made with spread (std 0.3, zero
head biases) so that scores fall on both sides of 0.5 and associations
really happen.  Per-step scores must agree within atol 1e-5 (f32 sums in
different orders); decoded tracks must be identical."""

import numpy as np
import pytest
import torch

from torch_port_util import spread_weights
from trackmpnn_tpu.decode import Tracker as JTracker
from trackmpnn_tpu.decode import TrackerConfig as JTrackerConfig
from trackmpnn_tpu.models import mpnn as jmpnn
from trackmpnn_tpu_torch.data.synthetic import make_sequence
from trackmpnn_tpu_torch.decode import Tracker, TrackerConfig
from trackmpnn_tpu_torch.models import mpnn, weights

torch.set_num_threads(1)

CFG_J = jmpnn.ModelConfig(features="2d", ncategories=3, nhidden=16, msg_type="diff")
CFG_T = mpnn.ModelConfig(features="2d", ncategories=3, nhidden=16, msg_type="diff")


def gap_sequence():
    """Two bursts of detections with a long empty gap between them: with
    ret_win 0 and a small window the graph empties and must re-initialize."""
    rows = [[fr, k] for fr in (0, 1, 2) for k in (0, 1)]
    rows += [[fr, k] for fr in (20, 21, 22) for k in (2, 3)]
    y = np.array(rows, np.int64)
    X = np.random.default_rng(9).normal(size=(len(y), CFG_T.nfeatures)).astype(np.float32)
    return X, y


def synthetic(seed):
    X, bbox_pred, _ = make_sequence(num_tracks=8, num_frames=12, seed=seed)
    return X, bbox_pred[:, :2].astype(np.int64)


CASES = {
    "hungarian": dict(seq=lambda: synthetic(0), cfg=dict(cur_win_size=5, hungarian=True)),
    "greedy": dict(seq=lambda: synthetic(1), cfg=dict(cur_win_size=5, hungarian=False)),
    "retain_prune_no_tp": dict(seq=lambda: synthetic(2),
                               cfg=dict(cur_win_size=4, ret_win_size=2, hungarian=True,
                                        prune_threshold=0.5, tp_classifier=False)),
    "reinit_after_gap": dict(seq=gap_sequence, cfg=dict(cur_win_size=3, hungarian=True)),
    "gat_heads": dict(seq=lambda: synthetic(3), cfg=dict(cur_win_size=5, hungarian=True),
                      nattheads=2),
    "temp_vis": dict(seq=lambda: with_temp_vis(*synthetic(4)),
                     cfg=dict(cur_win_size=5, hungarian=True), features="2d+temp+vis"),
    "msg_concat": dict(seq=lambda: synthetic(5), cfg=dict(cur_win_size=5, hungarian=True),
                       msg_type="concat"),
}
NUM_VIS = 16


def with_temp_vis(X, y):
    """X with the temp columns of each row's frame and NUM_VIS vis columns of
    seeded numbers in the normalised vis block's range [-1, 1]."""
    phase = np.mod(y[:, :1], 30) * np.pi / 30
    vis = np.random.default_rng(4).uniform(-1, 1, (len(y), NUM_VIS))
    return np.concatenate([X, np.sin(phase), np.cos(phase), vis], 1).astype(np.float32), y


@pytest.mark.parametrize("case", sorted(CASES))
def test_tracker_matches_jax(case):
    X, y = CASES[case]["seq"]()
    tcfg = CASES[case]["cfg"]
    kw = dict(nattheads=CASES[case].get("nattheads", 0),
              features=CASES[case].get("features", "2d"), num_vis_feats=NUM_VIS,
              msg_type=CASES[case].get("msg_type", "diff"))
    cfg_j, cfg_t = CFG_J._replace(**kw), CFG_T._replace(**kw)
    assert X.shape[1] == cfg_t.nfeatures
    p_np, s_np = spread_weights(cfg_t, seed=0, std=0.3)
    p, s = weights.from_jax_params(p_np, s_np, cfg_t)

    def record(steps):
        return lambda g, scores2: steps.append((g.ts.copy(), scores2.copy()))

    j_steps, t_steps = [], []
    y_j = JTracker(p_np, s_np, cfg_j, JTrackerConfig(bucket=64, **tcfg)).run(
        X, y, on_step=record(j_steps))
    y_t = Tracker(p, s, cfg_t, TrackerConfig(bucket=64, **tcfg), device="cpu").run(
        X, y, on_step=record(t_steps))

    assert len(t_steps) == len(j_steps) > 2
    for (ts_j, sc_j), (ts_t, sc_t) in zip(j_steps, t_steps):
        np.testing.assert_array_equal(ts_t, ts_j)
        np.testing.assert_allclose(sc_t, sc_j, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(y_t, y_j)
    assert (y_t[:, 1] >= 0).any()
    if case == "reinit_after_gap":
        # some step holds only second-burst frames: the graph re-initialized
        assert any(ts[ts != -1].min() >= 20 for ts, _ in t_steps if (ts != -1).any())
    else:
        # decisions were made: some edge scored positive and tracks span frames
        assert any(((ts == -1) & (sc[:, 1] >= 0.5)).any() for ts, sc in t_steps)
        track_len = np.bincount(y_t[y_t[:, 1] >= 0, 1])
        assert track_len.max() > 1

