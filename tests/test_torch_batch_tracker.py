"""The port's BatchedTracker on the CPU against the port's own Tracker and
the JAX package's BatchedTracker, with the same converted weights (numpy
made, with spread, so that associations happen): decoded tracks identical,
per-step scores within atol 1e-4 of the Tracker's (f32 sums over other
padded widths).  Its forward is one graph for the whole cohort: one
mpnn.forward per global step, whatever the number of sequences."""

import numpy as np
import pytest
import torch

from torch_port_util import spread_weights
from trackmpnn_tpu.decode import TrackerConfig as JTrackerConfig
from trackmpnn_tpu.decode.batch_tracker import BatchedTracker as JBatchedTracker
from trackmpnn_tpu.models import mpnn as jmpnn
from trackmpnn_tpu_torch.data.synthetic import make_sequence
from trackmpnn_tpu_torch.decode import BatchedTracker, Tracker, TrackerConfig
from trackmpnn_tpu_torch.models import mpnn, weights

torch.set_num_threads(1)


def sequences(features):
    seqs = []
    for seed, frames in [(31, 8), (32, 6), (33, 10), (34, 7)]:
        X, bp, _ = make_sequence(num_tracks=5, num_frames=frames, seed=seed)
        if "temp" in features:
            ph = np.mod(bp[:, :1], 30) * np.pi / 30
            X = np.concatenate([X, np.sin(ph), np.cos(ph)], 1).astype(np.float32)
        seqs.append((X, bp[:, :2].astype(np.int64)))
    seqs.append((np.zeros((0, seqs[0][0].shape[1]), np.float32), np.zeros((0, 2), np.int64)))
    return seqs


@pytest.mark.parametrize("features,heads,pipeline,tcfg", [
    ("2d", 0, True, dict(cur_win_size=4, ret_win_size=2, hungarian=True)),
    ("2d+temp", 0, False, dict(cur_win_size=4, hungarian=False, prune_threshold=0.4,
                               tp_classifier=False)),
    ("2d", 2, True, dict(cur_win_size=5, hungarian=True))])
def test_batched_matches_tracker_and_jax(features, heads, pipeline, tcfg):
    cfg = mpnn.ModelConfig(features=features, nhidden=16, nattheads=heads)
    jcfg = jmpnn.ModelConfig(features=features, nhidden=16, nattheads=heads)
    p_np, s_np = spread_weights(cfg, seed=5)
    params, stats = weights.from_jax_params(p_np, s_np, cfg)
    seqs = sequences(features)

    want_scores = {}
    single = Tracker(params, stats, cfg, TrackerConfig(bucket=128, **tcfg), device="cpu")
    want = []
    for i, (X, y) in enumerate(seqs):
        want.append(single.run(X, y, on_step=lambda g, sc, _i=i: want_scores.setdefault(
            _i, []).append(sc.copy())))

    got_scores = {}
    tracker = BatchedTracker(params, stats, cfg, TrackerConfig(bucket=128, **tcfg), device="cpu")
    got = tracker.run(seqs, pipeline=pipeline,
                      on_step=lambda i, g, sc: got_scores.setdefault(i, []).append(sc.copy()))
    jgot = JBatchedTracker(p_np, s_np, jcfg, JTrackerConfig(bucket=128, **tcfg)).run(
        seqs, pipeline=pipeline)

    assert sum((w[:, 1] >= 0).sum() for w in want) >= 10  # tracks were decoded
    for k, (a, b, c) in enumerate(zip(got, want, jgot)):
        np.testing.assert_array_equal(a, b, err_msg=f"sequence {k} vs Tracker")
        np.testing.assert_array_equal(a, c, err_msg=f"sequence {k} vs JAX")
    assert sorted(got_scores) == sorted(want_scores)
    for i in want_scores:
        assert len(got_scores[i]) == len(want_scores[i])
        for x, y in zip(got_scores[i], want_scores[i]):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-4)
    longest = max(len(v) for v in want_scores.values())
    # one forward a global step for the whole cohort (two cohorts pipelined)
    assert tracker.n_forwards <= (2 if pipeline else 1) * longest


def test_one_forward_serves_every_lane(monkeypatch):
    """In lockstep each global step calls mpnn.forward once, on one graph
    holding every active lane: as many forwards as the longest sequence's
    Tracker run has, the first over 3 lanes of the bucketed capacity."""
    cfg = mpnn.ModelConfig(features="2d", nhidden=8)
    params, stats = weights.from_jax_params(*spread_weights(cfg, seed=1), cfg)
    seqs = sequences("2d")[:3]
    tcfg = TrackerConfig(cur_win_size=4, bucket=64)
    steps = []
    for X, y in seqs:
        n = []
        Tracker(params, stats, cfg, tcfg, device="cpu").run(
            X, y, on_step=lambda g, sc: n.append(g.n))
        steps.append(n)
    calls = []
    real = mpnn.forward

    def spy(params, stats, cfg, g, h, **kw):
        calls.append(g.capacity)
        return real(params, stats, cfg, g, h, **kw)

    monkeypatch.setattr(mpnn, "forward", spy)
    tracker = BatchedTracker(params, stats, cfg, tcfg, device="cpu")
    tracker.run(seqs, pipeline=False)
    assert len(calls) == tracker.n_forwards == max(len(n) for n in steps)
    cap = 64
    while cap < max(n[0] for n in steps):
        cap *= 2
    assert calls[0] == 3 * cap
