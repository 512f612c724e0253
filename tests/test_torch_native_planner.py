"""The port's native graph planner (trackmpnn_tpu_torch/graph/native.py,
csrc/graph_planner.cpp) against the port's numpy engine and the JAX
engine's numpy functions, exactly.

Random rolling-graph states are evolved with the port's engine on its numpy
paths; every association mode and the decode plan at two retain windows
must then agree exactly between the planner, the port's numpy functions and
the JAX package's numpy functions (trackmpnn_tpu/graph/engine.py) on copies
of the same graph.  Hungarian ties may be broken to another optimum of
equal cost, as tests/test_native_planner.py allows.  A Tracker gives
identical tracks with and without TM_NATIVE=0, and a failed build raises
with the compiler's command and output instead of falling back.
"""

import copy

import numpy as np
import pytest
import torch

from torch_port_util import spread_weights
from trackmpnn_tpu.graph import engine as jengine
from trackmpnn_tpu_torch.data.synthetic import make_sequence
from trackmpnn_tpu_torch.decode import Tracker, TrackerConfig
from trackmpnn_tpu_torch.graph import engine, native
from trackmpnn_tpu_torch.models import mpnn, weights

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _numpy_engine(monkeypatch):
    """Evolve the graphs on the numpy paths; each test calls the planner
    itself."""
    monkeypatch.setenv("TM_NATIVE", "0")


def random_world(rng, frames=6, tracks=5, fp_rate=0.2):
    rows = []
    for fr in range(frames):
        for k in range(tracks):
            if rng.random() < 0.8:
                rows.append([fr, k])
        for _ in range(rng.poisson(fp_rate * tracks)):
            rows.append([fr, -1])
    return np.array(rows, np.int64) if rows else np.zeros((0, 2), np.int64)


def scores_for(rng, n):
    s = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    s[:, 0] = 1 - s[:, 1]
    return s


def evolve(y, rng, use_hungarian, steps=3):
    """init + a few test-mode updates with random scores; the graph and a
    last set of random scores."""
    g = engine.initialize(y, 0, "test")
    if g is None:
        return None, None
    for t in range(g.t_next, min(g.t_next + steps, g.t_end)):
        engine.update(g, y, t, scores_for(rng, g.n), mode="test", use_hungarian=use_hungarian)
    return g, scores_for(rng, g.n)


def as_jax(g):
    """A copy of the port's graph as the JAX engine's RollingGraph."""
    return jengine.RollingGraph(ts=g.ts.copy(), det_id=g.det_id.copy(), ass_id=g.ass_id.copy(),
                                past=g.past.copy(), fut=g.fut.copy(), label=g.label.copy(),
                                t_next=g.t_next, t_end=g.t_end)


def three(g):
    return copy.deepcopy(g), copy.deepcopy(g), as_jax(g)


@pytest.mark.parametrize("seed", range(8))
def test_associate_greedy_equivalence(seed):
    rng = np.random.default_rng(seed)
    g, s = evolve(random_world(rng), rng, use_hungarian=False)
    assert g is not None
    gn, gp, gj = three(g)
    native.associate_greedy(gn, s)
    engine.associate_greedy(gp, s)
    jengine.associate_greedy(gj, s)
    np.testing.assert_array_equal(gn.ass_id, gp.ass_id)
    np.testing.assert_array_equal(gn.ass_id, gj.ass_id)


def frame_cost(g, s):
    """(summed cost, count) of a Hungarian association's matched edges."""
    total, cnt = 0.0, 0
    for i in np.where(g.ass_id != -1)[0]:
        if g.ts[i] == -1:
            continue
        e = np.where((g.ts == -1) & (g.past == i)
                     & (g.det_id[np.clip(g.fut, 0, g.n - 1)] == g.ass_id[i]))[0]
        if e.size:
            total += float(s[e[0], 0])
            cnt += 1
    return round(total, 4), cnt


@pytest.mark.parametrize("seed", range(8))
def test_associate_hungarian_equivalence(seed):
    rng = np.random.default_rng(100 + seed)
    g, s = evolve(random_world(rng), rng, use_hungarian=True)
    assert g is not None
    gn, gp, gj = three(g)
    native.associate_hungarian(gn, s)
    engine.associate_hungarian(gp, s)
    jengine.associate_hungarian(gj, s)
    np.testing.assert_array_equal(gp.ass_id, gj.ass_id)
    if not np.array_equal(gn.ass_id, gp.ass_id):
        # scipy and the built-in solver may pick different optima on ties
        assert frame_cost(gn, s) == frame_cost(gp, s)


@pytest.mark.parametrize("seed", range(8))
def test_associate_teacher_equivalence(seed):
    rng = np.random.default_rng(200 + seed)
    y = random_world(rng)
    g = engine.initialize(y, 0, "train")
    assert g is not None
    for t in range(g.t_next, min(g.t_next + 2, g.t_end)):
        engine.update(g, y, t, None, mode="train")
    gn, gp, gj = three(g)
    native.associate_teacher_forced(gn)
    engine.associate_teacher_forced(gp)
    jengine.associate_teacher_forced(gj)
    np.testing.assert_array_equal(gn.ass_id, gp.ass_id)
    np.testing.assert_array_equal(gn.ass_id, gj.ass_id)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("ret_win", [0, 3])
def test_decode_plan_equivalence(seed, ret_win):
    rng = np.random.default_rng(300 + seed)
    y = random_world(rng)
    g, s = evolve(y, rng, use_hungarian=False)
    assert g is not None
    engine.associate_greedy(g, s)
    gn, gp, gj = three(g)
    y0 = y.copy()
    y0[:, 1] = -1
    outs = [y0.copy() for _ in range(3)]
    t_upto = int(g.t_next) - 2
    keeps = [native.decode_plan(gn, s, outs[0], t_upto, ret_win),
             engine._decode_plan_py(gp, s, outs[1], t_upto, ret_win),
             jengine._decode_plan_py(gj, s, outs[2], t_upto, ret_win)]
    for k, o in zip(keeps[1:], outs[1:]):
        np.testing.assert_array_equal(keeps[0], k)
        np.testing.assert_array_equal(outs[0], o)


@pytest.mark.parametrize("hungarian", [True, False])
def test_tracker_tracks_identical_with_and_without_the_planner(monkeypatch, hungarian):
    """A whole sequence served by the Tracker, which reaches the planner
    through engine.associate and engine.decode_tracks: identical tracks."""
    cfg = mpnn.ModelConfig(features="2d", ncategories=3, nhidden=16)
    params, stats = weights.from_jax_params(*spread_weights(cfg, 0), cfg)
    X, bbox, _ = make_sequence(num_tracks=6, num_frames=10, seed=11)
    y = bbox[:, :2].astype(np.int64)
    outs, calls = [], []
    real = native.decode_plan
    monkeypatch.setattr(native, "decode_plan", lambda *a: calls.append(1) or real(*a))
    for flag in ("1", "0"):
        monkeypatch.setenv("TM_NATIVE", flag)
        tracker = Tracker(params, stats, cfg, TrackerConfig(cur_win_size=4, hungarian=hungarian),
                          device="cpu")
        outs.append(tracker.run(X, y))
        if flag == "1":
            assert calls, "the engine did not reach the planner"
            n_native = len(calls)
    assert len(calls) == n_native  # TM_NATIVE=0 never reaches it
    assert (outs[0][:, 1] >= 0).any()
    np.testing.assert_array_equal(outs[0], outs[1])


def test_a_failed_build_raises_with_the_compiler_message(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("TM_NATIVE", "1")
    monkeypatch.setenv("CXX", "/bin/false")
    with pytest.raises(RuntimeError, match="graph planner's build failed .*/bin/false"):
        native.load()
    g = engine.initialize(np.array([[0, 0], [1, 0]], np.int64), 0, "test")
    with pytest.raises(RuntimeError, match="/bin/false"):
        engine.associate(g, np.full((g.n, 2), 0.5, np.float32), "test", True)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="could not run"):
        native.load()
    assert not (tmp_path / "build" / "libtm_planner.so").exists()
