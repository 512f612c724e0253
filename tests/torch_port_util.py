"""Shared inputs for the tests that hold trackmpnn_tpu_torch against the
JAX package: numpy-made weights in the JAX layout and real rolling-window
graphs from synthetic sequences."""

import numpy as np

from trackmpnn_tpu_torch.data.synthetic import make_sequence
from trackmpnn_tpu_torch.graph import engine
from trackmpnn_tpu_torch.models import weights


def spread_weights(cfg, seed, std=0.2):
    """JAX-layout (params, batch_stats) with numpy leaves: normal(std)
    weights, zero head biases and running stats away from (0, 1), so that
    scores spread around 0.5 and associations actually happen."""
    rng = np.random.default_rng(seed)

    def leaf(_, shape, path):
        a = (std * rng.normal(size=shape)).astype(np.float32)
        if path.startswith("out_") and path.endswith("/b"):
            a[:] = 0.0
        return a

    shapes = weights.param_shapes(cfg)
    params = weights.map_shaped(leaf, shapes, shapes)
    stat_shapes = weights.stats_shapes(cfg)
    stats = weights.map_shaped(
        lambda _, shape, path: (rng.uniform(0.5, 1.5, shape) if path.endswith("var")
                                else rng.normal(0, 0.3, shape)).astype(np.float32),
        stat_shapes, stat_shapes)
    return params, stats


def window_graph(num_tracks=6, num_frames=8, steps=3, seed=0):
    """A RollingGraph after `steps` test-mode updates with trivial scores
    (detections positive, edges negative, so nothing associates), plus the
    sequence's features and the number of rows the last update added."""
    X, bbox_pred, _ = make_sequence(num_tracks=num_tracks, num_frames=num_frames, seed=seed)
    y = bbox_pred[:, :2].astype(np.int64)
    g = engine.initialize(y, 0, "test")
    n_new = g.n
    for t in range(g.t_next, g.t_next + steps):
        p = np.where(g.ts != -1, 0.99, 0.01).astype(np.float32)
        n_new = engine.update(g, y, t, np.stack([1 - p, p], 1), "test", use_hungarian=True)
    return g, X, n_new


def training_chunks(n, seed0=0, num_tracks=4):
    """`n` synthetic training chunks (features, (ts, track_id) labels) of 5-7
    frames that seed a window, made with numpy so that both packages can
    build their schedules from the same arrays."""
    from trackmpnn_tpu_torch.graph.schedule import build_window_schedule

    out, s = [], seed0
    while len(out) < n:
        X, bp, _ = make_sequence(num_tracks=num_tracks, num_frames=5 + (s % 3), seed=s,
                                 miss_rate=0.15, fp_rate=0.2)
        y = bp[:, :2].astype(np.int64)
        if build_window_schedule(X, y) is not None:
            out.append((X, y))
        s += 1
    return out


def gat_inputs(seed, nh, keep=1.0, mask_heads=None, P=5, na=6, nt=7, H=8):
    """numpy f32 inputs and cotangents of both attention ops (ops/gat.py):
    "scores" (ha, hn, a, m3), "scores_cot" (for e, sa_l, sb_l), "agg" (e,
    m_row, m_col, z_row, z_col, h_e, m3, ka, kn), "agg_cot" (for rs, cs).
    Each block has a rectangular live part (block 0 none) and a live cell
    with ha_i == hn_j (d = 0); keep masks have `mask_heads` heads (default
    nh), or at keep 1 are the cell mask, as the train step passes them."""
    rng = np.random.default_rng(seed)
    blk_na, blk_nt = rng.integers(1, na + 1, P), rng.integers(1, nt + 1, P)
    blk_nt[0] = 0
    m = ((np.arange(na)[None, :, None] < blk_na[:, None, None])
         & (np.arange(nt)[None, None, :] < blk_nt[:, None, None]))
    ha, hn = rng.normal(size=(P, na, nh * H)), rng.normal(size=(P, nt, nh * H))
    hn[:, 0] = ha[:, 0]
    e = rng.normal(size=(nh, P, na, nt)) * m
    keep_mask = lambda: (rng.random((mask_heads or nh, P, na, nt)) < keep if keep < 1.0
                         else m[None])
    arrays = {
        "scores": [ha, hn, rng.normal(size=(nh * H, 1)) * 0.3, m],
        "scores_cot": [rng.normal(size=(nh, P, na, nt)), rng.normal(size=(nh, P, na)),
                       rng.normal(size=(nh, P, nt))],
        "agg": [e, e.max(3) + rng.uniform(0, 1, (nh, P, na)),
                e.max(2) + rng.uniform(0, 1, (nh, P, nt)), rng.uniform(1, 3, (nh, P, na)),
                rng.uniform(1, 3, (nh, P, nt)), rng.normal(size=(P, na, nt, H)) * m[..., None],
                m, keep_mask(), keep_mask()],
        "agg_cot": [rng.normal(size=(P, na, H)), rng.normal(size=(P, nt, H))],
    }
    return {k: [np.ascontiguousarray(a, np.float32) for a in v] for k, v in arrays.items()}


ROUND_KEYS = ("w_ih", "w_hh", "b_ih", "b_hh")


def round_inputs(seed, B=2, cap=64, H=64):
    """numpy inputs of the fused round (ops/round.py) as
    tests/test_pallas_round.py makes them: h f32[B, cap, H], idxw
    int32[B, cap, 4] with rows of kind 0 dead (h = 0), 1 edge, 2 detection
    and endpoints anywhere in the window, the two GRUs' weight dicts, and a
    cotangent of out."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, cap, H)).astype(np.float32) * 0.5
    past = rng.integers(0, cap, (B, cap)).astype(np.int32)
    fut = rng.integers(0, cap, (B, cap)).astype(np.int32)
    kind = rng.integers(0, 3, (B, cap))
    h[kind == 0] = 0.0
    idxw = np.stack([past, fut, (kind == 1).astype(np.int32), (kind == 2).astype(np.int32)], -1)
    shapes = [(H, 3 * H), (H, 3 * H), (3 * H,), (3 * H,)]
    we, wn = ({k: (0.2 * rng.normal(size=s)).astype(np.float32) for k, s in zip(ROUND_KEYS, shapes)}
              for _ in range(2))
    cot = rng.normal(size=h.shape).astype(np.float32)
    return h, idxw, we, wn, cot
