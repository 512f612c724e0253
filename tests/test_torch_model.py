"""The port's model (trackmpnn_tpu_torch/models) against the JAX package's,
with weights carried over by models/weights.py and the same numpy inputs
on both sides.  Tolerance: atol 1e-5 in f32 (the two sides sum matmuls
and reductions in different orders; outputs are O(1))."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import spread_weights, window_graph
from trackmpnn_tpu.graph import view as jview
from trackmpnn_tpu.models import mpnn as jmpnn
from trackmpnn_tpu.models import nn as jnn
from trackmpnn_tpu_torch.graph import view as tview
from trackmpnn_tpu_torch.models import mpnn as tmpnn
from trackmpnn_tpu_torch.models import nn as tnn
from trackmpnn_tpu_torch.models import weights

torch.set_num_threads(1)

ATOL = 1e-5
NUM_VIS = 16
CFG_J = jmpnn.ModelConfig(features="2d", ncategories=3, nhidden=16, msg_type="diff")
CFG_T = tmpnn.ModelConfig(features="2d", ncategories=3, nhidden=16, msg_type="diff")


def jax_init_weights():
    params = jax.tree_util.tree_map(np.asarray, jmpnn.init_params(jax.random.key(5), CFG_J))
    stats = jax.tree_util.tree_map(np.asarray, jmpnn.init_batch_stats(CFG_J))
    return params, stats


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=ATOL)


def test_weights_round_trip_and_layout():
    p_np, s_np = jax_init_weights()
    p, s = weights.from_jax_params(p_np, s_np, CFG_T)
    # the JAX layout is kept: GRU weights are [in, 3H], linear weights [in, out]
    assert tuple(p["branches"][0]["edge_gru"]["w_ih"].shape) == (16, 48)
    assert tuple(p["branches"][0]["input"]["lin1"]["w"].shape) == (8, 16)
    assert float(p["out_node"]["b"][0]) == pytest.approx(tmpnn.HEAD_BIAS)
    assert float(p["out_edge"]["b"][0]) == pytest.approx(-tmpnn.HEAD_BIAS)
    back_p, back_s = weights.to_jax_params(p, s, CFG_T)
    for a, b in zip(jax.tree_util.tree_leaves((back_p, back_s)),
                    jax.tree_util.tree_leaves((p_np, s_np))):
        np.testing.assert_array_equal(a, b)
    assert jax.tree_util.tree_structure((back_p, back_s)) == jax.tree_util.tree_structure((p_np, s_np))


def test_weights_reject_wrong_shape():
    p_np, s_np = jax_init_weights()
    p_np["branches"][0]["node_gru"]["w_hh"] = p_np["branches"][0]["node_gru"]["w_hh"].T
    with pytest.raises(ValueError, match="node_gru/w_hh"):
        weights.from_jax_params(p_np, s_np, CFG_T)


def test_init_params_shapes_match_jax():
    p = tmpnn.init_params(torch.Generator().manual_seed(0), CFG_T)
    p_np, _ = jax_init_weights()
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda t: 0, p)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: 0, p_np))
    for a, b in zip(jax.tree_util.tree_leaves(p), jax.tree_util.tree_leaves(p_np)):
        assert tuple(a.shape) == b.shape


@pytest.mark.parametrize("train", [True, False])
def test_masked_batchnorm(train):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(40, 16)).astype(np.float32)
    mask = rng.random(40) > 0.3
    params = {"gamma": rng.normal(size=16).astype(np.float32),
              "beta": rng.normal(size=16).astype(np.float32)}
    stats = {"mean": rng.normal(size=16).astype(np.float32),
             "var": rng.uniform(0.5, 2, 16).astype(np.float32)}
    want_y, want_s = jnn.masked_batchnorm(params, stats, jnp.asarray(x), jnp.asarray(mask), train=train)
    to_t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    got_y, got_s = tnn.masked_batchnorm(to_t(params), to_t(stats), torch.from_numpy(x),
                                        torch.from_numpy(mask), train=train)
    close(got_y, want_y)
    for k in ("mean", "var"):
        close(got_s[k], want_s[k])


def test_gru_cell_matches_jax_and_torch_grucell():
    rng = np.random.default_rng(2)
    H = 16
    p = {"w_ih": rng.normal(0, 0.3, (H, 3 * H)), "w_hh": rng.normal(0, 0.3, (H, 3 * H)),
         "b_ih": rng.normal(0, 0.3, 3 * H), "b_hh": rng.normal(0, 0.3, 3 * H)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(10, H)).astype(np.float32)
    h = rng.normal(size=(10, H)).astype(np.float32)
    got = tnn.gru_cell({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), torch.from_numpy(h))
    close(got, jnn.gru_cell(p, jnp.asarray(x), jnp.asarray(h)))
    # the [in, 3H] layout is the transpose of torch.nn.GRUCell's weights
    cell = torch.nn.GRUCell(H, H)
    with torch.no_grad():
        cell.weight_ih.copy_(torch.from_numpy(p["w_ih"].T))
        cell.weight_hh.copy_(torch.from_numpy(p["w_hh"].T))
        cell.bias_ih.copy_(torch.from_numpy(p["b_ih"]))
        cell.bias_hh.copy_(torch.from_numpy(p["b_hh"]))
        close(got, cell(torch.from_numpy(x), torch.from_numpy(h)))


@pytest.mark.parametrize("train", [True, False])
def test_input_transform(train):
    p_np, s_np = spread_weights(CFG_T, seed=3)
    p, s = weights.from_jax_params(p_np, s_np, CFG_T)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(30, 8)).astype(np.float32)
    mask = rng.random(30) > 0.4
    want, want_s = jnn.input_transform(p_np["branches"][0]["input"], s_np["branches"][0]["bn"],
                                       jnp.asarray(x), jnp.asarray(mask), train=train)
    got, got_s = tnn.input_transform(p["branches"][0]["input"], s["branches"][0]["bn"],
                                     torch.from_numpy(x), torch.from_numpy(mask), train=train)
    close(got, want)
    for k in ("mean", "var"):
        close(got_s[k], want_s[k])


def views(g, X, n_new, cap):
    """The same window through both packages' pack_slots."""
    jd, jp, jf, jx = jview.pack_slots(g, X, cap)
    td, tp, tf, tx = tview.pack_slots(g, X, cap)
    for a, b in ((jd, td), (jp, tp), (jf, tf), (jx, tx)):
        np.testing.assert_array_equal(a, b)
    assert tp.dtype == np.int32 and tf.dtype == np.int32
    idx = np.arange(cap)
    live = idx < g.n
    new = (idx >= g.n - n_new) & live
    jv = jview.GraphView(is_det=jnp.asarray(jd), past=jnp.asarray(jp), fut=jnp.asarray(jf),
                         live=jnp.asarray(live), new=jnp.asarray(new), feat=jnp.asarray(jx))
    tv = tview.make_view(g, X, n_new, cap, "cpu")
    np.testing.assert_array_equal(tv.new.numpy(), new)
    np.testing.assert_array_equal(tv.live.numpy(), live)
    return jv, tv


FEATURE_CASES = [
    pytest.param("2d", "jax_init", False, False, id="jax_init-False-False"),
    pytest.param("2d", "spread", False, True, id="spread-False-True"),
    pytest.param("2d", "spread", True, True, id="spread-True-True"),
] + [pytest.param(f, "spread", train, True, id=f"{f}-{'train' if train else 'eval'}")
     for f in ("2d+temp", "2d+vis", "vis", "2d+temp+vis") for train in (False, True)]


def branch_inputs(X, features, rows, seed):
    """The window's 2d columns and, per other branch, numpy-seeded columns of
    its width (temp: [sin, cos] of a frame phase; vis: 16 standardised
    softmax-like values), in the concatenation order of the branches."""
    rng = np.random.default_rng(seed)
    cols = []
    for name, width in tmpnn.branch_widths(features, 3, NUM_VIS):
        if name == "2d":
            cols.append(X)
        elif name == "temp":
            phase = rng.integers(0, 30, (rows, 1)) * np.pi / 30
            cols.append(np.concatenate([np.sin(phase), np.cos(phase)], 1))
        else:
            cols.append(rng.normal(0, 0.5, (rows, width)))
    return np.concatenate(cols, 1).astype(np.float32)


@pytest.mark.parametrize("features,weights_kind,train,with_hidden", FEATURE_CASES)
def test_forward_matches_jax(features, weights_kind, train, with_hidden):
    """One forward of both packages on the same window, weights and h_prev:
    hidden, logits, scores and every branch's BN stats.  The '2d' cases
    also take JAX's own init; the others run 2 or 3 feature branches
    (vis with num_vis_feats 16)."""
    g, X, n_new = window_graph(num_tracks=6, num_frames=8, steps=3, seed=4)
    cap = 512
    assert g.n <= cap and np.any(g.ts == -1)
    X = branch_inputs(X, features, X.shape[0], seed=4)
    cfg_j = CFG_J._replace(features=features, num_vis_feats=NUM_VIS)
    cfg_t = CFG_T._replace(features=features, num_vis_feats=NUM_VIS)
    jv, tv = views(g, X, n_new, cap)
    p_np, s_np = jax_init_weights() if weights_kind == "jax_init" else spread_weights(cfg_t, 4)
    p, s = weights.from_jax_params(p_np, s_np, cfg_t)
    nb = len(cfg_t.branches)
    h_prev = (np.random.default_rng(4).normal(size=(cap, nb * 16)).astype(np.float32)
              if with_hidden else None)
    want, want_s = jmpnn.forward(p_np, s_np, cfg_j, jv,
                                 None if h_prev is None else jnp.asarray(h_prev), train=train)
    got, got_s = tmpnn.forward(p, s, cfg_t, tv,
                               None if h_prev is None else torch.from_numpy(h_prev), train=train)
    close(got.hidden, want.hidden)
    close(got.logits, want.logits)
    close(got.scores, want.scores)
    assert len(got_s["branches"]) == nb
    for b in range(nb):
        for k in ("mean", "var"):
            close(got_s["branches"][b]["bn"][k], want_s["branches"][b]["bn"][k])
    # spread weights put scores on both sides of 0.5, so decisions are tested
    if weights_kind == "spread":
        live = got.scores[: g.n].numpy()
        assert (live > 0.5).any() and (live < 0.5).any()


# ------------------------------------------------------------- msg concat ----
CONCAT_J = CFG_J._replace(msg_type="concat")
CONCAT_T = CFG_T._replace(msg_type="concat")


def test_concat_weights_round_trip():
    """With msg 'concat' the edge GRU's w_ih is [2H, 3H] in init_params, as
    JAX's (mpnn.py:86-90), and crosses both ways unchanged; a [H, 3H] one is
    refused by name."""
    p_np = jax.tree_util.tree_map(np.asarray, jmpnn.init_params(jax.random.key(7), CONCAT_J))
    s_np = jax.tree_util.tree_map(np.asarray, jmpnn.init_batch_stats(CONCAT_J))
    p = tmpnn.init_params(torch.Generator().manual_seed(0), CONCAT_T)
    for a, b in zip(jax.tree_util.tree_leaves(p), jax.tree_util.tree_leaves(p_np)):
        assert tuple(a.shape) == b.shape
    assert tuple(p["branches"][0]["edge_gru"]["w_ih"].shape) == (32, 48)
    tp, ts = weights.from_jax_params(p_np, s_np, CONCAT_T)
    back_p, back_s = weights.to_jax_params(tp, ts, CONCAT_T)
    for a, b in zip(jax.tree_util.tree_leaves((back_p, back_s)),
                    jax.tree_util.tree_leaves((p_np, s_np))):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="edge_gru/w_ih"):
        weights.from_jax_params(p_np, s_np, CFG_T)


@pytest.mark.parametrize("heads", [0, 2])
@pytest.mark.parametrize("train", [False, True])
def test_concat_forward_matches_jax(monkeypatch, train, heads):
    """msg 'concat' forward against JAX's, in eval and train mode, with 0
    and 2 heads (dropout 0 on both sides, as test_gat_forward_matches_jax):
    hidden, logits, scores and BN stats within ATOL."""
    monkeypatch.setattr(jmpnn, "ATT_DROPOUT", 0.0)
    monkeypatch.setattr(tmpnn, "ATT_DROPOUT", 0.0)
    cfg_j, cfg_t = CONCAT_J._replace(nattheads=heads), CONCAT_T._replace(nattheads=heads)
    g, X, n_new = window_graph(num_tracks=6, num_frames=8, steps=3, seed=8)
    cap = 512
    jv, tv = views(g, X, n_new, cap)
    p_np, s_np = spread_weights(cfg_t, 9)
    p, s = weights.from_jax_params(p_np, s_np, cfg_t)
    h_prev = np.random.default_rng(8).normal(size=(cap, 16)).astype(np.float32)
    want, want_s = jmpnn.forward(p_np, s_np, cfg_j, jv, jnp.asarray(h_prev), train=train,
                                 rng=jax.random.key(1))
    got, got_s = tmpnn.forward(p, s, cfg_t, tv, torch.from_numpy(h_prev), train=train)
    close(got.hidden, want.hidden)
    close(got.logits, want.logits)
    close(got.scores, want.scores)
    for k in ("mean", "var"):
        close(got_s["branches"][0]["bn"][k], want_s["branches"][0]["bn"][k])
    live = got.scores[: g.n].numpy()
    assert (live > 0.5).any() and (live < 0.5).any()


def test_unknown_msg_type_is_refused():
    with pytest.raises(ValueError, match="msg_type"):
        tmpnn.init_params(torch.Generator().manual_seed(0), CFG_T._replace(msg_type="sum"))


# ------------------------------------------------------------ attention heads ----
GAT_J = CFG_J._replace(nattheads=2)
GAT_T = CFG_T._replace(nattheads=2)


def test_gat_init_shapes_and_weights_round_trip():
    """init_params with heads has JAX's tree and shapes (W_att [H, H], a
    [H, 1] per head); the gat leaves cross both ways unchanged."""
    p_np = jax.tree_util.tree_map(np.asarray, jmpnn.init_params(jax.random.key(6), GAT_J))
    s_np = jax.tree_util.tree_map(np.asarray, jmpnn.init_batch_stats(GAT_J))
    p = tmpnn.init_params(torch.Generator().manual_seed(0), GAT_T)
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda t: 0, p)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: 0, p_np))
    for a, b in zip(jax.tree_util.tree_leaves(p), jax.tree_util.tree_leaves(p_np)):
        assert tuple(a.shape) == b.shape
    bound = 1.414 * (6.0 / 32) ** 0.5  # xavier-uniform of [16, 16]
    w = p["branches"][0]["gat"][1]["W_att"]
    assert float(w.abs().max()) <= bound and float(w.std()) > 0.3 * bound
    tp, ts = weights.from_jax_params(p_np, s_np, GAT_T)
    assert tuple(tp["branches"][0]["gat"][0]["a"].shape) == (16, 1)
    back_p, back_s = weights.to_jax_params(tp, ts, GAT_T)
    for a, b in zip(jax.tree_util.tree_leaves((back_p, back_s)),
                    jax.tree_util.tree_leaves((p_np, s_np))):
        np.testing.assert_array_equal(a, b)
    del p_np["branches"][0]["gat"][1]
    with pytest.raises(ValueError, match="gat"):
        weights.from_jax_params(p_np, s_np, GAT_T)


@pytest.mark.parametrize("train", [False, True])
def test_gat_forward_matches_jax(monkeypatch, train):
    """The forward with two heads against JAX's, in eval mode and in train
    mode with the attention dropout set to 0 on both sides (the two draw
    their keep masks from different streams)."""
    monkeypatch.setattr(jmpnn, "ATT_DROPOUT", 0.0)
    monkeypatch.setattr(tmpnn, "ATT_DROPOUT", 0.0)
    g, X, n_new = window_graph(num_tracks=6, num_frames=8, steps=3, seed=5)
    cap = 512
    jv, tv = views(g, X, n_new, cap)
    p_np, s_np = spread_weights(GAT_T, 7)
    p, s = weights.from_jax_params(p_np, s_np, GAT_T)
    h_prev = np.random.default_rng(5).normal(size=(cap, 16)).astype(np.float32)
    want, want_s = jmpnn.forward(p_np, s_np, GAT_J, jv, jnp.asarray(h_prev), train=train,
                                 rng=jax.random.key(1))
    got, got_s = tmpnn.forward(p, s, GAT_T, tv, torch.from_numpy(h_prev), train=train)
    close(got.hidden, want.hidden)
    close(got.logits, want.logits)
    close(got.scores, want.scores)
    for k in ("mean", "var"):
        close(got_s["branches"][0]["bn"][k], want_s["branches"][0]["bn"][k])
    live = got.scores[: g.n].numpy()
    assert (live > 0.5).any() and (live < 0.5).any()


def test_gat_dropout_needs_a_generator_and_follows_it():
    """Train-time attention dropout draws from the generator it is given:
    the same seed gives the same forward, another seed another."""
    g, X, n_new = window_graph(seed=6)
    tv = tview.make_view(g, X, n_new, 512, "cpu")
    p, s = weights.from_jax_params(*spread_weights(GAT_T, 8), GAT_T)
    h_prev = torch.from_numpy(np.random.default_rng(6).normal(size=(512, 16)).astype(np.float32))
    with pytest.raises(ValueError, match="generator"):
        tmpnn.forward(p, s, GAT_T, tv, h_prev, train=True)
    outs = [tmpnn.forward(p, s, GAT_T, tv, h_prev, train=True,
                          generator=torch.Generator().manual_seed(k))[0].hidden
            for k in (0, 0, 1)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
