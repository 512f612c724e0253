"""The port's block train step (trackmpnn_tpu_torch/train/block.py and
train/optim.py) against the JAX package's, on the same chunks and weights.

Loss, loss_ce and loss_f within rtol 1e-4; tp/fp/fn equal; gradients and
BN running stats within rtol 1e-3, atol 3e-5, the tolerances
tests/test_block_step.py holds the JAX block step to.  The JAX side runs
block_window_forward with defer_loss=True and its plain round (the fused
Pallas round is held to that by the JAX package's own tests); the port runs
its one composition, on the CPU through the plain versions of its kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_util import spread_weights, training_chunks
from trackmpnn_tpu.graph import schedule as jschedule
from trackmpnn_tpu.models import mpnn as jmpnn
from trackmpnn_tpu.train import block as jblock
from trackmpnn_tpu.train import optim as joptim
from trackmpnn_tpu_torch.graph import schedule
from trackmpnn_tpu_torch.models import mpnn, weights
from trackmpnn_tpu_torch.train import block, optim

torch.set_num_threads(1)

CAP, TCAP, HIDDEN = 256, 10, 16


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    """XLA:CPU's LLVM backend segfaults order-dependently when enough
    distinct block-step programs accumulate in one process (see
    tests/test_block_step.py); drop the executable cache between tests."""
    yield
    jax.clear_caches()


def batches(n=3, seed0=0):
    """The same ragged batch (windows of 5-7 frames) for both packages."""
    chunks = training_chunks(n, seed0)
    j = [jschedule.build_window_schedule(X, y, cap=CAP, t_cap=TCAP) for X, y in chunks]
    t = [schedule.build_window_schedule(X, y, cap=CAP, t_cap=TCAP) for X, y in chunks]
    assert len({s.n_steps for s in t}) > 1  # ragged: some steps invalid in some windows
    return jblock.build_block_batch(j, TCAP), block.build_block_batch(t, TCAP, device="cpu")


def configs():
    return (jmpnn.ModelConfig(features="2d", ncategories=3, nhidden=HIDDEN),
            mpnn.ModelConfig(features="2d", ncategories=3, nhidden=HIDDEN))


def leaves_np(tree, cfg, shapes=weights.param_shapes):
    flat = []
    weights.map_shaped(lambda leaf, s, path: flat.append((path, np.asarray(leaf))),
                       tree, shapes(cfg))
    return flat


@pytest.mark.parametrize("tp_classifier", [True, False])
def test_block_step_matches_jax(tp_classifier):
    jcfg, cfg = configs()
    jbb, tbb = batches()
    p_np, s_np = spread_weights(cfg, 0)

    def f(p):
        return jblock.block_window_forward(p, s_np, jcfg, jbb, tp_classifier, defer_loss=True)

    (jl, jaux), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, p_np))
    params, stats = weights.from_jax_params(p_np, s_np, cfg)
    params = block.trainable(params)
    tl, taux = block.block_window_forward(params, stats, cfg, tbb, tp_classifier)
    tl.backward()

    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    for k in ("loss_ce", "loss_f"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-4, atol=1e-6)
    for k in ("tp", "fp", "fn"):
        assert int(taux[k]) == int(jaux[k]), k
    grads = weights.map_shaped(lambda leaf, s, path: leaf.grad, params, weights.param_shapes(cfg))
    for (path, a), (_, b) in zip(leaves_np(grads, cfg), leaves_np(jg, cfg)):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=3e-5, err_msg=path)
    got_stats = weights.map_shaped(lambda leaf, s, path: leaf, taux["batch_stats"],
                                   weights.stats_shapes(cfg))
    for (path, a), (_, b) in zip(leaves_np(got_stats, cfg, weights.stats_shapes),
                                 leaves_np(jaux["batch_stats"], cfg, weights.stats_shapes)):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=3e-5, err_msg=path)


def test_block_step_eval_mode_matches_jax():
    jcfg, cfg = configs()
    jbb, tbb = batches(seed0=40)
    p_np, s_np = spread_weights(cfg, 1)
    jl, jaux = jax.jit(lambda p: jblock.block_window_forward(p, s_np, jcfg, jbb, True,
                                                             train=False, defer_loss=True))(p_np)
    params, stats = weights.from_jax_params(p_np, s_np, cfg)
    with torch.no_grad():
        tl, taux = block.block_window_forward(params, stats, cfg, tbb, True, train=False)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    for k in ("tp", "fp", "fn"):
        assert int(taux[k]) == int(jaux[k]), k
    assert taux["batch_stats"]["branches"][0]["bn"] is stats["branches"][0]["bn"]


def test_optimizer_matches_optax_on_identical_grads():
    """Adam with L2 added to the gradient, three steps on the same grads,
    then the epoch schedule: the port's params == optax's within 1e-7."""
    _, cfg = configs()
    p_np, _ = spread_weights(cfg, 2)
    rng = np.random.default_rng(3)
    grads = [jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32), p_np)
             for _ in range(3)]
    tx = joptim.make_optimizer(1e-3, 5e-4)
    jp = jax.tree_util.tree_map(jnp.asarray, p_np)
    state = tx.init(jp)
    params = block.trainable(weights.from_jax_params(p_np, _zero_stats(cfg), cfg)[0])
    opt = optim.make_optimizer(block.param_leaves(params), 1e-3, 5e-4)
    for k, g in enumerate(grads):
        lr = optim.step_lr(1e-3, step_size=2)(k + 1)
        state = joptim.set_lr(state, lr)
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
        optim.set_lr(opt, lr)
        tg = weights.from_jax_params(g, _zero_stats(cfg), cfg)[0]
        for leaf, grad in zip(block.param_leaves(params), block.param_leaves(tg)):
            leaf.grad = grad
        opt.step()
    got = weights.map_shaped(lambda leaf, s, path: leaf.detach(), params,
                             weights.param_shapes(cfg))
    for (path, a), (_, b) in zip(leaves_np(got, cfg), leaves_np(jp, cfg)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-7, err_msg=path)
    assert optim.step_lr(1e-4)(16) == pytest.approx(joptim.step_lr(1e-4)(16))


def _zero_stats(cfg):
    return {"branches": [{"bn": {"mean": np.zeros(cfg.nhidden, np.float32),
                                 "var": np.ones(cfg.nhidden, np.float32)}}]}


def test_train_steps_lower_the_loss():
    _, cfg = configs()
    _, tbb = batches(seed0=7)
    torch.manual_seed(0)
    params = block.trainable(mpnn.init_params(torch.Generator().manual_seed(0), cfg))
    stats = mpnn.init_batch_stats(cfg)
    opt = optim.make_optimizer(block.param_leaves(params), 3e-3, 5e-4)
    step = block.make_block_train_step(cfg, tp_classifier=True)
    losses = []
    for _ in range(6):
        params, stats, loss, aux = step(params, stats, opt, tbb)
        assert np.isfinite(float(loss)) and set(aux) == {"loss_ce", "loss_f", "tp", "fp", "fn"}
        losses.append(float(loss))
    assert losses[-1] < losses[0]


# ------------------------------------------------------------- msg concat ----
VIS = 8
CONCAT_KW = [{"msg_type": "concat"}, {"msg_type": "concat", "features": "2d vis"},
             {"msg_type": "concat", "features": "2d temp"}]


def feature_batches(features, n=2, seed0=3):
    """batches()' windows with, per branch of `features` beyond 2d, the temp
    columns (each detection's frame through data/common.py::
    temporal_features) and VIS seeded normal vis columns."""
    from trackmpnn_tpu_torch.data.common import temporal_features

    rng = np.random.default_rng(seed0)
    chunks = []
    for X, y in training_chunks(n, seed0):
        cols = [X]
        if "temp" in features:
            cols.append(temporal_features(y[:, :1].astype(np.float32)))
        if "vis" in features:
            cols.append(rng.normal(size=(len(X), VIS)))
        chunks.append((np.concatenate(cols, 1).astype(np.float32), y))
    j = [jschedule.build_window_schedule(X, y, cap=CAP, t_cap=TCAP) for X, y in chunks]
    t = [schedule.build_window_schedule(X, y, cap=CAP, t_cap=TCAP) for X, y in chunks]
    return jblock.build_block_batch(j, TCAP), block.build_block_batch(t, TCAP, device="cpu")


@pytest.fixture(scope="module", params=CONCAT_KW,
                ids=["2d", "2d vis", "2d temp"])
def concat_case(request):
    """JAX's loss, aux and grads of its block step (its XLA round, which
    concatenates the endpoints into a 2H input) with msg 'concat', and the
    inputs both packages share."""
    base = dict(features="2d", ncategories=3, nhidden=HIDDEN, num_vis_feats=VIS)
    jcfg = jmpnn.ModelConfig(**{**base, **request.param})
    cfg = mpnn.ModelConfig(**{**base, **request.param})
    jbb, tbb = feature_batches(cfg.features)
    p_np, s_np = spread_weights(cfg, 11)

    def f(p):
        return jblock.block_window_forward(p, s_np, jcfg, jbb, True, defer_loss=True)

    out = jax.jit(jax.value_and_grad(f, has_aux=True))(jax.tree_util.tree_map(jnp.asarray, p_np))
    yield cfg, tbb, p_np, s_np, out
    jax.clear_caches()


@pytest.mark.parametrize("composition", ["default", "es_kernel", "fused_loss"])
def test_concat_step_matches_jax(concat_case, composition):
    """msg 'concat' (the round's input gates from the two halves of w_ih
    with sign +1, JAX block.py:854-860) with one, or two feature branches,
    in each composition: make_block_train_step's first step's loss, aux,
    every gradient and the BN stats against JAX's block step."""
    cfg, tbb, p_np, s_np, ((jl, jaux), jg) = concat_case
    params, stats = weights.from_jax_params(p_np, s_np, cfg)
    params = block.trainable(params)
    opt = optim.make_optimizer(block.param_leaves(params), 1e-3, 5e-4)
    step = block.make_block_train_step(cfg, True, es_kernel=composition == "es_kernel",
                                       fused_loss=composition == "fused_loss")
    params, new_stats, tl, taux = step(params, stats, opt, tbb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    for k in ("loss_ce", "loss_f"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-4, atol=1e-6)
    for k in ("tp", "fp", "fn"):
        assert int(taux[k]) == int(jaux[k]), k
    grads = weights.map_shaped(lambda leaf, s, path: leaf.grad, params, weights.param_shapes(cfg))
    pairs = list(zip(leaves_np(grads, cfg), leaves_np(jg, cfg)))
    for (path, a), (_, b) in pairs:
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=3e-5, err_msg=path)
    w_ih = dict(p for p, _ in pairs)["branches/0/edge_gru/w_ih"]
    assert w_ih.shape == (2 * HIDDEN, 3 * HIDDEN) and np.abs(w_ih[HIDDEN:]).max() > 0
    got_stats = weights.map_shaped(lambda leaf, s, path: leaf, new_stats,
                                   weights.stats_shapes(cfg))
    for (path, a), (_, b) in zip(leaves_np(got_stats, cfg, weights.stats_shapes),
                                 leaves_np(jaux["batch_stats"], cfg, weights.stats_shapes)):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=3e-5, err_msg=path)


# ------------------------------------------------------------ attention heads ----
NH = 2


def gat_configs():
    return (jmpnn.ModelConfig(features="2d", ncategories=3, nhidden=HIDDEN, nattheads=NH),
            mpnn.ModelConfig(features="2d", ncategories=3, nhidden=HIDDEN, nattheads=NH))


@pytest.mark.parametrize("train", [True, False])
def test_block_gat_step_matches_jax(monkeypatch, train):
    """Loss and aux of the step with NH heads against JAX's block step
    through its XLA attention path (fused=False), and in training the
    grads, W_att and a included.  Dropout is off on both sides (as
    tests/test_block_step.py:226 does): the two draw their keep masks from
    different streams; test_block_gat_support_with_jax_dropout_masks shares
    them."""
    monkeypatch.setattr(jmpnn, "ATT_DROPOUT", 0.0)
    monkeypatch.setattr(mpnn, "ATT_DROPOUT", 0.0)
    jcfg, cfg = gat_configs()
    jbb, tbb = batches(seed0=20)
    p_np, s_np = spread_weights(cfg, 5)

    def f(p):
        return jblock.block_window_forward(p, s_np, jcfg, jbb, True, train=train,
                                           rng=jax.random.key(0), defer_loss=True)

    p_j = jax.tree_util.tree_map(jnp.asarray, p_np)
    params, stats = weights.from_jax_params(p_np, s_np, cfg)
    params = block.trainable(params)
    tl, taux = block.block_window_forward(params, stats, cfg, tbb, True, train=train,
                                          generator=torch.Generator().manual_seed(0))
    if train:
        (jl, jaux), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(p_j)
        tl.backward()
    else:
        jl, jaux = jax.jit(f)(p_j)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    for k in ("loss_ce", "loss_f"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-4, atol=1e-6)
    for k in ("tp", "fp", "fn"):
        assert int(taux[k]) == int(jaux[k]), k
    if not train:
        return
    grads = weights.map_shaped(lambda leaf, s, path: leaf.grad, params, weights.param_shapes(cfg))
    pairs = list(zip(leaves_np(grads, cfg), leaves_np(jg, cfg)))
    assert sum(path.startswith("branches/0/gat/") for (path, _), _ in pairs) == 2 * NH
    for (path, a), (_, b) in pairs:
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=3e-5, err_msg=path)


def test_block_gat_support_with_jax_dropout_masks():
    """Real dropout (p = ATT_DROPOUT): JAX's own keep masks, drawn with the
    fold_in calls of its per-head path (block.py:475-478), go to the port's
    _block_gat_support through att_keep; es and its gradients (W_att, a,
    the detection and edge hiddens) match JAX's _block_gat_support
    (fused=False, train=True)."""
    rng = np.random.default_rng(7)
    B, capD, P, na, nt, H = 2, 16, 4, 5, 6, HIDDEN
    blk_na, blk_nt = rng.integers(1, na + 1, P), rng.integers(1, nt + 1, P)
    blk_nt[3] = 0  # a block with no new detection
    row_live = np.arange(na)[None] < blk_na[:, None]
    col_live = (np.arange(nt)[None] < blk_nt[:, None]) & (blk_nt[:, None] > 0)
    em3 = row_live[:, :, None] & col_live[:, None, :]
    win = (np.arange(P) % B)[:, None] * capD
    act_l = np.where(row_live, rng.integers(0, capD, (P, na)), 0).astype(np.int32)
    new_l = np.where(col_live, rng.integers(0, capD, (P, nt)), 0).astype(np.int32)
    act, new = win + act_l, win + new_l
    h_d = rng.normal(size=(B * capD, H)).astype(np.float32)
    h_e = (rng.normal(size=(P, na, nt, H)) * em3[..., None]).astype(np.float32)
    gp = [{"W_att": rng.normal(size=(H, H)).astype(np.float32) * 0.3,
           "a": rng.normal(size=(H, 1)).astype(np.float32) * 0.3} for _ in range(NH)]
    cot = rng.normal(size=(B * capD, H)).astype(np.float32)
    seg = np.concatenate([act.reshape(-1), new.reshape(-1)])
    vm = np.concatenate([row_live.reshape(-1), col_live.reshape(-1)])
    drop = jax.random.key(3)
    keep = 1.0 - jmpnn.ATT_DROPOUT
    masks = [np.stack([np.asarray(jax.random.bernoulli(jax.random.fold_in(drop, 2 * h + k),
                                                       keep, em3.shape))
                       for h in range(NH)]).astype(np.float32) for k in (0, 1)]
    assert 0 < masks[0].mean() < 1

    def f(gp, h_d, h_e):
        return jblock._block_gat_support(gp, h_d, h_e, jnp.asarray(act), jnp.asarray(new),
                                         jnp.asarray(em3), jnp.asarray(seg), jnp.asarray(vm),
                                         B * capD, drop, True, fused=False)

    want, pull = jax.vjp(jax.jit(f), jax.tree_util.tree_map(jnp.asarray, gp),
                         jnp.asarray(h_d), jnp.asarray(h_e))
    (wg, wd, we) = jax.jit(pull)(jnp.asarray(cot))
    tgp = [{k: torch.from_numpy(v).requires_grad_(True) for k, v in hp.items()} for hp in gp]
    td, te = (torch.from_numpy(x).requires_grad_(True) for x in (h_d, h_e))
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    got = block._block_gat_support(tgp, td, te, t(act).long(), t(new).long(), t(act_l),
                                   t(new_l), t(em3.astype(np.float32)), t(row_live),
                                   t(col_live), B, capD, att_keep=(t(masks[0]), t(masks[1])))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    leaves = [tgp[h][k] for h in range(NH) for k in ("W_att", "a")] + [td, te]
    grads = torch.autograd.grad(got, leaves, t(cot))
    wants = [wg[h][k] for h in range(NH) for k in ("W_att", "a")] + [wd, we]
    for a, b in zip(grads, wants):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)


def test_gat_train_steps_with_dropout_lower_the_loss():
    """A few steps of the port's step with real attention dropout drawn from
    a generator run and lower the loss."""
    _, cfg = gat_configs()
    cfg = cfg._replace(nattheads=1)
    _, tbb = batches(seed0=7)
    p_np, s_np = spread_weights(cfg, 6, std=0.1)
    params, stats = weights.from_jax_params(p_np, s_np, cfg)
    params = block.trainable(params)
    opt = optim.make_optimizer(block.param_leaves(params), 3e-3, 5e-4)
    step = block.make_block_train_step(cfg, tp_classifier=True)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="generator"):
        step(params, stats, opt, tbb)
    losses = []
    for _ in range(6):
        params, stats, loss, _ = step(params, stats, opt, tbb, generator=gen)
        assert np.isfinite(float(loss))
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses
