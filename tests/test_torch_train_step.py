"""The port's row-layout train steps (trackmpnn_tpu_torch/train/step.py and
train/packed.py) against the JAX package's, on the same tiny schedules
(make_sequence with 3 tracks and 4-5 frames, cap 128, t_cap 6, so that some
steps are padding) and weights, H 64.

Tolerances are the block step's f32 ones (tests/test_torch_block_step.py): loss,
loss_ce and loss_f within rtol 1e-4; tp/fp/fn equal; gradients, BN running
stats and the final hidden state within rtol 1e-3, atol 3e-5.  The port
runs on the CPU through the plain versions of its kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import spread_weights
from trackmpnn_tpu.graph import schedule as jschedule
from trackmpnn_tpu.models import mpnn as jmpnn
from trackmpnn_tpu.ops import pallas_round as PR
from trackmpnn_tpu.train import optim as joptim
from trackmpnn_tpu.train import packed as jpacked
from trackmpnn_tpu.train import step as jstep
from trackmpnn_tpu_torch.data.synthetic import make_sequence
from trackmpnn_tpu_torch.graph import schedule
from trackmpnn_tpu_torch.models import mpnn, weights
from trackmpnn_tpu_torch.train import block, optim, packed, step

torch.set_num_threads(1)

CAP, TCAP, HIDDEN = 128, 6, 64
LOSS_RTOL = 1e-4
GRAD = {"rtol": 1e-3, "atol": 3e-5}


@pytest.fixture(scope="module")
def schedules():
    """Three windows (4, 5 and 4 frames) for both packages, one seed each."""
    chunks, seed = [], 0
    for frames in (4, 5, 4):
        while True:
            X, bp, _ = make_sequence(num_tracks=3, num_frames=frames, seed=seed)
            seed += 1
            y = bp[:, :2].astype(np.int64)
            if schedule.build_window_schedule(X, y) is not None:
                chunks.append((X, y))
                break
    j = [jschedule.build_window_schedule(X, y, cap=CAP, t_cap=TCAP) for X, y in chunks]
    t = [schedule.build_window_schedule(X, y, cap=CAP, t_cap=TCAP) for X, y in chunks]
    assert len({w.n_steps for w in t}) > 1 and max(w.n_steps for w in t) < TCAP
    return j, t


def configs(heads=0):
    return (jmpnn.ModelConfig(features="2d", ncategories=3, nhidden=HIDDEN, nattheads=heads),
            mpnn.ModelConfig(features="2d", ncategories=3, nhidden=HIDDEN, nattheads=heads))


def leaves_np(tree, cfg, shapes=weights.param_shapes):
    flat = []
    weights.map_shaped(lambda leaf, s, path: flat.append((path, np.asarray(leaf))),
                       tree, shapes(cfg))
    return flat


def assert_grads_match(params, jgrads, cfg):
    grads = weights.map_shaped(lambda leaf, s, path: leaf.grad, params,
                               weights.param_shapes(cfg))
    pairs = list(zip(leaves_np(grads, cfg), leaves_np(jgrads, cfg)))
    for (path, a), (_, b) in pairs:
        np.testing.assert_allclose(a, b, err_msg=path, **GRAD)
    return pairs


def assert_stats_match(got, want, cfg):
    got = weights.map_shaped(lambda leaf, s, path: leaf, got, weights.stats_shapes(cfg))
    for (path, a), (_, b) in zip(leaves_np(got, cfg, weights.stats_shapes),
                                 leaves_np(want, cfg, weights.stats_shapes)):
        np.testing.assert_allclose(a, b, err_msg=path, **GRAD)


def assert_losses_match(tl, taux, jl, jaux):
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    for k in ("loss_ce", "loss_f"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=LOSS_RTOL, atol=1e-6)
    for k in ("tp", "fp", "fn"):
        np.testing.assert_array_equal(np.asarray(taux[k]), np.asarray(jaux[k]), err_msg=k)


def port_model(p_np, s_np, cfg):
    params, stats = weights.from_jax_params(p_np, s_np, cfg)
    return block.trainable(params), stats


def test_batch1_step_matches_jax(schedules):
    """window_forward of one window (3 valid steps of 6): loss, aux, BN
    stats after the window, final hidden state and grads against
    jax.value_and_grad(window_forward); make_train_step's grads (left on
    each leaf's .grad) and make_eval_window on the same window."""
    (jw, _, _), (tw, _, _) = schedules
    jcfg, cfg = configs()
    p_np, s_np = spread_weights(cfg, 0)
    jsb = jstep.schedule_to_device(jw)
    f = lambda p: jstep.window_forward(p, s_np, jcfg, jsb, True)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, p_np))
    params, stats = port_model(p_np, s_np, cfg)
    sb = step.schedule_to_device(tw, device="cpu")
    tl, taux = step.window_forward(params, stats, cfg, sb, True)
    tl.backward()
    assert_losses_match(tl.detach(), taux, jl, jaux)
    np.testing.assert_array_equal(taux["step_valid"].numpy(), np.asarray(jaux["step_valid"]))
    assert not taux["step_valid"].all()
    assert_grads_match(params, jg, cfg)
    assert_stats_match(taux["batch_stats"], jaux["batch_stats"], cfg)
    np.testing.assert_allclose(taux["hidden"].numpy(), np.asarray(jaux["hidden"]), **GRAD)

    # the step returns the same grads before its update; eval mode runs
    params, stats = port_model(p_np, s_np, cfg)
    opt = optim.make_optimizer(block.param_leaves(params), 1e-4, 5e-4)
    _, new_stats, loss, _ = step.make_train_step(cfg, True)(params, stats, opt, sb)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    assert_grads_match(params, jg, cfg)
    el, eaux = step.make_eval_window(cfg, True)(params, new_stats, sb)
    assert np.isfinite(float(el)) and eaux["batch_stats"]["branches"][0]["bn"]["mean"].equal(
        new_stats["branches"][0]["bn"]["mean"])


def test_batch1_step_with_one_head_and_jax_dropout_masks(schedules):
    """One GAT head with real attention dropout: the keep masks are JAX's
    own, drawn with the keys its scan folds in (step.py:76 per step,
    mpnn.py:179 and :243 per branch and head), handed to the port through
    att_keep."""
    (_, jw, _), (_, tw, _) = schedules
    jcfg, cfg = configs(heads=1)
    p_np, s_np = spread_weights(cfg, 1, std=0.1)
    key = jax.random.key(7)
    keep = 1.0 - jmpnn.ATT_DROPOUT
    masks = []
    for s in range(TCAP):
        k_head = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(key, s), 0), 0)
        masks.append([[torch.from_numpy(np.array(
            jax.random.bernoulli(k_head, keep, (2 * CAP,))))]])
    assert 0 < float(masks[0][0][0].float().mean()) < 1
    jsb = jstep.schedule_to_device(jw)
    f = lambda p: jstep.window_forward(p, s_np, jcfg, jsb, True, rng=key)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, p_np))
    params, stats = port_model(p_np, s_np, cfg)
    sb = step.schedule_to_device(tw, device="cpu")
    with pytest.raises(ValueError, match="generator"):
        step.window_forward(params, stats, cfg, sb, True)
    tl, taux = step.window_forward(params, stats, cfg, sb, True, att_keep=masks)
    tl.backward()
    assert_losses_match(tl.detach(), taux, jl, jaux)
    pairs = assert_grads_match(params, jg, cfg)
    assert any(path.startswith("branches/0/gat/") for (path, _), _ in pairs)


@pytest.fixture(scope="module")
def packed_case(schedules):
    """The three windows packed for both packages, and JAX's loss, aux and
    grads of its (unfused) packed_window_forward."""
    jw, tw = schedules
    jcfg, cfg = configs()
    p_np, s_np = spread_weights(cfg, 2)
    jpb = jpacked.pack_schedules(jw, CAP, TCAP)
    tpb = packed.pack_schedules(tw, CAP, TCAP, device="cpu")
    f = lambda p: jpacked.packed_window_forward(p, s_np, jcfg, jpb, True)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, p_np))
    return jpb, tpb, p_np, s_np, (jl, jaux, jg)


def test_pack_schedules_equals_jax(packed_case):
    jpb, tpb, _, _, _ = packed_case
    for field in jpacked.PackedBatch._fields:
        a, b = np.asarray(getattr(jpb, field)), getattr(tpb, field).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert np.array_equal(tpb.valid_host, np.asarray(jpb.step_valid))
    assert not tpb.valid_host.all()
    # the incidence lists each edge of the final graphs under both endpoints
    is_det = tpb.is_det.numpy().reshape(tpb.n_windows, CAP)
    rows = tpb.n_after.numpy().max(0)
    n_edges = sum(int((~is_det[k, :rows[k]]).sum()) for k in range(tpb.n_windows))
    assert tpb.inc_ptr[-1] == tpb.inc_idx.numel() == 2 * n_edges > 0


@pytest.mark.parametrize("fused", [False, True])
def test_packed_forward_matches_jax(packed_case, fused):
    """Loss, aux, BN stats, final hidden state and grads of the port's
    packed_window_forward, with and without the fused round, against
    jax.value_and_grad of JAX's (its fused path equals its unfused one,
    tests/test_pallas_round.py:46; the fused loss is checked against JAX's
    fused path in interpret mode below)."""
    _, tpb, p_np, s_np, (jl, jaux, jg) = packed_case
    _, cfg = configs()
    params, stats = port_model(p_np, s_np, cfg)
    tl, taux = packed.packed_window_forward(params, stats, cfg, tpb, True, fused_round=fused)
    tl.backward()
    assert_losses_match(tl.detach(), taux, jl, jaux)
    assert_grads_match(params, jg, cfg)
    assert_stats_match(taux["batch_stats"], jaux["batch_stats"], cfg)
    np.testing.assert_allclose(taux["hidden"].numpy(), np.asarray(jaux["hidden"]), **GRAD)


def test_packed_fused_forward_matches_jax_fused_round(packed_case):
    """packed_window_forward(fused_round=True) of both packages, JAX's fused
    round in interpret mode: loss within rtol 1e-4, the final hidden state
    within rtol 1e-3, atol 1e-4 (tests/test_pallas_round.py:77-79)."""
    jpb, tpb, p_np, s_np, _ = packed_case
    jcfg, cfg = configs()
    PR._INTERPRET[0] = True
    try:
        jl, jaux = jpacked.packed_window_forward(
            jax.tree_util.tree_map(jnp.asarray, p_np), s_np, jcfg, jpb, True, fused_round=True)
    finally:
        PR._INTERPRET[0] = False
    params, stats = weights.from_jax_params(p_np, s_np, cfg)
    with torch.no_grad():
        tl, taux = packed.packed_window_forward(params, stats, cfg, tpb, True, fused_round=True)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    np.testing.assert_allclose(taux["hidden"].numpy(), np.asarray(jaux["hidden"]), rtol=1e-3,
                               atol=1e-4)


def test_packed_train_step_matches_optax(packed_case):
    """One make_packed_train_step step (Adam 1e-4 with L2 5e-4) against
    JAX's with optax's: loss as above, every parameter within rtol 1e-5 and
    an atol of 1e-6, a hundredth of the step: Adam's first step moves each
    entry by about lr * sign(grad), so an entry whose gradient is near 0 (a
    few 1e-7, where the two packages' sums differ in their last digits)
    moves by a different fraction of lr."""
    jpb, tpb, p_np, s_np, (jl, _, _) = packed_case
    jcfg, cfg = configs()
    tx = joptim.make_optimizer(1e-4, 5e-4)
    jp = jax.tree_util.tree_map(jnp.asarray, p_np)
    jp, _, _, jloss, _ = jpacked.make_packed_train_step(jcfg, tx, True)(jp, s_np, tx.init(jp),
                                                                        jpb)
    params, stats = port_model(p_np, s_np, cfg)
    opt = optim.make_optimizer(block.param_leaves(params), 1e-4, 5e-4)
    params, _, loss, aux = packed.make_packed_train_step(cfg, True)(params, stats, opt, tpb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    assert set(aux) == {"loss_ce", "loss_f", "tp", "fp", "fn"}
    got = weights.map_shaped(lambda leaf, s, path: leaf.detach(), params,
                             weights.param_shapes(cfg))
    for (path, a), (_, b) in zip(leaves_np(got, cfg), leaves_np(jp, cfg)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=path)


def test_fused_round_refuses_heads(packed_case):
    _, tpb, _, _, _ = packed_case
    _, cfg = configs(heads=1)
    params = mpnn.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="fused round"):
        packed.packed_window_forward(params, mpnn.init_batch_stats(cfg), cfg, tpb, True,
                                     fused_round=True)


# ------------------------------------------------- two feature branches ----
@pytest.fixture(scope="module")
def temp_case():
    """The schedules' windows with the temp columns (each row's frame, as
    data/common.py::temporal_features gives them) beside the 2d ones, for
    features '2d+temp', and JAX's loss, aux and grads of its batch-1 and
    packed forwards on them."""
    from trackmpnn_tpu_torch.data.common import temporal_features

    chunks, seed = [], 0
    for frames in (4, 5, 4):
        while True:
            X, bp, _ = make_sequence(num_tracks=3, num_frames=frames, seed=seed)
            seed += 1
            y = bp[:, :2].astype(np.int64)
            if schedule.build_window_schedule(X, y) is not None:
                X = np.concatenate([X, temporal_features(bp[:, :1])], 1).astype(np.float32)
                chunks.append((X, y))
                break
    jw = [jschedule.build_window_schedule(X, y, cap=CAP, t_cap=TCAP) for X, y in chunks]
    tw = [schedule.build_window_schedule(X, y, cap=CAP, t_cap=TCAP) for X, y in chunks]
    jcfg, cfg = (c._replace(features="2d+temp") for c in configs())
    p_np, s_np = spread_weights(cfg, 3)
    jp = jax.tree_util.tree_map(jnp.asarray, p_np)
    jsb = jstep.schedule_to_device(jw[0])
    jpb = jpacked.pack_schedules(jw, CAP, TCAP)
    batch1 = jax.jit(jax.value_and_grad(
        lambda p: jstep.window_forward(p, s_np, jcfg, jsb, True), has_aux=True))(jp)
    pk = jax.jit(jax.value_and_grad(
        lambda p: jpacked.packed_window_forward(p, s_np, jcfg, jpb, True), has_aux=True))(jp)
    return tw, cfg, p_np, s_np, {"batch1": batch1, "packed": pk}


@pytest.mark.parametrize("path", ["batch1", "packed", "packed_fused"])
def test_row_layout_with_two_feature_branches_matches_jax(temp_case, path):
    """The batch-1 and packed (unfused and fused-round) forwards train both
    branches of a '2d+temp' model: loss, aux, every branch's BN stats, the
    final hidden state and every gradient against the JAX package's."""
    tw, cfg, p_np, s_np, jax_out = temp_case
    (jl, jaux), jg = jax_out["batch1" if path == "batch1" else "packed"]
    params, stats = port_model(p_np, s_np, cfg)
    assert len(cfg.branches) == 2
    if path == "batch1":
        tl, taux = step.window_forward(params, stats, cfg,
                                       step.schedule_to_device(tw[0], device="cpu"), True)
    else:
        tl, taux = packed.packed_window_forward(params, stats, cfg,
                                                packed.pack_schedules(tw, CAP, TCAP, "cpu"),
                                                True, fused_round=path == "packed_fused")
    tl.backward()
    assert_losses_match(tl.detach(), taux, jl, jaux)
    pairs = assert_grads_match(params, jg, cfg)
    assert any(path.startswith("branches/1/") and np.abs(a).max() > 0 for (path, a), _ in pairs)
    assert_stats_match(taux["batch_stats"], jaux["batch_stats"], cfg)
    np.testing.assert_allclose(taux["hidden"].numpy(), np.asarray(jaux["hidden"]), **GRAD)


# ------------------------------------------------------------- msg concat ----
def concat_configs():
    return tuple(c._replace(msg_type="concat") for c in configs())


def test_batch1_concat_step_matches_jax_make_train_step(schedules):
    """msg 'concat' on the batch-1 step: make_train_step's loss, aux,
    gradients (left on each leaf's .grad) and new BN stats against JAX's
    make_train_step(return_grads=True) on the same window (Adam 1e-4, L2
    5e-4)."""
    (jw, _, _), (tw, _, _) = schedules
    jcfg, cfg = concat_configs()
    p_np, s_np = spread_weights(cfg, 4)
    jp = jax.tree_util.tree_map(jnp.asarray, p_np)
    tx = joptim.make_optimizer(1e-4, 5e-4)
    _, jstats, _, jloss, jaux = jstep.make_train_step(jcfg, tx, True, return_grads=True)(
        jp, s_np, tx.init(jp), jstep.schedule_to_device(jw))
    params, stats = port_model(p_np, s_np, cfg)
    opt = optim.make_optimizer(block.param_leaves(params), 1e-4, 5e-4)
    _, new_stats, loss, aux = step.make_train_step(cfg, True)(
        params, stats, opt, step.schedule_to_device(tw, device="cpu"))
    assert_losses_match(loss, aux, jloss, jaux)
    assert not aux["step_valid"].all()
    pairs = assert_grads_match(params, jaux["grads"], cfg)
    w_ih = dict(p for p, _ in pairs)["branches/0/edge_gru/w_ih"]
    assert w_ih.shape == (2 * HIDDEN, 3 * HIDDEN) and np.abs(w_ih[HIDDEN:]).max() > 0
    assert_stats_match(new_stats, jstats, cfg)


def test_packed_concat_forward_matches_jax_and_the_fused_round_refuses_it(schedules):
    """msg 'concat' on the unfused packed step: loss, aux, grads, BN stats
    and final hidden state against jax.value_and_grad of JAX's
    packed_window_forward; the fused round refuses concat with JAX's
    ValueError (packed.py:160-161) on both sides."""
    jw, tw = schedules
    jcfg, cfg = concat_configs()
    p_np, s_np = spread_weights(cfg, 5)
    jpb = jpacked.pack_schedules(jw, CAP, TCAP)
    tpb = packed.pack_schedules(tw, CAP, TCAP, device="cpu")
    f = lambda p: jpacked.packed_window_forward(p, s_np, jcfg, jpb, True)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, p_np))
    params, stats = port_model(p_np, s_np, cfg)
    tl, taux = packed.packed_window_forward(params, stats, cfg, tpb, True)
    tl.backward()
    assert_losses_match(tl.detach(), taux, jl, jaux)
    assert_grads_match(params, jg, cfg)
    assert_stats_match(taux["batch_stats"], jaux["batch_stats"], cfg)
    np.testing.assert_allclose(taux["hidden"].numpy(), np.asarray(jaux["hidden"]), **GRAD)
    with pytest.raises(ValueError, match="fused round supports msg 'diff'"):
        jpacked.packed_window_forward(p_np, s_np, jcfg, jpb, True, fused_round=True)
    with pytest.raises(ValueError, match="fused round supports msg 'diff'"):
        packed.packed_window_forward(params, stats, cfg, tpb, True, fused_round=True)
