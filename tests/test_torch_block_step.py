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


@pytest.mark.parametrize("kw", [{"msg_type": "concat"}, {"nattheads": 1}, {"features": "2d temp"}])
def test_unported_configs_raise(kw):
    cfg = mpnn.ModelConfig(nhidden=HIDDEN)._replace(**kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        block.make_block_train_step(cfg, tp_classifier=True)
