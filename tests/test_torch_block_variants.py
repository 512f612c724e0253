"""The port's block step in the JAX package's two other compositions
(trackmpnn_tpu_torch/train/block.py with es_kernel and fused_loss) against
the JAX block step with TM_ES_KERNEL=1 / TM_FUSED_LOSS=1 (fused=True,
defer_loss=False; its Pallas kernels in interpret mode), on the same chunks
and weights.

Loss, loss_ce and loss_f within rtol 1e-4; tp/fp/fn equal; gradients within
rtol 1e-3, atol 3e-5, the tolerances of tests/test_torch_block_step.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_block_step import batches, configs, leaves_np
from torch_port_util import spread_weights
from trackmpnn_tpu.train import block as jblock
from trackmpnn_tpu.train import optim as joptim
from trackmpnn_tpu_torch.models import mpnn, weights
from trackmpnn_tpu_torch.train import block, optim

torch.set_num_threads(1)

LR, WD = 1e-3, 5e-4


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


@pytest.mark.parametrize("es_kernel,fused_loss,tp_classifier",
                         [(True, False, True), (False, True, False), (True, True, True)])
def test_block_step_composition_matches_jax(monkeypatch, es_kernel, fused_loss, tp_classifier):
    """make_block_train_step(es_kernel=, fused_loss=): the loss, aux and
    gradients of its first step against jax.value_and_grad of the JAX block
    step in the same composition.  Every parameter's update follows optax's
    Adam with L2: out_node, which feeds no loss term in the fused loss
    without tp_classifier, is still decayed (a zero gradient, not none)."""
    monkeypatch.setenv("TM_ES_KERNEL", "1" if es_kernel else "0")
    if fused_loss:
        monkeypatch.setenv("TM_FUSED_LOSS", "1")
    jcfg, cfg = configs()
    jbb, tbb = batches(seed0=20)
    p_np, s_np = spread_weights(cfg, 3)

    def f(p):
        return jblock.block_window_forward(p, s_np, jcfg, jbb, tp_classifier, fused=True,
                                           defer_loss=False)

    p_j = jax.tree_util.tree_map(jnp.asarray, p_np)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(p_j)
    params, stats = weights.from_jax_params(p_np, s_np, cfg)
    params = block.trainable(params)
    opt = optim.make_optimizer(block.param_leaves(params), LR, WD)
    step = block.make_block_train_step(cfg, tp_classifier, es_kernel=es_kernel,
                                       fused_loss=fused_loss)
    params, _, tl, taux = step(params, stats, opt, tbb)

    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    for k in ("loss_ce", "loss_f"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-4, atol=1e-6)
    for k in ("tp", "fp", "fn"):
        assert int(taux[k]) == int(jaux[k]), k
    grads = weights.map_shaped(lambda leaf, s, path: leaf.grad, params, weights.param_shapes(cfg))
    for (path, a), (_, b) in zip(leaves_np(grads, cfg), leaves_np(jg, cfg)):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=3e-5, err_msg=path)
    # one Adam step: where the gradient is 0 in both packages the update is
    # L2's alone, so those leaves must agree with optax closely
    tx = joptim.make_optimizer(LR, WD)
    updates, _ = tx.update(jg, tx.init(p_j), p_j)
    new_j = jax.tree_util.tree_map(lambda p, u: p + u, p_j, updates)
    got = weights.map_shaped(lambda leaf, s, path: leaf.detach(), params,
                             weights.param_shapes(cfg))
    for (path, a), (_, b), (_, g) in zip(leaves_np(got, cfg), leaves_np(new_j, cfg),
                                         leaves_np(jg, cfg)):
        if not np.any(g):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-7, err_msg=path)


def test_es_kernel_refuses_attention_heads():
    """The es round computes edge_support without attention: with heads the
    port refuses it (the JAX package drops the kernel silently there)."""
    cfg = mpnn.ModelConfig(features="2d", ncategories=3, nhidden=16, nattheads=1)
    with pytest.raises(ValueError, match="attention heads"):
        block.make_block_train_step(cfg, True, es_kernel=True)
    _, tbb = batches(seed0=20)
    params = mpnn.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="attention heads"):
        block.block_window_forward(params, mpnn.init_batch_stats(cfg), cfg, tbb, True,
                                   train=False, es_kernel=True)


@pytest.mark.parametrize("tp_classifier", [True, False])
def test_fused_loss_with_heads_equals_the_deferred_loss(tp_classifier):
    """fused_loss with an attention head (eval mode, no dropout): the same
    loss and counts as the port's default composition, whose loss side the
    JAX package's tests pin."""
    cfg = mpnn.ModelConfig(features="2d", ncategories=3, nhidden=16, nattheads=1)
    _, tbb = batches(seed0=20)
    p_np, s_np = spread_weights(cfg, 4)
    params, stats = weights.from_jax_params(p_np, s_np, cfg)
    with torch.no_grad():
        want = block.block_window_forward(params, stats, cfg, tbb, tp_classifier, train=False)
        got = block.block_window_forward(params, stats, cfg, tbb, tp_classifier, train=False,
                                         fused_loss=True)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    for k in ("loss_ce", "loss_f"):
        torch.testing.assert_close(got[1][k], want[1][k], rtol=1e-5, atol=1e-6)
    for k in ("tp", "fp", "fn"):
        assert int(got[1][k]) == int(want[1][k]), k
