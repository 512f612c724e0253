"""The port's block train step with more than one feature branch
(trackmpnn_tpu_torch/train/block.py: '2d+temp' and the CLIs' default
'2d+temp+vis') against the JAX package's block step, on the same windows
and weights: the default composition, es_kernel and fused_loss, and with
attention heads both attention routes (gat_fused True and False) on JAX's
own dropout masks.

The JAX references run block_window_forward with its plain round
(fused=False, so no interpret-mode Pallas runs through a whole step),
defer_loss=True and one prefix segment (TM_PREFIX_K=1: every round sees all
B*T blocks, so its keep masks have the port's shapes once cut to the live
prefix).  Loss, loss_ce and loss_f within rtol 1e-4; tp/fp/fn equal;
gradients within rtol 1e-3 with an atol of 1e-4 x the largest |grad| (sums
in another order); every branch's new BN running stats within rtol 1e-3,
atol 3e-5 (tests/test_torch_block_step.py's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_block_step import leaves_np
from torch_port_util import spread_weights
from trackmpnn_tpu.graph import schedule as jschedule
from trackmpnn_tpu.models import mpnn as jmpnn
from trackmpnn_tpu.train import block as jblock
from trackmpnn_tpu_torch.data.common import temporal_features
from trackmpnn_tpu_torch.data.synthetic import make_sequence
from trackmpnn_tpu_torch.graph import schedule
from trackmpnn_tpu_torch.models import mpnn, weights
from trackmpnn_tpu_torch.train import block, optim

torch.set_num_threads(1)

CAP, HIDDEN, VIS, NH = 128, 16, 8, 2
FEATURES = ["2d+temp", "2d+temp+vis"]


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


def configs(features, nattheads=0):
    kw = dict(features=features, ncategories=3, nhidden=HIDDEN, num_vis_feats=VIS,
              nattheads=nattheads)
    return jmpnn.ModelConfig(**kw), mpnn.ModelConfig(**kw)


def batches(features):
    """Two windows (3 and 4 frames) whose detections carry the 2d columns,
    the temp columns (data/common.py::temporal_features of their frames)
    and with vis VIS seeded normal columns, for both packages."""
    rng = np.random.default_rng(0)
    chunks, seed = [], 0
    for frames in (3, 4):
        while True:
            X, bp, _ = make_sequence(num_tracks=3, num_frames=frames, seed=seed, miss_rate=0.15,
                                     fp_rate=0.2)
            seed += 1
            y = bp[:, :2].astype(np.int64)
            if schedule.build_window_schedule(X, y) is not None:
                cols = [X, temporal_features(bp[:, :1])]
                if "vis" in features:
                    cols.append(rng.normal(size=(len(X), VIS)))
                chunks.append((np.concatenate(cols, 1).astype(np.float32), y))
                break
    t_cap = max(schedule.build_window_schedule(X, y).n_steps for X, y in chunks)
    j = [jschedule.build_window_schedule(X, y, cap=CAP, t_cap=t_cap) for X, y in chunks]
    t = [schedule.build_window_schedule(X, y, cap=CAP, t_cap=t_cap) for X, y in chunks]
    return jblock.build_block_batch(j, t_cap), block.build_block_batch(t, t_cap, device="cpu")


def jax_reference(monkeypatch, features, nattheads=0, rng=None):
    """JAX's loss, aux and grads of the block step on `features`, and the
    inputs both packages share."""
    monkeypatch.setenv("TM_PREFIX_K", "1")
    jcfg, cfg = configs(features, nattheads)
    jbb, tbb = batches(features)
    p_np, s_np = spread_weights(cfg, 8)

    def f(p):
        return jblock.block_window_forward(p, s_np, jcfg, jbb, True, rng=rng, defer_loss=True)

    out = jax.jit(jax.value_and_grad(f, has_aux=True))(jax.tree_util.tree_map(jnp.asarray, p_np))
    return cfg, tbb, p_np, s_np, out


def assert_step_matches(cfg, params, tl, taux, jax_out):
    (jl, jaux), jg = jax_out
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    for k in ("loss_ce", "loss_f"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-4)
    for k in ("tp", "fp", "fn"):
        assert int(taux[k]) == int(jaux[k]), k
    grads = weights.map_shaped(lambda leaf, s, path: leaf.grad, params, weights.param_shapes(cfg))
    pairs = list(zip(leaves_np(grads, cfg), leaves_np(jg, cfg)))
    scale = max(float(np.abs(b).max()) for _, (_, b) in pairs)
    for (path, a), (_, b) in pairs:
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4 * scale, err_msg=path)
    nb = len(cfg.branches)
    # every branch trains: its own weights get gradients
    assert all(any(path.startswith(f"branches/{bi}/") and np.abs(a).max() > 0
                   for (path, a), _ in pairs) for bi in range(nb))
    got_stats = weights.map_shaped(lambda leaf, s, path: leaf, taux["batch_stats"],
                                   weights.stats_shapes(cfg))
    stats = list(zip(leaves_np(got_stats, cfg, weights.stats_shapes),
                     leaves_np(jaux["batch_stats"], cfg, weights.stats_shapes)))
    assert len(stats) == 2 * nb
    for (path, a), (_, b) in stats:
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=3e-5, err_msg=path)


@pytest.fixture(scope="module", params=FEATURES)
def branch_case(request):
    mp = pytest.MonkeyPatch()
    try:
        yield jax_reference(mp, request.param)
    finally:
        mp.undo()
        jax.clear_caches()


@pytest.mark.parametrize("composition", ["default", "es_kernel", "fused_loss"])
def test_branch_step_matches_jax(branch_case, composition):
    """make_block_train_step's first step in each composition: loss, aux,
    every gradient and every branch's BN stats against JAX's block step."""
    cfg, tbb, p_np, s_np, jax_out = branch_case
    assert len(cfg.branches) in (2, 3)
    params, stats = weights.from_jax_params(p_np, s_np, cfg)
    params = block.trainable(params)
    opt = optim.make_optimizer(block.param_leaves(params), 1e-3, 5e-4)
    step = block.make_block_train_step(cfg, True, es_kernel=composition == "es_kernel",
                                       fused_loss=composition == "fused_loss")
    params, new_stats, tl, taux = step(params, stats, opt, tbb)
    assert_step_matches(cfg, params, tl, {**taux, "batch_stats": new_stats}, jax_out)


@pytest.fixture(scope="module")
def heads_case():
    """The default features with NH heads and real dropout: JAX's block step
    (its per-head XLA route, fused=False) and JAX's own keep masks, drawn as
    that route draws them (block.py:816, 920-922, 475-478), cut to each
    round's live prefix."""
    mp = pytest.MonkeyPatch()
    try:
        key = jax.random.key(4)
        cfg, tbb, p_np, s_np, out = jax_reference(mp, "2d+temp+vis", NH, rng=key)
        B, T, na, nt = tbb.n_windows, tbb.t_cap, tbb.na_cap, tbb.nt_cap
        keep = 1.0 - jmpnn.ATT_DROPOUT
        att_keep = []
        for s in range(T):
            per_branch = []
            for bi in range(len(cfg.branches)):
                drop = jax.random.fold_in(jax.random.fold_in(key, s), bi)
                per_branch.append(tuple(
                    torch.from_numpy(np.stack([
                        np.asarray(jax.random.bernoulli(jax.random.fold_in(drop, 2 * h + k), keep,
                                                        (B * T, na, nt)))[:(s + 1) * B]
                        for h in range(NH)]).astype(np.float32))
                    for k in (0, 1)))
            att_keep.append(per_branch)
        yield cfg, tbb, p_np, s_np, out, att_keep
    finally:
        mp.undo()
        jax.clear_caches()


@pytest.mark.parametrize("gat_fused", [True, False])
def test_branch_step_with_heads_matches_jax(heads_case, gat_fused):
    """Three branches, NH heads each, dropout on JAX's masks: the stacked
    route and the per-head route (the single-head kernels' plain versions)
    each against JAX's block step."""
    cfg, tbb, p_np, s_np, jax_out, att_keep = heads_case
    assert 0 < float(att_keep[-1][2][0].mean()) < 1
    params, stats = weights.from_jax_params(p_np, s_np, cfg)
    params = block.trainable(params)
    tl, taux = block.block_window_forward(params, stats, cfg, tbb, True, att_keep=att_keep,
                                          gat_fused=gat_fused)
    tl.backward()
    assert_step_matches(cfg, params, tl.detach(), taux, jax_out)


def test_branch_keep_masks_must_match_the_branches():
    """att_keep[s] holds one pair a branch; a bare pair is a one-branch
    model's only."""
    _, cfg = configs("2d+temp", 1)
    _, tbb = batches("2d+temp")
    params = mpnn.init_params(torch.Generator().manual_seed(0), cfg)
    shape = (1, tbb.n_windows, tbb.na_cap, tbb.nt_cap)
    pair = (torch.ones(shape), torch.ones(shape))
    with pytest.raises(ValueError, match="branches"):
        block.block_window_forward(params, mpnn.init_batch_stats(cfg), cfg, tbb, True,
                                   att_keep=[pair] * tbb.t_cap)
