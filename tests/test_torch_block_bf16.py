"""The bf16 block step (compute_dtype=torch.bfloat16) and its two bf16
kernels' plain versions against the JAX package's bf16 functions, on the
same numpy inputs, on the CPU.

  * #4 in bf16: ops.block.block_round_reference and its hand-written
    backward on bf16 h_e, ga, gb against interpret-mode
    pallas_block.fused_block_round(..., jnp.bfloat16) and its VJP (BT 5,
    na = nt = 8, H 8, each sign), as tests/test_pallas_block.py:88-100 runs
    it;
  * #12 with a bf16 h_e: ops.gat's stacked aggregate and its backward
    against interpret-mode pallas_gat.gat_aggregate_mh at nh 3, d h_e
    accumulated in bf16 in head order;
  * the step: train.block.block_window_forward(compute_dtype=bf16) against
    JAX's (fused=True, interpret mode, defer_loss, one prefix segment) with
    msg diff, and with msg concat and two stacked heads on JAX's own keep
    masks (one case, so that JAX compiles two steps); and the
    bf16 step against the f32 step, as tests/test_block_step.py:401-428
    holds JAX's;
  * the bf16 combinations this slice leaves out raise, naming 'bf16
    rectangles'.

Tolerances, from bf16's 8 significant bits: a value stored in bf16 may
round to the neighbouring bf16 value where its f32 sums come in another
order, so bf16 outputs agree within one bf16 ulp of the larger magnitude,
two where nh = 3 heads' rounded terms are added in bf16;
f32 outputs within rtol 1e-4 (atol 1e-6 x their scale); d w_hh, whose
product takes the rounded d gh, within atol 2^-8 x |he| |d gh| summed over
the cells (where one operand's rounding flips).  The step: loss within rtol
1e-3, gradients within rtol 1e-2 with an atol of 1e-3 x the largest |grad|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import bf16_ulp, gat_inputs, spread_weights
from trackmpnn_tpu.graph import schedule as jschedule
from trackmpnn_tpu.models import mpnn as jmpnn
from trackmpnn_tpu.ops import pallas_block, pallas_gat
from trackmpnn_tpu.train import block as jblock
from trackmpnn_tpu_torch.data.synthetic import make_sequence
from trackmpnn_tpu_torch.graph import schedule
from trackmpnn_tpu_torch.models import mpnn, weights
from trackmpnn_tpu_torch.ops import block as block_ops
from trackmpnn_tpu_torch.ops import gat
from trackmpnn_tpu_torch.train import block
from trackmpnn_tpu_torch.train.embed import EmbedTrainer

torch.set_num_threads(1)

BF16 = torch.bfloat16
F32_TOL = dict(rtol=1e-4)
TCAP, HIDDEN = 4, 8


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


def assert_bf16_close(got, want, name, ulps=1):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want)
    lim = ulps * bf16_ulp(torch.from_numpy(np.maximum(np.abs(got), np.abs(want)))).numpy()
    assert np.all(err <= lim), (name, float((err - lim).max()), int((err > lim).sum()))


def assert_f32_close(got, want, name, atol=None):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, atol=1e-6 * scale if atol is None else atol,
                               err_msg=name, **F32_TOL)


def to_np(t):
    return t.detach().float().numpy()


def jbf(a):
    return jnp.asarray(np.asarray(a, np.float32)).astype(jnp.bfloat16)


# ------------------------------------------------------------- #4 in bf16 ----
def round_case(seed):
    """tests/test_pallas_block.py::make_inputs at BT 5, na = nt = 8, H 8,
    with bf16 h_e, ga, gb; cotangents for every output (d edge_out bf16)."""
    rng = np.random.default_rng(seed)
    BT, na, nt, H = 5, 8, 8, 8
    he = rng.normal(size=(BT, na, nt, H)).astype(np.float32)
    ga = rng.normal(size=(BT, na, 3 * H)).astype(np.float32)
    gb = rng.normal(size=(BT, nt, 3 * H)).astype(np.float32)
    whh = (rng.normal(size=(H, 3 * H)) * 0.3).astype(np.float32)
    bhh = (rng.normal(size=(3 * H,)) * 0.1).astype(np.float32)
    web = (rng.normal(size=(H, 1)) * 0.4).astype(np.float32)
    blk_na, blk_nt = rng.integers(0, na + 1, size=BT), rng.integers(0, nt + 1, size=BT)
    m = ((np.arange(na)[None, :, None] < blk_na[:, None, None])
         & (np.arange(nt)[None, None, :] < blk_nt[:, None, None])).astype(np.float32)
    he = he * m[..., None]  # the carry's invariant: padding is 0
    cots = [rng.normal(size=s).astype(np.float32)
            for s in ((BT, na, nt, H), (BT, na, H), (BT, nt, H), (BT, na, nt))]
    # bf16 values exactly: both packages start from the same numbers
    he, ga, gb, cots[0] = (np.asarray(torch.from_numpy(a).bfloat16().float())
                           for a in (he, ga, gb, cots[0]))
    return [he, ga, gb, whh, bhh, web, m], cots


@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_bf16_round_and_its_vjp_match_pallas_interpret(sign):
    (he, ga, gb, whh, bhh, web, m), (geo, grs, gcs, glg) = round_case(int(sign > 0))
    f = lambda h, a, b, w, bh, we: pallas_block.fused_block_round(
        h, a, b, w, bh, we, jnp.asarray(m), sign, jnp.bfloat16, 4, True)
    want, pull = jax.vjp(f, jbf(he), jbf(ga), jbf(gb), *(jnp.asarray(x) for x in (whh, bhh, web)))
    want_b = pull((jbf(geo), *(jnp.asarray(c) for c in (grs, gcs, glg))))
    t = [torch.from_numpy(x).bfloat16() for x in (he, ga, gb)]
    t += [torch.from_numpy(x) for x in (whh, bhh, web, m)]
    got = block_ops.block_round_reference(*t, sign)
    assert got[0].dtype == BF16 and all(o.dtype == torch.float32 for o in got[1:])
    assert_bf16_close(to_np(got[0]), want[0], "edge_out")
    for g, w, name in zip(got[1:], want[1:], ["rs", "cs", "lg"]):
        assert_f32_close(to_np(g), w, name)
    cot = [torch.from_numpy(geo).bfloat16()] + [torch.from_numpy(c) for c in (grs, gcs, glg)]
    got_b = block_ops.block_round_backward_reference(*t, sign, *cot)
    assert [x.dtype for x in got_b] == [BF16] * 3 + [torch.float32] * 3
    for g, w, name in zip(got_b[:3], want_b[:3], ["dhe", "dga", "dgb"]):
        assert_bf16_close(to_np(g), w, name)
    # d w_hh's product takes d gh rounded to bf16: one flip moves a sum by
    # 2^-8 of one |he| |d gh| term
    dgh_scale = float(np.abs(np.asarray(want_b[1], np.float32)).max())
    assert_f32_close(to_np(got_b[3]), want_b[3], "dwhh",
                     atol=2.0 ** -8 * np.abs(he).max() * dgh_scale)
    for g, w, name in zip(got_b[4:], (np.asarray(want_b[4]), np.asarray(want_b[5])),
                          ["dbhh", "dweb"]):
        assert_f32_close(to_np(g).reshape(w.shape), w, name)
    # through the autograd Function, as the step calls it
    leaves = [x.clone().requires_grad_(i < 6) for i, x in enumerate(t)]
    outs = block_ops.fused_block_round(*leaves, sign)
    grads = torch.autograd.grad(outs, leaves[:6], cot)
    for a, b in zip(grads, got_b):
        assert a.dtype == b.dtype and torch.equal(a, b.reshape(a.shape))


# ------------------------------------------------------ #12 with bf16 h_e ----
def test_bf16_aggregate_and_its_vjp_match_pallas_interpret():
    """nh 3, real keep masks: rs, cs f32 from the upcast h_e; d h_e in bf16,
    the heads' rounded terms added in bf16 in head order."""
    x = gat_inputs(12, 3, keep=0.5)
    args, (grs, gcs) = x["agg"], x["agg_cot"]
    args[5] = np.asarray(torch.from_numpy(args[5]).bfloat16().float())
    f = lambda e, mr, mc, zr, zc, h: pallas_gat.gat_aggregate_mh(
        e, mr, mc, zr, zc, h, jnp.asarray(args[6]), jnp.asarray(args[7]), jnp.asarray(args[8]),
        0.5, 3, 4, True)
    jin = [jnp.asarray(a) for a in args[:5]] + [jbf(args[5])]
    want, pull = jax.vjp(f, *jin)
    want_b = pull((jnp.asarray(grs), jnp.asarray(gcs)))
    t = [torch.from_numpy(a) for a in args]
    t[5] = t[5].bfloat16()
    got = gat.gat_aggregate_reference(*t, 0.5)
    for g, w, name in zip(got, want, ["rs", "cs"]):
        assert g.dtype == torch.float32
        assert_f32_close(to_np(g), w, name)
    got_b = gat.gat_aggregate_backward_reference(*t, 0.5, torch.from_numpy(grs),
                                                 torch.from_numpy(gcs))
    for g, w, name in zip(got_b[:5], want_b[:5], ["de", "dmr", "dmc", "dzr", "dzc"]):
        assert_f32_close(to_np(g), w, name)
    assert got_b[5].dtype == BF16
    assert_bf16_close(to_np(got_b[5]), want_b[5], "dhe", ulps=2)
    # the order matters: summing the heads in f32 first rounds once
    f32_sum = gat.gat_aggregate_backward_reference(*t[:5], t[5].float(), *t[6:], 0.5,
                                                   torch.from_numpy(grs),
                                                   torch.from_numpy(gcs))[5]
    assert not torch.equal(f32_sum.bfloat16(), got_b[5])


# --------------------------------------------------------------- the step ----
def chunks(n, seed0):
    """n windows of 3-4 frames (3 tracks) for both packages."""
    out, s = [], seed0
    while len(out) < n:
        X, bp, _ = make_sequence(num_tracks=3, num_frames=3 + (s % 2), seed=s, miss_rate=0.15,
                                 fp_rate=0.2)
        y = bp[:, :2].astype(np.int64)
        if schedule.build_window_schedule(X, y) is not None:
            out.append((X, y))
        s += 1
    return out


def batches(seed0=0):
    cs = chunks(2, seed0)
    j = [jschedule.build_window_schedule(X, y, cap=128, t_cap=TCAP) for X, y in cs]
    t = [schedule.build_window_schedule(X, y, cap=128, t_cap=TCAP) for X, y in cs]
    return jblock.build_block_batch(j, TCAP), block.build_block_batch(t, TCAP, device="cpu")


def grads_of(params, cfg):
    return weights.map_shaped(lambda leaf, s, path: leaf.grad, params, weights.param_shapes(cfg))


def leaves_np(tree, cfg):
    flat = []
    weights.map_shaped(lambda leaf, s, path: flat.append((path, np.asarray(leaf))), tree,
                       weights.param_shapes(cfg))
    return flat


def jax_keep_masks(key, cfg, tbb):
    """JAX's stacked-route keep masks (block.py:448-453, drop key
    fold_in(fold_in(rng, s), bi)), drawn over one prefix segment's B*T
    blocks and cut to each round's live prefix."""
    B, T, na, nt = tbb.n_windows, tbb.t_cap, tbb.na_cap, tbb.nt_cap
    keep, nh = 1.0 - jmpnn.ATT_DROPOUT, cfg.nattheads
    out = []
    for s in range(T):
        drop = jax.random.fold_in(jax.random.fold_in(key, s), 0)
        out.append(tuple(torch.from_numpy(np.asarray(jax.random.bernoulli(
            jax.random.fold_in(drop, k), keep, (nh, B * T, na, nt)))[:, :(s + 1) * B]
            .astype(np.float32)) for k in (0, 1)))
    return out


STEP_CASES = {"diff": {}, "concat_heads": {"msg_type": "concat", "nattheads": 2}}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_bf16_step_matches_jax(monkeypatch, case):
    monkeypatch.setenv("TM_PREFIX_K", "1")
    kw = dict(features="2d", ncategories=3, nhidden=HIDDEN, **STEP_CASES[case])
    jcfg, cfg = jmpnn.ModelConfig(**kw), mpnn.ModelConfig(**kw)
    jbb, tbb = batches(seed0={"diff": 0, "concat_heads": 9}[case])
    p_np, s_np = spread_weights(cfg, 3)
    key = jax.random.key(7) if cfg.nattheads else None

    def f(p):
        return jblock.block_window_forward(p, s_np, jcfg, jbb, True, compute_dtype=jnp.bfloat16,
                                           fused=True, defer_loss=True, rng=key)

    (jl, jaux), jg = jax.value_and_grad(f, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, p_np))
    params, stats = weights.from_jax_params(p_np, s_np, cfg)
    params = block.trainable(params)
    keeps = jax_keep_masks(key, cfg, tbb) if cfg.nattheads else None
    if keeps is not None:
        assert 0 < float(keeps[-1][0].mean()) < 1
    tl, taux = block.block_window_forward(params, stats, cfg, tbb, True, att_keep=keeps,
                                          compute_dtype=BF16)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-3)
    for k in ("loss_ce", "loss_f"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-3, atol=1e-6)
    for k in ("tp", "fp", "fn"):
        assert int(taux[k]) == int(jaux[k]), k
    want = leaves_np(jg, cfg)
    scale = max(float(np.abs(b).max()) for _, b in want)
    for (path, a), (_, b) in zip(leaves_np(grads_of(params, cfg), cfg), want):
        np.testing.assert_allclose(a, b, rtol=1e-2, atol=1e-3 * scale, err_msg=path)


def test_bf16_step_tracks_the_f32_step():
    """Loss within 1e-2 relative and every gradient's direction (cosine >
    0.99), as tests/test_block_step.py holds JAX's bf16 step to its f32
    one; the bf16 step's round really ran in bf16."""
    cfg = mpnn.ModelConfig(features="2d", ncategories=3, nhidden=HIDDEN)
    _, tbb = batches(seed0=2)
    p_np, s_np = spread_weights(cfg, 4)
    out, seen = {}, []
    real = block_ops.FusedBlockRound.forward

    def spy(ctx, h_e, *rest):
        seen.append(h_e.dtype)
        return real(ctx, h_e, *rest)

    for dt in (None, BF16):
        params, stats = weights.from_jax_params(p_np, s_np, cfg)
        params = block.trainable(params)
        mp = pytest.MonkeyPatch()
        mp.setattr(block_ops.FusedBlockRound, "forward", staticmethod(spy))
        try:
            loss, _ = block.block_window_forward(params, stats, cfg, tbb, True, compute_dtype=dt)
        finally:
            mp.undo()
        loss.backward()
        out[dt] = (float(loss.detach()), [g for _, g in leaves_np(grads_of(params, cfg), cfg)])
    assert set(seen) == {torch.float32, BF16}
    (l32, g32), (l16, g16) = out[None], out[BF16]
    assert abs(l16 - l32) / abs(l32) < 1e-2, (l16, l32)
    for a, b in zip(g32, g16):
        a, b = a.ravel(), b.ravel()
        denom = np.linalg.norm(a) * np.linalg.norm(b)
        if denom > 1e-12:
            assert float(np.dot(a, b) / denom) > 0.99


@pytest.mark.parametrize("what", ["es_kernel", "fused_loss", "per_head", "embed"])
def test_left_out_bf16_combinations_raise_by_title(what):
    if what == "embed":
        with pytest.raises(NotImplementedError, match="'bf16 rectangles'"):
            EmbedTrainer(conv_dtype="bfloat16", device="cpu")
        return
    cfg = mpnn.ModelConfig(features="2d", ncategories=3, nhidden=HIDDEN,
                           nattheads=2 if what == "per_head" else 0)
    flags = {"es_kernel": dict(es_kernel=True), "fused_loss": dict(fused_loss=True),
             "per_head": dict(gat_fused=False)}[what]
    with pytest.raises(NotImplementedError, match="'bf16 rectangles'"):
        block.make_block_train_step(cfg, True, compute_dtype=BF16, **flags)
    _, tbb = batches()
    params = mpnn.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(NotImplementedError, match="'bf16 rectangles'"):
        block.block_window_forward(params, mpnn.init_batch_stats(cfg), cfg, tbb, True,
                                   generator=torch.Generator().manual_seed(0),
                                   compute_dtype=BF16, **flags)
    # the same combination in f32 runs
    block.make_block_train_step(cfg, True, **flags)
