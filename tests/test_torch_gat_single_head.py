"""The port's single-head attention ops (ops/gat.py::gat_scores_stats_1h and
gat_aggregate_1h, for kernels #9 and #10) and its per-head attention route
(train/block.py::_block_gat_support_per_head, gat_fused=False) against the
JAX package: the ops against pallas_gat.gat_scores_stats / gat_aggregate in
interpret mode (as tests/test_pallas_gat.py runs them on the CPU), the route
against JAX's per-head _block_gat_support loop on JAX's own dropout masks,
and the route against the port's stacked route on shared masks.

Tolerances: forward atol 1e-5 (the same f32 arithmetic in another order);
gradients rtol 1e-4, atol 1e-5 (sums over cells in another order).  On the
CPU every op runs its plain version; tests/test_torch_cuda.py holds the
kernels against these on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import gat_inputs
from trackmpnn_tpu.models import mpnn as jmpnn
from trackmpnn_tpu.ops import pallas_gat
from trackmpnn_tpu.train import block as jblock
from trackmpnn_tpu_torch.ops import gat
from trackmpnn_tpu_torch.train import block

torch.set_num_threads(1)

ALPHA = 0.2
FWD = dict(rtol=0, atol=1e-5)
BWD = dict(rtol=1e-4, atol=1e-5)
NH, H = 3, 8


def close(got, want, tol, names):
    for a, b, name in zip(got, want, names):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), err_msg=name, **tol)


def one_head(x):
    """gat_inputs at nh = 1 without the head axis."""
    e, mr, mc, zr, zc, he, m, ka, kn = x["agg"]
    return {"scores": x["scores"], "scores_cot": [c[0] for c in x["scores_cot"]],
            "agg": [e[0], mr[0], mc[0], zr[0], zc[0], he, m, ka[0], kn[0]],
            "agg_cot": x["agg_cot"]}


def test_scores_stats_1h_match_pallas_interpret():
    """Forward outputs and the VJP of gat_scores_stats (#9); rmax and cmax
    take no gradient on either side (pallas_gat.py:266)."""
    x = one_head(gat_inputs(41, 1))
    (ha, hn, a, m), (ge, gsal, gsbl) = x["scores"], x["scores_cot"]
    f = lambda x, y, w: pallas_gat.gat_scores_stats(x, y, w, jnp.asarray(m), ALPHA, 4, True)
    want, pull = jax.vjp(f, jnp.asarray(ha), jnp.asarray(hn), jnp.asarray(a))
    zeros = [jnp.zeros_like(want[1]), jnp.zeros_like(want[2])]
    want_b = pull((jnp.asarray(ge), *zeros, jnp.asarray(gsal), jnp.asarray(gsbl)))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (ha, hn, a)]
    got = gat.gat_scores_stats_1h(*leaves, torch.from_numpy(m), ALPHA)
    assert got[0].shape == m.shape and got[1].shape == m.shape[:2]
    close(got, want, FWD, ["e", "rmax", "cmax", "sa_l", "sb_l"])
    assert not got[1].requires_grad and not got[2].requires_grad
    got_b = torch.autograd.grad([got[0], got[3], got[4]], leaves,
                                [torch.from_numpy(c) for c in (ge, gsal, gsbl)])
    close(got_b, want_b, BWD, ["dha", "dhn", "da"])
    # the empty block: masked max, zero sums, no NaN
    assert np.all(got[1][0].numpy() == np.float32(gat.NEG_SCORE))
    assert np.all(got[3][0].detach().numpy() == 0)


@pytest.mark.parametrize("keep", [1.0, 0.5])
def test_aggregate_1h_matches_pallas_interpret(keep):
    """Forward and the VJP of gat_aggregate (#10) with shared keep masks
    (at keep 1 they are the cell mask, as the callers pass them)."""
    x = one_head(gat_inputs(43, 1, keep))
    args, (g_rs, g_cs) = x["agg"], x["agg_cot"]
    m, ka, kn = (jnp.asarray(a) for a in args[6:])
    f = lambda *d: pallas_gat.gat_aggregate(*d, m, ka, kn, keep, 4, True)
    want, pull = jax.vjp(f, *(jnp.asarray(a) for a in args[:6]))
    want_b = pull((jnp.asarray(g_rs), jnp.asarray(g_cs)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args[:6]]
    got = gat.gat_aggregate_1h(*leaves, *(torch.from_numpy(a) for a in args[6:]), keep)
    close(got, want, FWD, ["rs", "cs"])
    got_b = torch.autograd.grad(got, leaves, [torch.from_numpy(g_rs), torch.from_numpy(g_cs)])
    close(got_b, want_b, BWD, ["de", "dm_row", "dm_col", "dz_row", "dz_col", "dhe"])
    live = args[6] > 0
    assert np.all(got[0].detach().numpy()[~live.any(2)] == 0)
    assert np.all(got[1].detach().numpy()[~live.any(1)] == 0)


def support_case(seed, B=2, capD=16, P=4, na=5, nt=6):
    """A small block layout (block 3 without new detections), detection and
    edge hiddens, NH heads' weights, a cotangent of es, and JAX's keep
    masks of its per-head loop (block.py:475-478), stacked [NH, P, na, nt]."""
    rng = np.random.default_rng(seed)
    blk_na, blk_nt = rng.integers(1, na + 1, P), rng.integers(1, nt + 1, P)
    blk_nt[3] = 0
    row_live = np.arange(na)[None] < blk_na[:, None]
    col_live = (np.arange(nt)[None] < blk_nt[:, None]) & (blk_nt[:, None] > 0)
    em3 = row_live[:, :, None] & col_live[:, None, :]
    win = (np.arange(P) % B)[:, None] * capD
    act_l = np.where(row_live, rng.integers(0, capD, (P, na)), 0).astype(np.int32)
    new_l = np.where(col_live, rng.integers(0, capD, (P, nt)), 0).astype(np.int32)
    h_d = rng.normal(size=(B * capD, H)).astype(np.float32)
    h_e = (rng.normal(size=(P, na, nt, H)) * em3[..., None]).astype(np.float32)
    gp = [{"W_att": rng.normal(size=(H, H)).astype(np.float32) * 0.3,
           "a": rng.normal(size=(H, 1)).astype(np.float32) * 0.3} for _ in range(NH)]
    drop = jax.random.key(seed)
    keep = 1.0 - jmpnn.ATT_DROPOUT
    masks = [np.stack([np.asarray(jax.random.bernoulli(jax.random.fold_in(drop, 2 * h + k),
                                                       keep, em3.shape))
                       for h in range(NH)]).astype(np.float32) for k in (0, 1)]
    return dict(B=B, capD=capD, act=win + act_l, new=win + new_l, act_l=act_l, new_l=new_l,
                row_live=row_live, col_live=col_live, em3=em3, h_d=h_d, h_e=h_e, gp=gp,
                drop=drop, masks=masks, cot=rng.normal(size=(B * capD, H)).astype(np.float32))


def port_support(c, route, masks):
    """es of the port's route on case c, and its leaves (W_att, a of every
    head, h_d, h_e)."""
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    gp = [{k: t(v).requires_grad_(True) for k, v in hp.items()} for hp in c["gp"]]
    td, te = t(c["h_d"]).requires_grad_(True), t(c["h_e"]).requires_grad_(True)
    es = route(gp, td, te, t(c["act"]).long(), t(c["new"]).long(), t(c["act_l"]), t(c["new_l"]),
               t(c["em3"].astype(np.float32)), t(c["row_live"]), t(c["col_live"]), c["B"],
               c["capD"], att_keep=None if masks is None else tuple(t(m) for m in masks))
    return es, [gp[h][k] for h in range(NH) for k in ("W_att", "a")] + [td, te]


@pytest.mark.parametrize("train", [True, False])
def test_per_head_route_matches_jax_per_head_loop(train):
    """_block_gat_support_per_head against JAX's _block_gat_support
    (fused=False) on JAX's own keep masks (train: dropout at ATT_DROPOUT;
    eval: none): es and its gradients in W_att, a, the detection and edge
    hiddens."""
    c = support_case(11 if train else 12)
    seg = np.concatenate([c["act"].reshape(-1), c["new"].reshape(-1)])
    vm = np.concatenate([c["row_live"].reshape(-1), c["col_live"].reshape(-1)])

    def f(gp, h_d, h_e):
        return jblock._block_gat_support(gp, h_d, h_e, jnp.asarray(c["act"]),
                                         jnp.asarray(c["new"]), jnp.asarray(c["em3"]),
                                         jnp.asarray(seg), jnp.asarray(vm), c["B"] * c["capD"],
                                         c["drop"], train, fused=False)

    want, pull = jax.vjp(jax.jit(f), jax.tree_util.tree_map(jnp.asarray, c["gp"]),
                         jnp.asarray(c["h_d"]), jnp.asarray(c["h_e"]))
    wg, wd, we = jax.jit(pull)(jnp.asarray(c["cot"]))
    got, leaves = port_support(c, block._block_gat_support_per_head,
                               c["masks"] if train else None)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(c["cot"]))
    wants = [wg[h][k] for h in range(NH) for k in ("W_att", "a")] + [wd, we]
    for a, b in zip(grads, wants):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)


def test_per_head_route_matches_the_stacked_route():
    """With dropout on, the per-head route and the stacked route
    (_block_gat_support) on the same [NH, P, na, nt] keep masks: the same es
    and gradients."""
    c = support_case(13)
    assert 0 < c["masks"][0].mean() < 1
    per_head, lp = port_support(c, block._block_gat_support_per_head, c["masks"])
    stacked, ls = port_support(c, block._block_gat_support, c["masks"])
    torch.testing.assert_close(per_head, stacked, rtol=0, atol=1e-5)
    cot = torch.from_numpy(c["cot"])
    for a, b in zip(torch.autograd.grad(per_head, lp, cot), torch.autograd.grad(stacked, ls, cot)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
