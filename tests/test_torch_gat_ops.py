"""The port's attention ops (trackmpnn_tpu_torch/ops/gat.py) against the JAX
package's stacked-head Pallas kernels in interpret mode (as
tests/test_pallas_gat*.py runs them on the CPU), on the same numpy inputs.

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
from trackmpnn_tpu.ops import pallas_gat
from trackmpnn_tpu_torch.ops import gat

torch.set_num_threads(1)

ALPHA = 0.2
FWD = dict(rtol=0, atol=1e-5)
BWD = dict(rtol=1e-4, atol=1e-5)


def close(got, want, tol, names):
    for a, b, name in zip(got, want, names):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), err_msg=name, **tol)


@pytest.mark.parametrize("nh", [1, 3])
def test_scores_stats_match_pallas_interpret(nh):
    """Forward outputs and the VJP of gat_scores_stats_mh; rmax and cmax
    take no gradient on either side (block.py:428-429)."""
    x = gat_inputs(nh, nh)
    (ha, hn, a, m), (ge, gsal, gsbl) = x["scores"], x["scores_cot"]
    f = lambda x, y, w: pallas_gat.gat_scores_stats_mh(x, y, w, jnp.asarray(m), ALPHA, nh, 4,
                                                       True)
    want, pull = jax.vjp(f, jnp.asarray(ha), jnp.asarray(hn), jnp.asarray(a))
    zeros = [jnp.zeros_like(want[1]), jnp.zeros_like(want[2])]
    want_b = pull((jnp.asarray(ge), *zeros, jnp.asarray(gsal), jnp.asarray(gsbl)))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (ha, hn, a)]
    got = gat.gat_scores_stats(*leaves, torch.from_numpy(m), ALPHA, nh)
    close(got, want, FWD, ["e", "rmax", "cmax", "sa_l", "sb_l"])
    assert not got[1].requires_grad and not got[2].requires_grad
    got_b = torch.autograd.grad([got[0], got[3], got[4]], leaves,
                                [torch.from_numpy(c) for c in (ge, gsal, gsbl)])
    close(got_b, want_b, BWD, ["dha", "dhn", "da"])
    # the empty block: masked max, zero sums, no NaN
    assert np.all(got[1][:, 0].numpy() == np.float32(gat.NEG_SCORE))
    assert np.all(got[3][:, 0].detach().numpy() == 0)
    assert all(torch.isfinite(g).all() for g in got_b)


AGG_CASES = [(1, 1.0, 1), (3, 1.0, 1), (1, 0.5, 1), (3, 0.5, 3), (3, 0.5, 1)]


@pytest.mark.parametrize("nh,keep,mask_heads", AGG_CASES)
def test_aggregate_matches_pallas_interpret(nh, keep, mask_heads):
    """Forward and the VJP of gat_aggregate_mh with shared keep masks,
    including a one-head mask that broadcasts over the heads."""
    x = gat_inputs(10 * nh + mask_heads, nh, keep, mask_heads)
    args, (g_rs, g_cs) = x["agg"], x["agg_cot"]
    m, ka, kn = (jnp.asarray(x) for x in args[6:])
    f = lambda *d: pallas_gat.gat_aggregate_mh(*d, m, ka, kn, keep, nh, 4, True)
    want, pull = jax.vjp(f, *(jnp.asarray(x) for x in args[:6]))
    want_b = pull((jnp.asarray(g_rs), jnp.asarray(g_cs)))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in args[:6]]
    got = gat.gat_aggregate(*leaves, *(torch.from_numpy(x) for x in args[6:]), keep)
    close(got, want, FWD, ["rs", "cs"])
    got_b = torch.autograd.grad(got, leaves, [torch.from_numpy(g_rs), torch.from_numpy(g_cs)])
    close(got_b, want_b, BWD, ["de", "dm_row", "dm_col", "dz_row", "dz_col", "dhe"])
    # rows and columns whose cells are all masked give exactly 0
    live = args[6] > 0
    assert np.all(got[0].detach().numpy()[~live.any(2)] == 0)
    assert np.all(got[1].detach().numpy()[~live.any(1)] == 0)


@pytest.mark.parametrize("nh", [1, 3])
def test_scores_hand_backward_matches_autograd(nh):
    """gat_scores_stats_backward_reference == autograd of the plain forward
    (f64), with the max as a constant."""
    x = gat_inputs(20 + nh, nh)
    (ha, hn, a, m), cots = x["scores"], x["scores_cot"]
    leaves = [torch.from_numpy(x).double().requires_grad_(True) for x in (ha, hn, a)]
    mask, cot = torch.from_numpy(m).double(), [torch.from_numpy(c).double() for c in cots]
    e, _, _, sal, sbl = gat.gat_scores_stats_reference(*leaves, mask, ALPHA, nh)
    want = torch.autograd.grad([e, sal, sbl], leaves, cot)
    got = gat.gat_scores_stats_backward_reference(*(t.detach() for t in leaves), mask, ALPHA,
                                                  nh, *cot)
    for g, w, name in zip(got, want, ["dha", "dhn", "da"]):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10, msg=name)


@pytest.mark.parametrize("nh,keep", [(1, 1.0), (3, 0.5)])
def test_aggregate_hand_backward_matches_autograd(nh, keep):
    x = gat_inputs(30 + nh, nh, keep)
    args, cots = x["agg"], x["agg_cot"]
    t = [torch.from_numpy(x).double() for x in args]
    leaves = [x.requires_grad_(True) for x in t[:6]]
    cot = [torch.from_numpy(c).double() for c in cots]
    want = torch.autograd.grad(gat.gat_aggregate_reference(*leaves, *t[6:], keep), leaves, cot)
    got = gat.gat_aggregate_backward_reference(*(x.detach() for x in leaves), *t[6:], keep, *cot)
    for g, w, name in zip(got, want, ["de", "dm_row", "dm_col", "dz_row", "dz_col", "dhe"]):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10, msg=name)
