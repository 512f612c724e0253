"""The port's es round (trackmpnn_tpu_torch/ops/block.py::fused_block_round_es,
its plain forward and hand-written backward, and the detection incidence)
against the JAX package's fused_block_round_es in interpret mode and its
VJP, on the same numpy-made inputs.

Forward within atol 1e-5 (sums in another order), backward within rtol 1e-4
and atol 1e-5, as tests/test_torch_block_ops.py holds fused_block_round.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import es_inputs
from trackmpnn_tpu.ops import pallas_block as pb
from trackmpnn_tpu_torch.ops import block

torch.set_num_threads(1)

B, T, CAPD, NA, NT, H = 3, 3, 16, 5, 6, 8


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


def torch_args(act, new, blk_na, blk_nt, w, sign, P):
    t = torch.from_numpy
    inc = block.block_incidence(act, new, blk_na, blk_nt, B * CAPD)
    act_l = t((act % CAPD).astype(np.int32))[:P]
    new_l = t((new % CAPD).astype(np.int32))[:P]
    ga_d = t(w["ga_d"])
    gb_d = ga_d if w["gb_d"] is w["ga_d"] else t(w["gb_d"])
    return (t(w["h_e"][:P]), act_l, new_l, ga_d, gb_d, t(w["b_ih"]), t(w["w_hh"]),
            t(w["b_hh"]), t(w["w_eb"]), t(w["mask3"][:P]), sign, B, CAPD,
            t(inc[0]), t(inc[1]))


def jax_round(act, new, w, sign, P):
    act_l = jnp.asarray((act % CAPD)[:P].astype(np.float32))
    new_l = jnp.asarray((new % CAPD)[:P].astype(np.float32))
    shared = w["gb_d"] is w["ga_d"]

    def f(h_e, ga_d, gb_d, b_ih, w_hh, b_hh, w_eb):
        return pb.fused_block_round_es(h_e, act_l, new_l, ga_d, ga_d if shared else gb_d, b_ih,
                                       w_hh, b_hh, w_eb, jnp.asarray(w["mask3"][:P]), sign,
                                       None, B, CAPD, 4, True)

    primals = [jnp.asarray(w[k][:P] if k == "h_e" else w[k])
               for k in ("h_e", "ga_d", "gb_d", "b_ih", "w_hh", "b_hh", "w_eb")]
    return jax.vjp(f, *primals)


@pytest.mark.parametrize("sign,P", [(-1.0, B * T), (1.0, B * T), (-1.0, 2 * B)])
def test_es_round_matches_jax(sign, P):
    """Forward (edge_out, lg, es) and the hand-written backward against the
    interpret-mode kernel and jax.vjp; at P < B*T the round reads each
    detection's incidence only up to its first block >= P."""
    act, new, blk_na, blk_nt, w, cot = es_inputs(int(P + 3 * sign), sign)
    args = torch_args(act, new, blk_na, blk_nt, w, sign, P)
    got = block.block_round_es_reference(*args)
    want, vjp = jax_round(act, new, w, sign, P)
    for name, a, b in zip(("edge_out", "lg", "es"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5, err_msg=name)

    g = (cot["g_eo"][:P], cot["g_lg"][:P], cot["g_es"])
    mine = block.block_round_es_backward_reference(*args, *(torch.from_numpy(x) for x in g))
    theirs = vjp(tuple(jnp.asarray(x) for x in g))
    names = ["h_e", "ga_d", "gb_d", "b_ih", "w_hh", "b_hh", "w_eb"]
    mine, theirs = [x.numpy() for x in mine], list(theirs)
    if sign < 0:  # one tensor for both sides: JAX sums the two cotangents
        mine[1] = mine[1] + mine.pop(2)
        names.pop(2), theirs.pop(2)
    for name, a, b in zip(names, mine, theirs):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5, err_msg=name)


def test_es_equals_the_round_and_the_window_scatter():
    """The incidence-walked es == the default composition's plain versions:
    block_round_reference's row and column sums through window_scatter."""
    act, new, blk_na, blk_nt, w, _ = es_inputs(11, -1.0)
    for P in (B, 2 * B, B * T):
        args = torch_args(act, new, blk_na, blk_nt, w, -1.0, P)
        h_e, act_l, new_l, ga_d, gb_d, b_ih, w_hh, b_hh, w_eb, mask3 = args[:10]
        eo, lg, es = block.block_round_es_reference(*args)
        ga, gb = block.window_gather2_reference(ga_d, gb_d, act_l, new_l, B, CAPD)
        eo2, rs, cs, lg2 = block.block_round_reference(h_e, ga + b_ih, gb, w_hh, b_hh, w_eb,
                                                       mask3, -1.0)
        es2 = block.window_scatter_reference(torch.cat([rs, -cs], 1),
                                             torch.cat([act_l, new_l], 1), B, CAPD)
        assert torch.equal(eo, eo2) and torch.equal(lg, lg2)
        torch.testing.assert_close(es, es2, rtol=0, atol=1e-6)


def test_es_autograd_function_matches_its_plain_backward():
    """FusedBlockRoundEs on CPU tensors: autograd's gradients (the two gate
    cotangents summed into the one tensor) equal the plain backward."""
    act, new, blk_na, blk_nt, w, cot = es_inputs(5, -1.0)
    args = list(torch_args(act, new, blk_na, blk_nt, w, -1.0, B * T))
    leaves = [args[i].clone().requires_grad_(True) for i in (0, 3, 5, 6, 7, 8)]
    he, gad, bih, whh, bhh, web = leaves
    inc = (args[13], args[14])
    eo, lg, es = block.fused_block_round_es(he, args[1], args[2], gad, gad, bih, whh, bhh, web,
                                            args[9], -1.0, B, CAPD, inc)
    g = [torch.from_numpy(cot[k]) for k in ("g_eo", "g_lg", "g_es")]
    ((eo * g[0]).sum() + (lg * g[1]).sum() + (es * g[2]).sum()).backward()
    want = block.block_round_es_backward_reference(*args, *g)
    want = [want[0], want[1] + want[2], *want[3:]]
    for leaf, wv in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, wv, rtol=1e-5, atol=1e-6)


def test_block_incidence_lists_each_rows_and_columns_slots():
    """Each detection's slots, increasing: its rows (q*(na+nt) + i) and
    columns (q*(na+nt) + na + j) of blocks with cells, nothing else."""
    act, new, blk_na, blk_nt, _, _ = es_inputs(2, -1.0)
    ptr, slot = block.block_incidence(act, new, blk_na, blk_nt, B * CAPD)
    want = {d: [] for d in range(B * CAPD)}
    for q in range(B * T):
        if blk_na[q] == 0 or blk_nt[q] == 0:
            continue
        for i in range(blk_na[q]):
            want[act[q, i]].append(q * (NA + NT) + i)
        for j in range(blk_nt[q]):
            want[new[q, j]].append(q * (NA + NT) + NA + j)
    for d in range(B * CAPD):
        assert list(slot[ptr[d]:ptr[d + 1]]) == sorted(want[d]), d
    with pytest.raises(ValueError, match="outside"):
        block.block_incidence(act, new, blk_na, blk_nt, CAPD)
