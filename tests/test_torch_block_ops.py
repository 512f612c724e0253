"""The port's block-step ops (trackmpnn_tpu_torch/ops/block.py) against the
JAX package's Pallas kernels in interpret mode (as tests/test_pallas_block.py
runs them on the CPU) and its plain references, on the same numpy inputs.

Tolerances are those of tests/test_pallas_block.py: forward atol 1e-6
(the same f32 arithmetic in another order), gradients rtol 2e-4 and atol
2e-5 (the backward sums over cells in another order).  On the CPU every op
runs its plain version; tests/test_torch_cuda.py holds the kernels against
these on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackmpnn_tpu.ops import pallas_block
from trackmpnn_tpu_torch.ops import block

torch.set_num_threads(1)

GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
NAMES = ["dhe", "dga", "dgb", "dwhh", "dbhh", "dweb"]


def round_inputs(seed, P=7, na=8, nt=8, H=8):
    """Round inputs with a rectangular live part per block; padded cells of
    h_e are 0 (the carry invariant) and padded rows of ga/gb are not."""
    rng = np.random.default_rng(seed)
    blk_na = rng.integers(0, na + 1, size=P)
    blk_nt = rng.integers(0, nt + 1, size=P)
    m = ((np.arange(na)[None, :, None] < blk_na[:, None, None])
         & (np.arange(nt)[None, None, :] < blk_nt[:, None, None])).astype(np.float32)
    arrays = [rng.normal(size=(P, na, nt, H)) * m[..., None],
              rng.normal(size=(P, na, 3 * H)), rng.normal(size=(P, nt, 3 * H)),
              rng.normal(size=(H, 3 * H)) * 0.3, rng.normal(size=(3 * H,)) * 0.1,
              rng.normal(size=(H, 1)) * 0.4, m]
    cots = [rng.normal(size=(P, na, nt, H)), rng.normal(size=(P, na, H)),
            rng.normal(size=(P, nt, H)), rng.normal(size=(P, na, nt))]
    f32 = lambda a: np.asarray(a, np.float32)
    return [f32(a) for a in arrays], [f32(a) for a in cots]


def jax_vjp(fn, args, cots, sign):
    j = [jnp.asarray(a) for a in args]
    out, pull = jax.vjp(lambda *d: fn(*d, j[6], sign), *j[:6])
    return out, pull(tuple(jnp.asarray(c) for c in cots))


@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_round_matches_pallas_interpret_and_reference(sign):
    args, cots = round_inputs(0)
    pallas = lambda *a: pallas_block.fused_block_round(*a, None, 4, True)
    reference = lambda *a: pallas_block.reference_block_round(*a, None)
    t_args = [torch.from_numpy(a) for a in args]
    got = block.block_round_reference(*t_args, sign)
    got_b = block.block_round_backward_reference(*t_args, sign,
                                                 *(torch.from_numpy(c) for c in cots))
    for fn in (pallas, reference):
        want, want_b = jax_vjp(fn, args, cots, sign)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
        for a, b, name in zip(got_b, want_b, NAMES):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **GRAD_TOL)
    m = args[-1]
    assert np.all(got[0].numpy()[m == 0] == 0) and np.all(got[3].numpy()[m == 0] == 0)


@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_hand_written_backward_matches_autograd(sign):
    """FusedBlockRound's backward (the hand-derived one) == autograd through
    the plain forward, for every input that takes a gradient."""
    args, cots = round_inputs(1, P=5, na=6, nt=7, H=8)
    leaves = [torch.from_numpy(a).double().requires_grad_(i < 6) for i, a in enumerate(args)]
    cot = [torch.from_numpy(c).double() for c in cots]
    outs = block.block_round_reference(*leaves, sign)
    want = torch.autograd.grad(outs, leaves[:6], cot)
    got = block.block_round_backward_reference(*(t.detach() for t in leaves), sign, *cot)
    for a, b, name in zip(got, want, NAMES):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10, msg=name)
    # through the autograd Function, as the train step calls it
    f_leaves = [t.detach().float().requires_grad_(i < 6) for i, t in enumerate(leaves)]
    outs = block.fused_block_round(*f_leaves, sign)
    grads = torch.autograd.grad(outs, f_leaves[:6], [c.float() for c in cot])
    for a, b, name in zip(grads, want, NAMES):
        torch.testing.assert_close(a.double(), b, rtol=1e-4, atol=1e-5, msg=name)


def scatter_problem(seed, P=10, n=6, F=12, B=3, capD=16):
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(P, n, F)).astype(np.float32)
    idx = rng.integers(0, capD, (P, n)).astype(np.int32)  # duplicates included
    return vals, idx, B, capD


def test_window_scatter_matches_pallas_interpret_and_its_vjp():
    vals, idx, B, capD = scatter_problem(2)
    g = np.random.default_rng(3).normal(size=(B * capD, vals.shape[2])).astype(np.float32)
    f = lambda v: pallas_block.window_scatter(v, jnp.asarray(idx, jnp.float32), B, capD, 4, True)
    want, pull = jax.vjp(f, jnp.asarray(vals))
    v = torch.from_numpy(vals).requires_grad_(True)
    got = block.window_scatter(v, torch.from_numpy(idx), B, capD)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    (dv,) = torch.autograd.grad(got, v, torch.from_numpy(g))
    np.testing.assert_array_equal(dv.numpy(), np.asarray(pull(jnp.asarray(g))[0]))


def test_window_gather2_matches_pallas_and_its_vjp():
    """Forward a plain gather; the backward scatters both cotangents.  With
    one tensor passed as both ga_d and gb_d (msg 'diff') autograd sums them,
    as JAX does for the shared operand."""
    rng = np.random.default_rng(4)
    B, capD, P, na, nt, F = 2, 8, 6, 4, 5, 9
    gd = rng.normal(size=(B * capD, F)).astype(np.float32)
    act = rng.integers(0, capD, (P, na)).astype(np.int32)
    new = rng.integers(0, capD, (P, nt)).astype(np.int32)
    cga = rng.normal(size=(P, na, F)).astype(np.float32)
    cgb = rng.normal(size=(P, nt, F)).astype(np.float32)
    f = lambda d: pallas_block.window_gather2(d, d, jnp.asarray(act, jnp.float32),
                                              jnp.asarray(new, jnp.float32), B, capD, 4, True)
    (wa, wb), pull = jax.vjp(f, jnp.asarray(gd))
    d = torch.from_numpy(gd).requires_grad_(True)
    ga, gb = block.window_gather2(d, d, torch.from_numpy(act), torch.from_numpy(new), B, capD)
    np.testing.assert_array_equal(ga.detach().numpy(), np.asarray(wa))
    np.testing.assert_array_equal(gb.detach().numpy(), np.asarray(wb))
    (dd,) = torch.autograd.grad((ga, gb), d, (torch.from_numpy(cga), torch.from_numpy(cgb)))
    np.testing.assert_allclose(dd.numpy(), np.asarray(pull((jnp.asarray(cga),
                                                            jnp.asarray(cgb)))[0]),
                               rtol=0, atol=1e-5)


def test_padded_positions_scatter_zeros():
    """The window scatter does not mask (pallas_block.py:458-461): the round's
    rs/cs and its d ga/d gb are exactly 0 at padded rows and columns, even
    where ga/gb hold values there and the padded ids point at real
    detections.  So the unmasked scatter equals the masked segment sum."""
    args, cots = round_inputs(5, P=9, na=8, nt=8, H=8)
    t = [torch.from_numpy(a) for a in args]
    m = t[6]
    row_live, col_live = m.amax(2) > 0, m.amax(1) > 0
    _, rs, cs, _ = block.block_round_reference(*t, -1.0)
    _, dga, dgb, *_ = block.block_round_backward_reference(*t, -1.0,
                                                           *(torch.from_numpy(c) for c in cots))
    assert torch.all(rs[~row_live] == 0) and torch.all(cs[~col_live] == 0)
    assert torch.all(dga[~row_live] == 0) and torch.all(dgb[~col_live] == 0)
    assert rs[row_live].abs().min() > 0 and dga[row_live].abs().amax(-1).min() > 0
    B, capD = 3, 8
    idx = torch.zeros(9, 16, dtype=torch.int32)  # padding points at detection 0
    rng = np.random.default_rng(6)
    for p in range(9):
        idx[p, :8][row_live[p]] = torch.from_numpy(rng.permutation(capD)[:int(row_live[p].sum())]
                                                   .astype(np.int32))
    vals = torch.cat([rs, -cs], 1)
    live = torch.cat([row_live, col_live], 1)
    masked = torch.zeros(B * capD, 8).index_add_(
        0, block.global_idx(idx, B, capD)[live], vals[live])
    torch.testing.assert_close(block.window_scatter(vals, idx, B, capD), masked,
                               rtol=0, atol=1e-6)
