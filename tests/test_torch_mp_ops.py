"""The port's message-passing ops (trackmpnn_tpu_torch/ops/mp.py) against
the JAX package's Pallas kernels, run in interpret mode on the CPU as
tests/test_pallas_kernels.py runs them.  Same numpy inputs on both sides.

Tolerances: gather_diff is one f32 subtraction per element, so it must be
exact.  signed_segment_sum sums in another order than the Pallas loop:
atol 1e-5 (inputs are O(1), at most a few dozen terms per row).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackmpnn_tpu.ops import pallas_mp
from trackmpnn_tpu_torch.ops import mp

torch.set_num_threads(1)


def make_problem(seed, n, h):
    rng = np.random.default_rng(seed)
    hid = rng.normal(size=(n, h)).astype(np.float32)
    past = rng.integers(0, n, n).astype(np.int32)
    fut = rng.integers(0, n, n).astype(np.int32)
    edge = rng.random(n) > 0.5
    return hid, past, fut, edge


def as_torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("seed,n,h", [(0, 128, 32), (1, 256, 64)])
def test_gather_diff_matches_pallas(seed, n, h):
    hid, past, fut, edge = make_problem(seed, n, h)
    want = pallas_mp.gather_diff_pallas(*map(jnp.asarray, (hid, past, fut, edge)),
                                        interpret=True, tile=64)
    got = mp.gather_diff(*as_torch(hid, past, fut, edge))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(mp.gather_diff_reference(*as_torch(hid, past, fut, edge)).numpy(),
                          np.asarray(want))


@pytest.mark.parametrize("seed,n,h", [(0, 128, 32), (1, 256, 64)])
def test_signed_segment_sum_matches_pallas(seed, n, h):
    hid, past, fut, edge = make_problem(seed, n, h)
    want = pallas_mp.signed_segment_sum_pallas(*map(jnp.asarray, (hid, past, fut, edge)),
                                               n, interpret=True, tile=64)
    got = mp.signed_segment_sum(*as_torch(hid, past, fut, edge), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_uint8_mask_matches_bool_mask():
    hid, past, fut, edge = make_problem(2, 64, 16)
    t = as_torch(hid, past, fut)
    for op, extra in ((mp.gather_diff, ()), (mp.signed_segment_sum, (64,))):
        a = op(*t, torch.from_numpy(edge), *extra)
        b = op(*t, torch.from_numpy(edge.astype(np.uint8)), *extra)
        assert torch.equal(a, b)


def test_cpu_wrappers_leave_launch_counters_alone(monkeypatch):
    monkeypatch.setattr(mp, "LAUNCHES", {"gather_diff": 0, "signed_segment_sum": 0})
    hid, past, fut, edge = as_torch(*make_problem(3, 64, 16))
    mp.gather_diff(hid, past, fut, edge)
    mp.signed_segment_sum(hid, past, fut, edge, 64)
    assert mp.LAUNCHES == {"gather_diff": 0, "signed_segment_sum": 0}


def test_unknown_device_raises():
    hid, past, fut, edge = as_torch(*make_problem(4, 8, 4))
    with pytest.raises(ValueError):
        mp.gather_diff(hid.to("meta"), past.to("meta"), fut.to("meta"), edge.to("meta"))



@pytest.mark.parametrize("seed,n,h", [(5, 128, 32), (6, 256, 64)])
def test_autograd_matches_jax_grad(seed, n, h):
    """Each op's VJP is the other op (pallas_mp.py:233-284): the port's
    gradients of both, on the CPU's plain versions, against jax.grad of
    pallas_mp.gather_diff and pallas_mp.signed_segment_sum.  d gather_diff
    is a signed sum (atol 1e-5, as above); d signed_segment_sum a gather
    (exact)."""
    import jax

    hid, past, fut, edge = make_problem(seed, n, h)
    cot = np.random.default_rng(seed + 1).normal(size=(n, h)).astype(np.float32)
    jp, jf, je = map(jnp.asarray, (past, fut, edge))
    want_gd = jax.grad(lambda x: jnp.sum(pallas_mp.gather_diff(x, jp, jf, je) * cot))(
        jnp.asarray(hid))
    want_ss = jax.grad(lambda x: jnp.sum(pallas_mp.signed_segment_sum(x, jp, jf, je, n) * cot))(
        jnp.asarray(hid))
    x = torch.from_numpy(hid).requires_grad_(True)
    tp, tf, te = as_torch(past, fut, edge)
    (g_gd,) = torch.autograd.grad((mp.gather_diff(x, tp, tf, te) * torch.from_numpy(cot)).sum(),
                                  x)
    (g_ss,) = torch.autograd.grad(
        (mp.signed_segment_sum(x, tp, tf, te, n) * torch.from_numpy(cot)).sum(), x)
    np.testing.assert_allclose(g_gd.numpy(), np.asarray(want_gd), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(g_ss.numpy(), np.asarray(want_ss))
    assert np.abs(g_gd.numpy()).max() > 0 and np.abs(g_ss.numpy()).max() > 0


def test_signed_segment_sum_refuses_a_gradient_for_n_other_than_rows():
    """The backward gathers the cotangent by edge row, which the kernel
    does only for n == N: the op raises for another n when a gradient is
    wanted, on the CPU as on the card, and runs without one."""
    hid, past, fut, edge = as_torch(*make_problem(7, 64, 16))
    x = hid.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="n == N"):
        mp.signed_segment_sum(x, past, fut, edge, 65)
    with torch.no_grad():
        out = mp.signed_segment_sum(x, past, fut, edge, 65)
    assert out.shape == (65, 16)
    assert torch.equal(out[:64], mp.signed_segment_sum(hid, past, fut, edge, 64))


@pytest.mark.parametrize("seed", [0, 1])
def test_gather_concat_and_its_vjp_match_jax_node_support(seed):
    """msg concat's node support against JAX's _node_support(h, g, 'concat')
    (mpnn.py:123-125) and its VJP against jax.vjp, on a seeded view whose
    detection and padding rows point at themselves, with a fifth of the
    window's rows dead.  The forward is a copy (exact); the VJP,
    segment_sum_halves, sums in f64 rounded once where XLA sums in f32
    (atol 1e-5)."""
    import jax

    from torch_port_util import window_graph
    from trackmpnn_tpu.graph import view as jview
    from trackmpnn_tpu.models import mpnn as jmpnn
    from trackmpnn_tpu_torch.graph import view as tview

    g, X, n_new = window_graph(num_tracks=5, num_frames=8, steps=3, seed=seed)
    cap = 512
    is_det, past, fut, _ = tview.pack_slots(g, X, cap)
    rows = np.arange(cap)
    rng = np.random.default_rng(seed)
    live = (rows < g.n) & (rng.random(cap) > 0.2)  # a fifth of the window's rows dead
    assert ((past == rows) & (fut == rows)).sum() > 100 and (~is_det[:g.n] & ~live[:g.n]).any()
    h = rng.normal(size=(cap, 16)).astype(np.float32)
    cot = rng.normal(size=(cap, 32)).astype(np.float32)
    jv = jview.GraphView(is_det=jnp.asarray(is_det), past=jnp.asarray(past),
                         fut=jnp.asarray(fut), live=jnp.asarray(live),
                         new=jnp.zeros(cap, bool), feat=jnp.zeros((cap, 1)))
    want, vjp = jax.vjp(lambda x: jmpnn._node_support(x, jv, "concat"), jnp.asarray(h))
    (want_dh,) = vjp(jnp.asarray(cot))
    em = torch.from_numpy(live & ~is_det)
    x = torch.from_numpy(h).requires_grad_(True)
    tp, tf = torch.from_numpy(past), torch.from_numpy(fut)
    got = mp.gather_concat(x, tp, tf, em)
    (got_dh,) = torch.autograd.grad((got * torch.from_numpy(cot)).sum(), x)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(got_dh.numpy(), np.asarray(want_dh), rtol=0, atol=1e-5)
    assert np.abs(got_dh.numpy()).max() > 0
    # the plain versions are what a CPU tensor gets
    assert torch.equal(got.detach(), mp.gather_concat_reference(x.detach(), tp, tf, em))
    assert torch.equal(got_dh, mp.segment_sum_halves_reference(torch.from_numpy(cot), tp, tf,
                                                               em, cap))
