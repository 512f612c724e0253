"""The port's fused round (trackmpnn_tpu_torch/ops/round.py) against the JAX
package's fused_round, run in interpret mode on the CPU as
tests/test_pallas_round.py runs it, and against its round_reference.  Same
numpy inputs on both sides (B 2, cap 64, H 64, rows of random kind with
random endpoints in the window).

Tolerances: the forward within atol 1e-5 (GRU products summed in another
order, O(1) values); the backward's d h and eight weight and bias grads
within rtol 1e-4 with an atol of 1e-5 x each gradient's largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import ROUND_KEYS as KEYS
from torch_port_util import round_inputs as make_problem
from trackmpnn_tpu.ops import pallas_round as PR
from trackmpnn_tpu_torch.ops import round as rnd

torch.set_num_threads(1)


@pytest.fixture
def interpret_mode():
    PR._INTERPRET[0] = True
    yield
    PR._INTERPRET[0] = False


def to_torch(h, idxw, we, wn):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return t(h), t(idxw), {k: t(v) for k, v in we.items()}, {k: t(v) for k, v in wn.items()}


def incidence(idxw):
    return tuple(torch.from_numpy(a) for a in rnd.round_incidence(idxw))


def test_fused_round_and_its_gradients_match_interpret_mode_pallas(interpret_mode):
    h, idxw, we, wn, cot = make_problem(0)
    jwe, jwn = (jax.tree_util.tree_map(jnp.asarray, w) for w in (we, wn))
    want, pull = jax.vjp(lambda x, a, b: PR.fused_round(x, jnp.asarray(idxw), a, b, None, 32),
                         jnp.asarray(h), jwe, jwn)
    wdh, wdwe, wdwn = pull(jnp.asarray(cot))

    th, tidx, twe, twn = to_torch(h, idxw, we, wn)
    leaves = [th] + [twe[k] for k in KEYS] + [twn[k] for k in KEYS]
    for leaf in leaves:
        leaf.requires_grad_(True)
    out = rnd.fused_round(th, tidx, twe, twn, incidence(idxw))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    wants = [wdh] + [wdwe[k] for k in KEYS] + [wdwn[k] for k in KEYS]
    names = ["d h"] + [f"d we.{k}" for k in KEYS] + [f"d wn.{k}" for k in KEYS]
    for name, a, b in zip(names, grads, wants):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-5 * np.abs(b).max(),
                                   err_msg=name)
        assert np.abs(b).max() > 0, name


def test_forward_matches_round_reference():
    """round_reference (pallas_round.py:56) of the JAX package, and the
    port's own, equal the plain forward."""
    h, idxw, we, wn, _ = make_problem(1, B=3, cap=96)
    live = (idxw[..., 2] | idxw[..., 3]).astype(bool)
    det = idxw[..., 3].astype(bool)
    want = PR.round_reference(*map(jnp.asarray, (h, idxw[..., 0], idxw[..., 1], det, live)),
                              jax.tree_util.tree_map(jnp.asarray, we),
                              jax.tree_util.tree_map(jnp.asarray, wn))
    th, tidx, twe, twn = to_torch(h, idxw, we, wn)
    out, xin = rnd.round_fwd_reference(th, tidx, twe, twn)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    t = torch.from_numpy
    own = rnd.round_reference(th, t(idxw[..., 0]), t(idxw[..., 1]), t(det), t(live), twe, twn)
    assert torch.equal(own, out)
    # padded and dead rows are exactly 0, in out and in the residual xin
    dead = ~live
    assert torch.all(out[t(dead)] == 0) and torch.all(xin[t(dead)] == 0)


def test_backward_stages_compose_to_autograd_of_the_forward():
    """round_backward's three plain stages give what autograd of the plain
    forward gives (rtol 1e-5, atol 1e-6 x scale); the cotangent of dead
    rows reaches nothing."""
    h, idxw, we, wn, cot = make_problem(2, B=2, cap=48, H=16)
    th, tidx, twe, twn = to_torch(h, idxw, we, wn)
    leaves = [th] + [twe[k] for k in KEYS] + [twn[k] for k in KEYS]
    for leaf in leaves:
        leaf.requires_grad_(True)
    out, _ = rnd.round_fwd_reference(th, tidx, twe, twn)
    want = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    with torch.no_grad():
        _, xin = rnd.round_fwd_reference(th, tidx, twe, twn)
        dh, dwe, dwn = rnd.round_backward(th, tidx, None, None, xin, twe, twn,
                                          torch.from_numpy(cot))
    got = [dh] + [dwe[k] for k in KEYS] + [dwn[k] for k in KEYS]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * float(b.abs().max()))


def test_incidence_equals_a_numpy_build():
    """round_incidence against a direct build: per flat row, the sorted
    window-local ids of the edge rows with that row as past or fut."""
    _, idxw, _, _, _ = make_problem(3, B=3, cap=40)
    idxw[0, 5, :] = (7, 7, 1, 0)  # a self-loop appears once
    idxw[1, 6, :] = (2, 3, 1, 1)  # flagged both: a detection, not an edge
    ptr, idx = rnd.round_incidence(idxw)
    B, cap, _ = idxw.shape
    assert ptr.dtype == np.int32 and idx.dtype == np.int32 and ptr.shape == (B * cap + 1,)
    for b in range(B):
        edges = [k for k in range(cap) if idxw[b, k, 2] == 1 and idxw[b, k, 3] == 0]
        for d in range(cap):
            want = [k for k in edges if idxw[b, k, 0] == d or idxw[b, k, 1] == d]
            assert idx[ptr[b * cap + d]:ptr[b * cap + d + 1]].tolist() == want
    bad = idxw.copy()
    bad[2, 0, :] = (cap, 0, 1, 0)
    with pytest.raises(ValueError, match="outside"):
        rnd.round_incidence(bad)


def test_cpu_path_leaves_launch_counters_alone(monkeypatch):
    monkeypatch.setattr(rnd, "LAUNCHES", dict.fromkeys(rnd.LAUNCHES, 0))
    h, idxw, we, wn, cot = make_problem(4, cap=32, H=16)
    th, tidx, twe, twn = to_torch(h, idxw, we, wn)
    th.requires_grad_(True)
    rnd.fused_round(th, tidx, twe, twn, incidence(idxw)).backward(torch.from_numpy(cot))
    assert set(rnd.LAUNCHES.values()) == {0}
    with pytest.raises(ValueError):
        rnd.fused_round(th.detach().to("meta"), tidx.to("meta"), twe, twn,
                        inc=(torch.zeros(1, dtype=torch.int32),) * 2)
