"""The port's fused edge losses (trackmpnn_tpu_torch/ops/loss.py::edge_losses:
the plain L1, glue and L2, and the hand-written backward) against the JAX
package's edge_losses in interpret mode and its VJP, on the same numpy-made
inputs, in which some detections have live rows and no positive edge.

Partials within rtol 1e-4 / atol 1e-5 and the integer counts (bce_count,
tp, fp, fn) exact; the backward within rtol 1e-4 / atol 1e-5, and against
torch autograd of the plain forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import EDGE_LOSS_COUNTS, EDGE_LOSS_KEYS, edge_loss_inputs
from trackmpnn_tpu.ops.pallas_loss import edge_losses as jax_edge_losses
from trackmpnn_tpu_torch.ops import loss

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


def torch_args(x, requires_grad=False):
    out = [torch.from_numpy(np.asarray(x[k])) if k != "nD" else x[k] for k in EDGE_LOSS_KEYS]
    if requires_grad:
        out[:3] = [t.clone().requires_grad_(True) for t in out[:3]]
    return out


def check_partials(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.array_equal(got[:, EDGE_LOSS_COUNTS], want[:, EDGE_LOSS_COUNTS])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_edge_losses_match_jax():
    """Partials and d h_eo, d w_e, d b_e against the interpret-mode kernels
    and their VJP."""
    x, d_part = edge_loss_inputs(0)
    rest = [jnp.asarray(x[k]) for k in EDGE_LOSS_KEYS[3:9]]
    want, vjp = jax.vjp(lambda h, w, b: jax_edge_losses(h, w, b, *rest, x["nD"], 4, True),
                        *(jnp.asarray(x[k]) for k in EDGE_LOSS_KEYS[:3]))
    args = torch_args(x, requires_grad=True)
    got = loss.edge_losses(*args)
    check_partials(got.detach().numpy(), want)
    assert got[:, 3].sum() > 0 and got[:, 4:7].sum() > 0  # live cells and counts
    (got * torch.from_numpy(d_part)).sum().backward()
    theirs = vjp(jnp.asarray(d_part))
    for name, leaf, b in zip(("h_eo", "w_e", "b_e"), args[:3], theirs):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def plain_forward(h_eo, w_e, b_e, lbl, mask3, ebnt, bna, active_idx, act_m, nD):
    logits, r_min, m_r, s_r = loss.edge_loss_l1_reference(h_eo, w_e, b_e, lbl, mask3, ebnt)
    sel1g, lsedg, sizedg = loss.edge_loss_glue(r_min, m_r, s_r, mask3, ebnt, active_idx, act_m,
                                               nD)
    return loss.edge_loss_l2_reference(logits, lbl, mask3, ebnt, bna, sel1g, lsedg, sizedg)


def test_plain_backward_matches_autograd_of_the_plain_forward():
    """EdgeLosses' hand-written backward == torch autograd through the plain
    L1, glue and L2 (lse_d differentiable, the picks not)."""
    x, d_part = edge_loss_inputs(2)
    a = torch_args(x, requires_grad=True)
    (plain_forward(*a) * torch.from_numpy(d_part)).sum().backward()
    b = torch_args(x, requires_grad=True)
    (loss.edge_losses(*b) * torch.from_numpy(d_part)).sum().backward()
    for name, u, v in zip(("h_eo", "w_e", "b_e"), a[:3], b[:3]):
        torch.testing.assert_close(v.grad, u.grad, rtol=1e-4, atol=1e-5, msg=name)
