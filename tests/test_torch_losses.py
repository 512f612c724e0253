"""The port's row-layout losses (trackmpnn_tpu_torch/losses/losses.py) and
segment arg-reductions (ops/segment.py) against the JAX package's, on a real
window schedule with random logits.  Same numpy inputs on both sides.

Targets, arg-reductions and F1 counts are integers and must be equal; loss
values within rtol 1e-5 (f32 sums in another order); d loss / d logits
against jax.grad within rtol 1e-5, atol 1e-7 (entries that are 0 on one
side are 0 on the other).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import training_chunks
from trackmpnn_tpu.losses import losses as jlosses
from trackmpnn_tpu.ops import segment as jsegment
from trackmpnn_tpu_torch.graph import schedule
from trackmpnn_tpu_torch.losses import losses
from trackmpnn_tpu_torch.ops import segment

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def window():
    """A real schedule (cap 256) and, per case, the live prefix of a step."""
    X, y = training_chunks(1, seed0=3)[0]
    return schedule.build_window_schedule(X, y, cap=256, t_cap=10)


def step_inputs(ws, step, seed):
    rng = np.random.default_rng(seed)
    cap = ws.is_det.shape[0]
    live = np.arange(cap) < ws.n_after[step]
    logits = (rng.normal(size=cap) * 3.0).astype(np.float32) * live
    arrays = {"label": ws.label, "is_det": ws.is_det, "past": ws.past, "fut": ws.fut,
              "live": live, "logits": logits}
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()})


@pytest.mark.parametrize("tie", ["high", "low"])
@pytest.mark.parametrize("masked", [True, False])
def test_segment_arg_reductions_match_jax(tie, masked):
    rng = np.random.default_rng(1)
    n, segs = 400, 240  # some segments empty
    vals = rng.integers(0, 4, n).astype(np.float32)  # many ties
    ids = rng.integers(0, segs, n).astype(np.int32)
    mask = rng.random(n) > 0.3 if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    for jfn, tfn in ((jsegment.segment_argmax, segment.segment_argmax),
                     (jsegment.segment_argmin, segment.segment_argmin)):
        want = np.asarray(jfn(jnp.asarray(vals), jnp.asarray(ids), segs, mask=jm, tie=tie))
        got = tfn(torch.from_numpy(vals), torch.from_numpy(ids), segs, mask=tm, tie=tie)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert (want == -1).any() and (want >= 0).any()


@pytest.mark.parametrize("step", [1, -1])
def test_targets_ce_and_counts_match_jax(window, step):
    step = step % window.n_steps
    j, t = step_inputs(window, step, seed=step)
    args = ("label", "is_det", "past", "fut", "live")
    want_t = np.asarray(jax.jit(jlosses.make_targets)(*(j[k] for k in args)))
    got_t = losses.make_targets(*(t[k] for k in args))
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    assert want_t.sum() > 0

    ce_args = ("is_det", "past", "fut", "live")
    want_ce = float(jax.jit(jlosses.ce_loss)(j["logits"], jnp.asarray(want_t),
                                             *(j[k] for k in ce_args)))
    got_ce = float(losses.ce_loss(t["logits"], got_t, *(t[k] for k in ce_args)))
    np.testing.assert_allclose(got_ce, want_ce, rtol=1e-5)

    fused = ("label", "is_det", "past", "fut", "live")
    jt2, jce2 = jax.jit(jlosses.targets_and_ce)(j["logits"], *(j[k] for k in fused))
    tt2, tce2 = losses.targets_and_ce(t["logits"], *(t[k] for k in fused))
    np.testing.assert_array_equal(tt2.numpy(), np.asarray(jt2))
    np.testing.assert_allclose(float(tce2), float(jce2), rtol=1e-5)
    np.testing.assert_allclose(float(tce2), got_ce, rtol=1e-5)  # the two forms agree

    probs = torch.sigmoid(t["logits"]) * t["live"]
    jprobs = jnp.asarray(probs.numpy())
    for tp_classifier in (True, False):
        want = jlosses.f1_counts(jprobs, jt2, j["is_det"], j["live"], tp_classifier)
        got = losses.f1_counts(probs, tt2, t["is_det"], t["live"], tp_classifier)
        assert [int(x) for x in got] == [int(x) for x in want]
    edge = t["live"] & ~t["is_det"]
    np.testing.assert_allclose(
        float(losses.bce_loss(probs, tt2, edge)),
        float(jlosses.bce_loss(jprobs, jt2, jnp.asarray(edge.numpy()))), rtol=1e-5)
    np.testing.assert_allclose(
        float(losses.focal_loss(probs, tt2, edge, gamma=2.0)),
        float(jlosses.focal_loss(jprobs, jt2, jnp.asarray(edge.numpy()), gamma=2.0)), rtol=1e-5)


@pytest.mark.parametrize("tp_classifier", [True, False])
def test_step_losses_and_their_gradient_match_jax(window, tp_classifier):
    step = window.n_steps - 2
    j, t = step_inputs(window, step, seed=10 + tp_classifier)
    rest = ("label", "is_det", "past", "fut", "live")

    def jloss(logits):
        scores = jnp.where(j["live"], jax.nn.sigmoid(logits), 0.0)
        ce, f, counts, targets = jlosses.step_losses(scores, logits, *(j[k] for k in rest),
                                                     tp_classifier)
        return ce + f, (ce, f, counts, targets)

    (want, (wce, wf, wcounts, wt)), wgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        j["logits"])
    logits = t["logits"].clone().requires_grad_(True)
    scores = torch.where(t["live"], torch.sigmoid(logits), 0.0)
    ce, f, counts, targets = losses.step_losses(scores, logits, *(t[k] for k in rest),
                                                tp_classifier)
    (ce + f).backward()
    np.testing.assert_allclose(float(ce.detach()), float(wce), rtol=1e-5)
    np.testing.assert_allclose(float(f.detach()), float(wf), rtol=1e-5)
    assert [int(x) for x in counts] == [int(x) for x in wcounts]
    np.testing.assert_array_equal(targets.numpy(), np.asarray(wt))
    np.testing.assert_allclose(logits.grad.numpy(), np.asarray(wgrad), rtol=1e-5, atol=1e-7)
    assert np.abs(np.asarray(wgrad)).max() > 0
