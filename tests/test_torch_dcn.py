"""The port's deformable convolution (trackmpnn_tpu_torch/ops/dcn.py and
backbones/deform_conv.py) against the JAX package on the same numpy-made
inputs.

  * The bounded form's plain forward against deform_conv2d_shift and
    against deform_conv2d_shift_pallas in interpret mode, at
    tests/test_pallas_dcn.py's shapes and tolerance (rtol and atol 1e-5);
    with offsets inside the bound, against the exact deform_conv2d (rtol
    1e-4, atol 1e-5, that file's).
  * The autograd Function's backward (d x, d weight, d bias, d offset, d
    mask) against jax.vjp of deform_conv2d_shift at integer, fractional,
    beyond-bound and mixed offsets: rtol 1e-4, atol 1e-5 x each output's
    scale; the offset gradient exactly 0 at integer offsets, as the JAX
    VJP's hat derivative gives it.
  * The exact form against jax.grad (rtol 1e-4, atol 1e-5 x scale), and the
    DCN module (offset / mask conv + deformable conv) on both routes
    against apply_dcn's gradients with perturbed offset weights, as
    tests/test_deform_dla.py:174 runs it (rtol 1e-3, atol 1e-4: the offset
    conv's sums in another order move the bilinear weights).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import DCN_KEYS, dcn_inputs
from trackmpnn_tpu.backbones import deform_conv as DC
from trackmpnn_tpu.ops.pallas_dcn import deform_conv2d_shift_pallas
from trackmpnn_tpu_torch.backbones import deform_conv as tdc
from trackmpnn_tpu_torch.backbones import weights as bw
from trackmpnn_tpu_torch.ops import dcn

torch.set_num_threads(1)


@jax.jit
def shift_vjp(args, g):
    """deform_conv2d_shift (max_offset 2) and its VJP at g, compiled once a
    shape."""
    out, vjp = jax.vjp(lambda *a: DC.deform_conv2d_shift(*a, max_offset=2.0), *args)
    return out, vjp(g)


def t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def close_scaled(got, want, rtol, atol_scale, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol_scale * max(float(np.abs(want).max()), 1e-30),
                               err_msg=msg)


@pytest.mark.parametrize("shape", [(10, 16, 8, 8), (13, 21, 4, 6), (9, 33, 16, 4)])
def test_plain_forward_matches_shift_and_pallas(shape):
    """tests/test_pallas_dcn.py's shapes, offsets up to 3.9 at max_offset 4."""
    H, W, Cin, Cout = shape
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, H, W, Cin)).astype(np.float32)
    wgt = rng.normal(size=(9 * Cin, Cout)).astype(np.float32)
    b = rng.normal(size=(Cout,)).astype(np.float32)
    off = rng.uniform(-3.9, 3.9, size=(2, H, W, 18)).astype(np.float32)
    msk = rng.uniform(0, 1, size=(2, H, W, 9)).astype(np.float32)
    got = dcn.dcn_forward(t(x), t(wgt), t(b), t(off), t(msk), 4.0).numpy()
    shift = jax.jit(lambda *a: DC.deform_conv2d_shift(*a, max_offset=4.0))(
        *map(jnp.asarray, (x, wgt, b, off, msk)))
    np.testing.assert_allclose(got, np.asarray(shift), rtol=1e-5, atol=1e-5)
    pallas = deform_conv2d_shift_pallas(jnp.asarray(x[1]), jnp.asarray(wgt), jnp.asarray(b),
                                        jnp.asarray(off[1]), jnp.asarray(msk[1]),
                                        max_offset=4.0, tile_h=4, interpret=True)
    np.testing.assert_allclose(got[1], np.asarray(pallas), rtol=1e-5, atol=1e-5)


def test_in_bound_offsets_match_the_exact_gather():
    """Offsets inside the bound: the bounded and the exact forms agree, in
    the port as in the JAX package."""
    x = dcn_inputs(1, N=2, H=11, W=14, C=8, O=5, kind="frac")
    args = [t(x[k]) for k in DCN_KEYS[:5]]
    got = dcn.deform_conv_shift(*args, 2.0).numpy()
    exact = jax.jit(DC.deform_conv2d)(*(jnp.asarray(x[k]) for k in DCN_KEYS[:5]))
    np.testing.assert_allclose(got, np.asarray(exact), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tdc.deform_conv2d(*args).numpy(), np.asarray(exact),
                               rtol=1e-4, atol=1e-5)


def test_bilinear_sample_matches_jax():
    """Sample points inside, on the edge of and outside the image (zeros)."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(5, 6, 3)).astype(np.float32)
    ys, xs = (rng.uniform(-1.5, n + 0.5, (4, 7)).astype(np.float32) for n in (5, 6))
    want = DC.bilinear_sample(jnp.asarray(x), jnp.asarray(ys), jnp.asarray(xs))
    got = tdc.bilinear_sample(t(x), t(ys), t(xs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["int", "frac", "beyond", "mixed"])
def test_backward_matches_jax_vjp(kind):
    """d x, d weight, d bias, d offset, d mask of the autograd Function
    against jax.vjp of deform_conv2d_shift (max_offset 2)."""
    x = dcn_inputs(2, N=2, H=7, W=9, C=6, O=5, kind=kind)
    out, want = shift_vjp(tuple(jnp.asarray(x[k]) for k in DCN_KEYS[:5]), jnp.asarray(x["g"]))
    args = [t(x[k], grad=True) for k in DCN_KEYS[:5]]
    got = dcn.deform_conv_shift(*args, 2.0)
    close_scaled(got.detach().numpy(), out, 1e-5, 1e-5, "out")
    got.backward(t(x["g"]))
    for name, a, w in zip(DCN_KEYS, args, want):
        close_scaled(a.grad.numpy(), w, 1e-4, 1e-5, name)
    if kind == "int":
        # the hat derivative's sign(0) = 0: no offset gradient at all
        assert np.all(np.asarray(want[3]) == 0) and torch.all(args[3].grad == 0)
        assert float(args[4].grad.abs().max()) > 0
    else:
        assert float(args[3].grad.abs().max()) > 0


def test_plain_backward_pieces_agree_with_autograd_of_the_plain_forward():
    """d x, d offset, d mask and d weight of the hand-written plain backward
    against torch autograd through the plain shift-sum forward (fractional
    offsets)."""
    x = dcn_inputs(3, N=1, H=6, W=8, C=4, O=3, kind="frac")
    xs, w, b, off, m = (t(x[k], grad=True) for k in DCN_KEYS[:5])
    out = dcn.dcn_forward_reference(xs, w, b, off, m, 2.0)
    gx, gw, goff, gm = torch.autograd.grad(out, (xs, w, off, m), t(x["g"]))
    dcols = (t(x["g"]).reshape(-1, 3) @ w.detach().t()).reshape(1, 6, 8, 36)
    dweight, doff, dmask = dcn.dcn_sample_backward(xs.detach(), off.detach(), m.detach(), dcols,
                                                   t(x["g"]), 2.0)
    dx = dcn.dcn_dx(off.detach(), m.detach(), dcols, 2.0)
    for name, got, want in (("x", dx, gx), ("offset", doff, goff), ("mask", dmask, gm),
                            ("weight", dweight, gw)):
        close_scaled(got.numpy(), want.numpy(), 1e-4, 1e-5, name)


def test_exact_form_matches_jax_grad():
    """The exact gather: forward and floor-based gradients (x, weight,
    offset, mask) against jax.grad, offsets kept off integers."""
    x = dcn_inputs(4, N=2, H=8, W=10, C=4, O=5, kind="beyond")
    off = np.where(np.abs(x["offset"] - np.round(x["offset"])) < 0.05, x["offset"] + 0.1,
                   x["offset"]).astype(np.float32)
    arrays = [x["x"], x["weight"], off, x["mask"]]
    b = jnp.asarray(x["bias"])
    f = lambda xx, ww, oo, mm: jnp.sum(jnp.cos(DC.deform_conv2d(xx, ww, b, oo, mm)))
    want = jax.jit(jax.grad(f, (0, 1, 2, 3)))(*map(jnp.asarray, arrays))
    args = [t(a, grad=True) for a in arrays]
    out = tdc.deform_conv2d(args[0], args[1], t(x["bias"]), args[2], args[3])
    torch.cos(out).sum().backward()
    for name, a, w in zip(("x", "weight", "offset", "mask"), args, want):
        close_scaled(a.grad.numpy(), w, 1e-4, 1e-5, name)


@pytest.mark.parametrize("max_offset", [None, 6.0])
def test_dcn_module_matches_apply_dcn(max_offset):
    """The DCN module (NCHW, [O, C, 3, 3] weights) against apply_dcn with
    the same perturbed offset / mask conv: output and every weight's
    gradient of sum(sin(out))."""
    rng = np.random.default_rng(6)
    H, W, Cin, Cout = 10, 12, 6, 5
    x = rng.normal(size=(2, H, W, Cin)).astype(np.float32)
    jp = {"weight": rng.normal(size=(9 * Cin, Cout)) / np.sqrt(9 * Cin),
          "bias": rng.normal(size=(Cout,)) * 0.1,
          "offset_weight": rng.normal(size=(3, 3, Cin, 27)) * 0.02,
          "offset_bias": rng.normal(size=(27,)) * 0.3}
    jp = {k: np.asarray(v, np.float32) for k, v in jp.items()}
    f = lambda p: jnp.sum(jnp.sin(DC.apply_dcn(p, jnp.asarray(x), max_offset=max_offset)))
    loss_j, grads_j = jax.jit(jax.value_and_grad(f))({k: jnp.asarray(v) for k, v in jp.items()})

    mod = tdc.DCN(Cin, Cout, max_offset)
    names = {"weight": "weight", "bias": "bias", "offset_weight": "conv_offset_mask.weight",
             "offset_bias": "conv_offset_mask.bias"}
    mod.load_state_dict(bw.state_dict_from_jax({names[k]: v for k, v in jp.items()},
                                               mod.state_dict()))
    loss_t = torch.sin(mod(t(x).permute(0, 3, 1, 2))).sum()
    loss_t.backward()
    assert abs(loss_t.item() - float(loss_j)) <= 1e-4 * abs(float(loss_j))
    got = bw.state_dict_to_jax({n: p.grad for n, p in mod.named_parameters()})
    for k, n in names.items():
        np.testing.assert_allclose(got[n], np.asarray(grads_j[k]), rtol=1e-3, atol=1e-4,
                                   err_msg=k)


def test_reach_refuses_bad_bounds():
    x = {k: t(v) for k, v in dcn_inputs(7, N=1, H=3, W=4, C=2, O=2).items()}
    args = [x[k] for k in DCN_KEYS[:5]]
    for bad in (-1.0, float("nan"), float(dcn.MAX_REACH) + 0.5):
        with pytest.raises(ValueError, match="max_offset"):
            dcn.deform_conv_shift(*args, bad)
    with pytest.raises(ValueError, match="3x3 taps"):
        tdc.deform_conv2d_shift(*args, stride=2, max_offset=2.0)
