"""The port's appearance backbones (trackmpnn_tpu_torch/backbones/) against
the JAX package's, with the same weights carried across
(backbones/weights.py) and the same numpy-made inputs.

  * Layer primitives (SAME_TORCH convs with stride, dilation and groups,
    BatchNorm in eval and train mode with its buffer update, PReLU,
    avg_pool2d, the align-corners resize with its size-1 branch,
    upsample2x, the bilinear depthwise up-conv, the init helpers): rtol and
    atol 1e-5 (1e-4 rtol for the train-mode variance, a sum in another
    order).
  * ESPNetv2 and DLA-34 on the bounded DCN route, forward at 2 x 32 x 64
    in eval mode (the DCN offset convs calibrated: torch_port_util.
    calibrate_dcn_offsets): rtol 1e-4, atol 1e-4 x the largest |output| (DLA-34's
    activations reach a few hundred before its BNs; sums of that size in
    another order differ by ~1e-5 relative).  DLA-34 on the exact route:
    forward the same, and every parameter's gradient of sum(out * g) within
    rtol 1e-3, atol 1e-4 x the largest |grad|.
  * The weights JAX -> port -> JAX round-trip exactly.

Each JAX network is jitted once, in a module-scoped fixture (forward, or
one value_and_grad for forward and grads).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from torch_port_util import backbone_params
from trackmpnn_tpu.backbones import dla as JD
from trackmpnn_tpu.backbones import espnetv2 as JE
from trackmpnn_tpu.backbones import layers as JL
from trackmpnn_tpu_torch.backbones import dla, layers
from trackmpnn_tpu_torch.backbones import weights as bw

torch.set_num_threads(1)

HW = (32, 64)
CLASSES = 16
NET_RTOL, NET_ATOL_SCALE = 1e-4, 1e-4
GRAD_RTOL, GRAD_ATOL_SCALE = 1e-3, 1e-4


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def images(seed, n=2):
    return np.random.default_rng(seed).normal(size=(n, *HW, 3)).astype(np.float32)


# ------------------------------------------------------------ primitives ----
@pytest.mark.parametrize("k,stride,dilation,groups", [(3, 1, 1, 1), (3, 2, 1, 4), (3, 1, 3, 8),
                                                      (7, 1, 1, 1), (1, 2, 1, 2)])
def test_conv_same_torch_padding(k, stride, dilation, groups):
    rng = np.random.default_rng(k + stride + dilation + groups)
    x = rng.normal(size=(2, 11, 13, 8)).astype(np.float32)
    w = rng.normal(size=(k, k, 8 // groups, 16)).astype(np.float32)
    want = JL.conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride, dilation=dilation,
                     groups=groups)
    conv = layers.conv(8, 16, k, stride, groups, dilation)
    conv.load_state_dict({"weight": torch.from_numpy(w.transpose(3, 2, 0, 1).copy())})
    np.testing.assert_allclose(nhwc(conv(nchw(x))), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("train", [False, True])
def test_batchnorm_matches_bn2d(train):
    """Eval: the running statistics normalise.  Train: the biased batch
    variance normalises and the unbiased one enters the buffers with
    momentum 0.1."""
    rng = np.random.default_rng(3)
    x = rng.normal(1.0, 2.0, size=(3, 5, 6, 4)).astype(np.float32)
    p = {"b.weight": rng.normal(size=4), "b.bias": rng.normal(size=4),
         "b.running_mean": rng.normal(size=4), "b.running_var": rng.uniform(0.5, 2, 4)}
    p = {k: np.asarray(v, np.float32) for k, v in p.items()}
    with JL.collect_bn_updates() as upd:
        want = JL.bn2d({k: jnp.asarray(v) for k, v in p.items()}, "b", jnp.asarray(x), train)
    bn = layers.bn(4)
    bn.load_state_dict({k[2:]: torch.from_numpy(v) for k, v in p.items()}, strict=False)
    bn.train(train)
    np.testing.assert_allclose(nhwc(bn(nchw(x))), np.asarray(want), rtol=1e-5, atol=1e-5)
    for name in ("running_mean", "running_var"):
        expect = np.asarray(upd[f"b.{name}"]) if train else p[f"b.{name}"]
        np.testing.assert_allclose(getattr(bn, name).numpy(), expect, rtol=1e-4, atol=1e-6)


def test_prelu_and_avg_pool():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 9, 7, 3)).astype(np.float32)
    alpha = np.array([0.25, -0.1, 0.7], np.float32)
    act = nn.PReLU(3)
    act.load_state_dict({"weight": torch.from_numpy(alpha)})
    np.testing.assert_allclose(nhwc(act(nchw(x))), np.asarray(JL.prelu(jnp.asarray(x), alpha)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(nhwc(layers.avg_pool2d(nchw(x))),
                               np.asarray(JL.avg_pool2d(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("src,dst", [((4, 6), (9, 11)), ((1, 1), (3, 5)), ((5, 7), (1, 1)),
                                     ((1, 4), (2, 8)), ((3, 5), (6, 10))])
def test_resize_align_corners(src, dst):
    """Including the size-1 branch (layers.py:169-171) in and out."""
    x = np.random.default_rng(5).normal(size=(2, *src, 3)).astype(np.float32)
    want = JL.resize_bilinear_align_corners(jnp.asarray(x), *dst)
    got = layers.resize_bilinear_align_corners(nchw(x), *dst)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    if dst == (2 * src[0], 2 * src[1]):
        np.testing.assert_allclose(nhwc(layers.upsample2x(nchw(x))), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("f", [2, 4])
def test_depthwise_up_conv(f):
    """ConvTranspose2d(groups = channels) against the fractionally strided
    depthwise conv with a flipped kernel, on a random (not symmetric) kernel."""
    rng = np.random.default_rng(f)
    x = rng.normal(size=(2, 3, 5, 6)).astype(np.float32)
    w = rng.normal(size=(2 * f, 2 * f, 1, 6)).astype(np.float32)
    want = JD.depthwise_conv_transpose(jnp.asarray(x), jnp.asarray(w), f)
    up = dla.depthwise_up(6, f)
    np.testing.assert_array_equal(up.weight[0, 0].detach().numpy(), JD.bilinear_up_kernel(f))
    up.load_state_dict({"weight": torch.from_numpy(w.transpose(3, 2, 0, 1).copy())})
    np.testing.assert_allclose(nhwc(up(nchw(x))), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_kaiming_fan_out_init():
    g = torch.Generator().manual_seed(0)
    w = layers.kaiming_fan_out_(torch.empty(96, 32, 3, 3), g)
    assert abs(float(w.std()) / np.sqrt(2.0 / (9 * 96)) - 1.0) < 0.05
    dcn = dla.DeformConv(8, 16, generator=g).conv
    assert not dcn.conv_offset_mask.weight.any() and not dcn.bias.any()


# -------------------------------------------------------------- networks ----
@pytest.fixture(scope="module")
def espv2_case():
    p = backbone_params("espv2", 0, CLASSES)
    x = images(1)
    fwd = jax.jit(lambda pp, xx: JE.apply_espnetv2_seg(pp, xx))
    return p, x, np.asarray(fwd({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))


@pytest.fixture(scope="module")
def dla_shift_case():
    p = backbone_params("dla34", 1, CLASSES, dcn_max_offset=2.0)
    x = images(2)
    fwd = jax.jit(lambda pp, xx: JD.apply_dlaseg(pp, xx, {"trk": CLASSES},
                                                 dcn_max_offset=2.0)["trk"])
    return p, x, np.asarray(fwd({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))


@pytest.fixture(scope="module")
def dla_exact_case():
    p = backbone_params("dla34", 2, CLASSES)
    x = images(3)
    g = np.random.default_rng(4).normal(size=(2, HW[0] // 4, HW[1] // 4, CLASSES))
    g = g.astype(np.float32)

    def loss(pp):
        out = JD.apply_dlaseg(pp, jnp.asarray(x), {"trk": CLASSES})["trk"]
        return jnp.sum(out * g), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in p.items()})
    return p, x, g, np.asarray(out), {k: np.asarray(v) for k, v in grads.items()}


def check_net(got, want):
    np.testing.assert_allclose(got, want, rtol=NET_RTOL,
                               atol=NET_ATOL_SCALE * float(np.abs(want).max()))


def test_espnetv2_forward_matches_jax(espv2_case):
    p, x, want = espv2_case
    net = bw.backbone_from_jax_params("espv2", p).eval()
    with torch.no_grad():
        got = nhwc(net(nchw(x)))
    assert got.shape == (2, *HW, CLASSES)
    check_net(got, want)


def test_dla34_bounded_dcn_forward_matches_jax(dla_shift_case):
    p, x, want = dla_shift_case
    net = bw.backbone_from_jax_params("dla34", p, dcn_max_offset=2.0).eval()
    offsets = []
    for m in net.modules():
        if isinstance(m, dla.DCN):
            m.conv_offset_mask.register_forward_hook(lambda mod, i, o: offsets.append(o[:, :18]))
    with torch.no_grad():
        got = nhwc(net(nchw(x))["trk"])
    assert got.shape == (2, HW[0] // 4, HW[1] // 4, CLASSES)
    check_net(got, want)
    off = torch.cat([o.flatten() for o in offsets]).double()
    assert len(offsets) == 16 and 0.2 < float((off.abs() > 2.0).double().mean()) < 0.8
    # fractional, and clear of the kinks (integers, the bound)
    assert float(torch.minimum((off - off.round()).abs(), (off.abs() - 2.0).abs()).min()) > 0.05


def test_dla34_exact_dcn_forward_and_grads_match_jax(dla_exact_case):
    p, x, g, want, grads = dla_exact_case
    net = bw.backbone_from_jax_params("dla34", p).eval()
    out = net(nchw(x))["trk"]
    check_net(nhwc(out), want)
    (out * nchw(g)).sum().backward()
    # a tree's projection off the output's path (levels > 1) has no grad;
    # JAX gives it zeros
    got = bw.state_dict_to_jax({n: torch.zeros_like(q) if q.grad is None else q.grad
                                for n, q in net.named_parameters()})
    assert set(got) == set(grads) - {k for k in grads if ".running_" in k}
    scale = max(float(np.abs(v).max()) for v in grads.values())
    for k, v in got.items():
        np.testing.assert_allclose(v, grads[k], rtol=GRAD_RTOL, atol=GRAD_ATOL_SCALE * scale,
                                   err_msg=k)


@pytest.mark.parametrize("arch", ["espv2", "dla34"])
def test_weights_round_trip_exactly(arch):
    p = backbone_params(arch, 7, CLASSES)
    net = bw.backbone_from_jax_params(arch, p)
    back = bw.backbone_to_jax_params(net)
    assert set(back) == set(p)
    for k, v in p.items():
        assert back[k].shape == v.shape and np.array_equal(back[k], v), k
    # the DCN and up-conv layouts: [9*C, O] <-> [O, C, 3, 3], [2f, 2f, 1, o] <-> [o, 1, 2f, 2f]
    if arch == "dla34":
        dcn = net.ida_up.node_1.conv.weight
        w = p["ida_up.node_1.conv.weight"]
        C = dcn.shape[1]
        assert w.shape == (9 * C, dcn.shape[0])
        np.testing.assert_array_equal(dcn[:, 5, 2, 1].detach().numpy(), w[(2 * 3 + 1) * C + 5])
        np.testing.assert_array_equal(net.ida_up.up_1.weight[3, 0].detach().numpy(),
                                      p["ida_up.up_1.weight"][:, :, 0, 3])
    with pytest.raises(KeyError, match="only in the port"):
        bw.state_dict_from_jax({k: v for k, v in p.items() if k != next(iter(p))},
                               net.state_dict())
