"""The arithmetic and the width rule of the port's block round kernels
(trackmpnn_tpu_torch/csrc/block_kernels.cu), on the CPU.

The kernels run the round's three products (he_m @ w_hh, d gh @ w_hh^T and
he_m^T @ d gh) on the tensor cores in split TF32 (CUTLASS's 3xTF32):
x = big + small with big = tf32(x), small = tf32(x - big), and a b ~
a.small b.big + a.big b.small + a.big b.big, accumulated in f32.  Here that
arithmetic is emulated in PyTorch, rounding to TF32 on the int32 view as the
kernels do, and the round's forward and backward built on it are held
against the JAX package's reference_block_round and its VJP at the kernels'
bounds: forward atol 1e-5, backward rtol 1e-4 with atol 1e-5 x each
output's scale.  Plain TF32 misses them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import mm_3xtf32, mm_tf32, tf32
from trackmpnn_tpu.ops import pallas_block as pb
from trackmpnn_tpu_torch.ops import block

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


FWD_ATOL, BWD_RTOL, BWD_ATOL_SCALE = 1e-5, 1e-4, 1e-5


def round_problem(seed, P, na, nt, H):
    """A round with a rectangular live part per block (padded cells of h_e
    are 0, as the step makes them) and its cotangents, numpy f32."""
    rng = np.random.default_rng(seed)
    blk_na = rng.integers(0, na + 1, size=P)
    blk_nt = rng.integers(0, nt + 1, size=P)
    m = ((np.arange(na)[None, :, None] < blk_na[:, None, None])
         & (np.arange(nt)[None, None, :] < blk_nt[:, None, None])).astype(np.float32)
    args = [rng.normal(size=(P, na, nt, H)) * m[..., None], rng.normal(size=(P, na, 3 * H)),
            rng.normal(size=(P, nt, 3 * H)), rng.normal(size=(H, 3 * H)) * 0.3,
            rng.normal(size=(3 * H,)) * 0.1, rng.normal(size=(H, 1)) * 0.4, m]
    cots = [rng.normal(size=(P, na, nt, H)), rng.normal(size=(P, na, H)),
            rng.normal(size=(P, nt, H)), rng.normal(size=(P, na, nt))]
    f32 = lambda a: np.ascontiguousarray(a, np.float32)
    return [f32(a) for a in args], [f32(c) for c in cots]


def round_with(mm, h_e, ga, gb, w_hh, b_hh, w_eb, mask3, sign, g_eo, g_rs, g_cs, g_lg):
    """block_round_reference and block_round_backward_reference
    (ops/block.py) with their three products taken by mm."""
    P, na, nt, H = h_e.shape
    m = mask3[..., None]
    he_m = h_e * m
    gh = mm(he_m.reshape(-1, H), w_hh).reshape(P, na, nt, 3 * H) + b_hh
    gi = ga[:, :, None, :] + sign * gb[:, None, :, :]
    r = torch.sigmoid(gi[..., :H] + gh[..., :H])
    z = torch.sigmoid(gi[..., H:2 * H] + gh[..., H:2 * H])
    ghn = gh[..., 2 * H:]
    n = torch.tanh(gi[..., 2 * H:] + r * ghn)
    eo = ((1.0 - z) * n + z * he_m) * m
    fwd = (eo, he_m.sum(2), he_m.sum(1), (eo @ w_eb)[..., 0])
    go = (g_eo + g_lg[..., None] * w_eb.reshape(1, 1, 1, H)) * m
    dpre_n = go * (1.0 - z) * (1.0 - n * n)
    dpre_r = dpre_n * ghn * r * (1.0 - r)
    dpre_z = go * (he_m - n) * z * (1.0 - z)
    dgh = torch.cat([dpre_r, dpre_z, dpre_n * r], -1)
    dgi = torch.cat([dpre_r, dpre_z, dpre_n], -1)
    dhe = (go * z + mm(dgh.reshape(-1, 3 * H), w_hh.t()).reshape(P, na, nt, H)
           + g_rs[:, :, None, :] + g_cs[:, None, :, :]) * m
    bwd = (dhe, dgi.sum(2), sign * dgi.sum(1), mm(he_m.reshape(-1, H).t(), dgh.reshape(-1, 3 * H)),
           dgh.reshape(-1, 3 * H).sum(0), (eo * g_lg[..., None]).reshape(-1, H).sum(0)[:, None])
    return fwd, bwd


@jax.jit
def jax_round(args, cots, sign):
    """reference_block_round (pallas_block.py:710) and its VJP."""
    outs, vjp = jax.vjp(lambda *a: pb.reference_block_round(*a, sign), *args)
    return outs, vjp(cots)[:6]


def misses(mm, args, cots, sign, want_f, want_b):
    """How far the round on mm lies outside the kernels' bounds: the largest
    ratio of an output's error to its allowance (below 1 is within)."""
    t = [torch.from_numpy(a) for a in args + cots]
    got_f, got_b = round_with(mm, *t[:7], sign, *t[7:])
    worst = max(float((a - w).abs().max()) / FWD_ATOL for a, w in zip(got_f, want_f))
    for a, w in zip(got_b, want_b):
        allowed = BWD_ATOL_SCALE * float(w.abs().max()) + BWD_RTOL * w.abs()
        worst = max(worst, float(((a - w).abs() / allowed).max()))
    return worst


@pytest.mark.parametrize("P,na,nt,H", [(120, 24, 24, 64), (4, 64, 64, 128), (2, 24, 24, 256)],
                         ids=["widest-round", "h128", "h256"])
def test_3xtf32_products_meet_the_round_kernels_bounds(P, na, nt, H):
    """The widest round of the block step (P 120, na = nt = 24, H 64: K 64
    in gh and d w_hh, K 192 in d h_e), and H 128 and 256 (K up to 768):
    3xTF32 within the bounds, plain TF32 more than ten times outside."""
    sign = -1.0
    args, cots = round_problem(H, P, na, nt, H)
    outs, grads = jax_round(tuple(map(jnp.asarray, args)), tuple(map(jnp.asarray, cots)), sign)
    want_f = [torch.from_numpy(np.array(o)) for o in outs]
    want_b = [torch.from_numpy(np.array(g)).reshape(a.shape) for g, a in zip(grads, args)]
    assert misses(mm_3xtf32, args, cots, sign, want_f, want_b) < 1
    assert misses(mm_tf32, args, cots, sign, want_f, want_b) > 10


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12, -(1.0 + 2.0 ** -11),
                      3.0e-3, -7.25e5])
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                         -(1.0 + 2.0 ** -10)])
    got = tf32(x)
    assert torch.equal(got[:4], want)  # ties away from zero, both signs
    assert torch.all((got.view(torch.int32) & 0x1FFF) == 0)
    assert torch.all((x - got).abs() <= x.abs() * 2.0 ** -11)
    small = tf32(x - got)
    assert torch.all((x - got - small).abs() <= x.abs() * 2.0 ** -22)


def test_round_width_rule_takes_every_multiple_of_8_to_256():
    for H in range(8, 257, 8):
        assert block.round_widths(64, 64, H) == (64, 64, H)
    assert block.round_widths(5, 40, 40) == (5, 40, 40)
    assert block.round_widths(0, 7, 64) == (0, 7, 64)


@pytest.mark.parametrize("H", [12, 264, 4, 0])
def test_round_width_rule_refuses_other_widths_by_name(H):
    with pytest.raises(ValueError, match=f"H={H}"):
        block.round_widths(24, 24, H)
    # the wrappers' check names the kernel too, before any library is built
    with pytest.raises(ValueError, match=f"block_round_fwd: .*H={H}"):
        block._round_library("block_round_fwd", 24, 24, H)


def test_round_width_rule_is_evaluated_once_per_widths():
    block.round_widths.cache_clear()
    for _ in range(3):
        block.round_widths(64, 64, 128)
        block.round_widths(24, 24, 64)
    info = block.round_widths.cache_info()
    assert (info.misses, info.hits) == (2, 4)
