"""The arithmetic of the bounded deformable convolution's tensor-core
kernels (trackmpnn_tpu_torch/csrc/dcn_kernels.cu: dcn_fwd and the fused
dcn_bwd_sample), emulated in PyTorch on the CPU, against the JAX package on
the same numpy-made inputs.

  * The forward: the masked samples sum_j (w_j * mask) x_j built from the
    four neighbours, the product in split TF32 (3xTF32) over (16-channel
    chunk, tap, k step of 8 channels) in the kernel's order, each k step
    into a fresh accumulator added in f32, the taps in 1, 3 or 9 groups
    whose partial outputs are summed in group order before the bias;
    against deform_conv2d_shift and
    interpret-mode deform_conv2d_shift_pallas within 1e-5 x the output's
    scale.  Plain TF32 (each operand rounded once) misses that tolerance.
  * The backward's d weight: one partial a pixel slice (slices of 32-pixel
    tiles, k steps of 8 pixels, 3xTF32 into fresh accumulators), the
    partials summed in slice order (empty slices included); d offset and d
    mask from r_j = sum_c x_j[c] dcols[c] in parts (each CTA's channel
    groups of its 64-channel tile), the parts summed in order: against
    jax.vjp of deform_conv2d_shift, rtol 1e-4 and atol 1e-5 x each output's
    scale, the offset gradient exactly 0 at integer offsets.
  * The plain dcn_sample_backward_reference (the columns, then columns^T g)
    against the same VJP at integer, fractional, beyond-bound and mixed
    offsets.
  * dcn_bwd_dx's order: per 8 x 16 tile of input pixels and tap, the
    neighbours and weights (hat_y * hat_x) * mask of every output pixel of
    the tile's halo (R + 2 before, R + 1 after), each target's list of
    (weight, dcols row) in halo order, the target's sum taps outer; against
    jax.vjp's d x at R 1, 2 and 8 (integer, fractional, beyond-bound and
    mixed offsets at R 2) on maps whose height and width are not whole
    tiles, rtol 1e-4 and atol 1e-5 x the scale.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import DCN_KEYS, dcn_inputs, mm_3xtf32, mm_tf32
from trackmpnn_tpu.backbones import deform_conv as DC
from trackmpnn_tpu.ops.pallas_dcn import deform_conv2d_shift_pallas
from trackmpnn_tpu_torch.ops import dcn

torch.set_num_threads(1)

BOUND = 2.0
K_STEP = 8            # the m16n8k8 depth: channels (forward) or pixels (d weight) a k step
CHUNK = 16            # dcn_fwd's channels of a tap a step
PIXEL_TILE = 32       # dcn_bwd_sample's pixels a step
CHANNEL_TILE = 64     # dcn_bwd_sample's channels of d weight's tile
OUTPUT_TILE = 64      # and its outputs
BWD_SHAPE = dict(N=2, H=7, W=9, C=72, O=72)  # two channel and two output tiles, ragged


@jax.jit
def shift_vjp(args, g):
    """deform_conv2d_shift (max_offset 2) and its VJP at g."""
    out, vjp = jax.vjp(lambda *a: DC.deform_conv2d_shift(*a, max_offset=BOUND), *args)
    return out, vjp(g)


def t(a):
    return torch.from_numpy(np.array(a))


def close_scaled(got, want, rtol, atol_scale, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol_scale * max(float(np.abs(want).max()), 1e-30),
                               err_msg=msg)


def neighbours(x, off, mask, bound):
    """As the kernels resolve them, for each tap k and neighbour j in the
    order (y0, x0), (y0, x0+1), (y0+1, x0), (y0+1, x0+1): the neighbour's
    rows of x [P, C] (zeros outside the image) and its bilinear weight [P]
    without and with the mask; and the fractions fy, fx [P, 9]."""
    N, H, W, C = x.shape
    d = off.reshape(N, H, W, 9, 2).clamp(-bound, bound)
    base = torch.floor(d)
    frac = d - base
    y = torch.arange(H)[None, :, None]
    xx = torch.arange(W)[None, None, :]
    n = torch.arange(N)[:, None, None]
    flat = x.reshape(-1, C)
    rows, weights, masked = [], [], []
    for k in range(9):
        y0 = y - 1 + k // 3 + base[..., k, 0].long()
        x0 = xx - 1 + k % 3 + base[..., k, 1].long()
        rk, wk, mk = [], [], []
        for j in range(4):
            yy, xb = y0 + (j >> 1), x0 + (j & 1)
            inside = ((yy >= 0) & (yy < H) & (xb >= 0) & (xb < W)).reshape(-1)
            idx = ((n * H + yy.clamp(0, H - 1)) * W + xb.clamp(0, W - 1)).reshape(-1)
            wy = frac[..., k, 0] if j >> 1 else 1 - frac[..., k, 0]
            wx = frac[..., k, 1] if j & 1 else 1 - frac[..., k, 1]
            w = (wy * wx).reshape(-1)
            rk.append(torch.where(inside[:, None], flat[idx], 0.0))
            wk.append(w)
            mk.append(torch.where(inside, w * mask[..., k].reshape(-1), 0.0))
        rows.append(rk)
        weights.append(wk)
        masked.append(mk)
    return rows, weights, masked, frac.reshape(-1, 9, 2)


def columns(rows, masked):
    """[P, 9, C]: the masked samples sum_j (w_j * mask) x_j, j in order."""
    cols = []
    for k in range(9):
        s = torch.zeros_like(rows[k][0])
        for j in range(4):
            s = s + masked[k][j][:, None] * rows[k][j]
        cols.append(s)
    return torch.stack(cols, 1)


def forward_emulated(x, weight, bias, off, mask, groups, mm=mm_3xtf32):
    """dcn_fwd's arithmetic: steps of (16-channel chunk, tap), taps inner,
    each of its two k steps of 8 channels into a fresh accumulator added in
    f32; with tap groups, each group's sum from 0, the groups added in order,
    then the bias."""
    N, H, W, C = x.shape
    O = weight.shape[1]
    rows, _, masked, _ = neighbours(x, off, mask, BOUND)
    a = columns(rows, masked)
    w3 = weight.reshape(9, C, O)
    out = None
    for z in range(groups):
        acc = torch.zeros(a.shape[0], O)
        for c0 in range(0, C, CHUNK):
            for k in range(z * 9 // groups, (z + 1) * 9 // groups):
                for c1 in range(c0, min(C, c0 + CHUNK), K_STEP):
                    acc = acc + mm(a[:, k, c1:c1 + K_STEP], w3[k, c1:c1 + K_STEP])
        out = acc if out is None else out + acc
    return (out + bias).reshape(N, H, W, O)


def dweight_emulated(x, off, mask, g, slices):
    """dcn_bwd_sample's d weight: slice s takes the 32-pixel tiles [s per,
    (s + 1) per), per = ceil(tiles / slices); its partial sums k steps of 8
    pixels of cols^T g in 3xTF32 into fresh accumulators; the partials are
    added in slice order."""
    rows, _, masked, _ = neighbours(x, off, mask, BOUND)
    a = columns(rows, masked)                     # [P, 9, C]
    g2 = g.reshape(-1, g.shape[-1])
    P = a.shape[0]
    tiles = math.ceil(P / PIXEL_TILE)
    per = math.ceil(tiles / slices)
    total = None
    for s in range(slices):
        lo = min(P, s * per * PIXEL_TILE)
        hi = min(P, (s + 1) * per * PIXEL_TILE)
        acc = torch.zeros(9, a.shape[2], g2.shape[1])
        for p0 in range(lo, hi, K_STEP):
            acc = acc + mm_3xtf32(a[p0:p0 + K_STEP].permute(1, 2, 0), g2[p0:p0 + K_STEP])
        total = acc if total is None else total + acc
    return total.reshape(-1, g2.shape[1])


def offset_mask_emulated(x, off, mask, dcols, O):
    """d offset and d mask from r_j in parts: the CTA of channel tile ct
    (64 channels) and output tile ot (of nout = ceil(O / 64)) sums the groups
    of 8 channels q of its tile with q % nout == ot; each part's (d mask, d
    dy, d dx) is added in (ct, ot) order, then the clamp's gradient (1
    inside, 1/2 at the bound, 0 outside)."""
    N, H, W, C = x.shape
    rows, weights, _, frac = neighbours(x, off, mask, BOUND)
    d = dcols.reshape(-1, 9, C)
    m = mask.reshape(-1, 9)
    w = [torch.stack([weights[k][j] for k in range(9)], 1) for j in range(4)]
    fy, fx = frac[..., 0], frac[..., 1]
    nout = math.ceil(O / OUTPUT_TILE)
    dm = ddy = ddx = None
    for c0 in range(0, C, CHANNEL_TILE):
        for ot in range(nout):
            ch = [c for c in range(c0, min(C, c0 + CHANNEL_TILE)) if (c - c0) // 8 % nout == ot]
            r = [torch.stack([(rows[k][j][:, ch] * d[:, k, ch]).sum(1) for k in range(9)], 1)
                 for j in range(4)]                  # [P, 9] each
            part_m = w[0] * r[0] + w[1] * r[1] + w[2] * r[2] + w[3] * r[3]
            part_y = torch.where(fy > 0, m * ((1 - fx) * (r[2] - r[0]) + fx * (r[3] - r[1])), 0.0)
            part_x = torch.where(fx > 0, m * ((1 - fy) * (r[1] - r[0]) + fy * (r[3] - r[2])), 0.0)
            dm = part_m if dm is None else dm + part_m
            ddy = part_y if ddy is None else ddy + part_y
            ddx = part_x if ddx is None else ddx + part_x
    doff = torch.stack([ddy, ddx], -1) * dcn._clip_grad(off.reshape(-1, 9, 2), BOUND)
    return doff.reshape(N, H, W, 18), dm.reshape(N, H, W, 9)


@pytest.mark.parametrize("shape,groups", [(dict(N=2, H=6, W=10, C=64, O=16), 1),
                                          (dict(N=2, H=6, W=10, C=64, O=16), 3),
                                          (dict(N=2, H=7, W=9, C=5, O=4), 9)])
def test_forward_emulation_matches_jax_and_pallas(shape, groups):
    """The 3xTF32 forward within 1e-5 x the output's scale of
    deform_conv2d_shift and of interpret-mode deform_conv2d_shift_pallas;
    plain TF32 misses it where the taps hold 576 products."""
    x = dcn_inputs(11, kind="mixed", **shape)
    args = [x[k] for k in DCN_KEYS[:5]]
    got = forward_emulated(*map(t, args), groups=groups).numpy()
    want = np.asarray(jax.jit(lambda *a: DC.deform_conv2d_shift(*a, max_offset=BOUND))(
        *map(jnp.asarray, args)))
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 1e-5 * scale
    pallas = deform_conv2d_shift_pallas(*(jnp.asarray(a[1]) if a.ndim == 4 else jnp.asarray(a)
                                          for a in args), max_offset=BOUND, tile_h=4,
                                        interpret=True)
    assert float(np.abs(got[1] - np.asarray(pallas)).max()) <= 1e-5 * scale
    if shape["C"] == 64:
        tf32_only = forward_emulated(*map(t, args), groups=groups, mm=mm_tf32).numpy()
        assert float(np.abs(tf32_only - want).max()) > 1e-5 * scale


@pytest.mark.parametrize("kind", ["mixed", "int"])
def test_fused_backward_emulation_matches_jax_vjp(kind):
    """d weight over 1, 2 and 3 pixel slices (4 tiles of 32: the third slice
    empty) and d offset, d mask in parts over two channel and two output
    tiles, against jax.vjp."""
    x = dcn_inputs(12, kind=kind, **BWD_SHAPE)
    args = tuple(jnp.asarray(x[k]) for k in DCN_KEYS[:5])
    _, (_, want_w, _, want_off, want_m) = shift_vjp(args, jnp.asarray(x["g"]))
    xs, w, off, m, g = (t(x[k]) for k in ("x", "weight", "offset", "mask", "g"))
    N, H, W, C = xs.shape
    dcols = (g.reshape(-1, w.shape[1]) @ w.t()).reshape(N, H, W, 9 * C)
    for slices in (1, 2, 3):
        close_scaled(dweight_emulated(xs, off, m, g, slices).numpy(), want_w, 1e-4, 1e-5,
                     f"d weight, {slices} slices")
    doff, dmask = offset_mask_emulated(xs, off, m, dcols, g.shape[-1])
    close_scaled(doff.numpy(), want_off, 1e-4, 1e-5, "d offset")
    close_scaled(dmask.numpy(), want_m, 1e-4, 1e-5, "d mask")
    if kind == "int":
        assert not doff.any()


@pytest.mark.parametrize("kind", ["int", "frac", "beyond", "mixed"])
def test_plain_sample_backward_matches_jax_vjp(kind):
    """dcn_sample_backward_reference's d weight, d offset and d mask."""
    x = dcn_inputs(13, kind=kind, **BWD_SHAPE)
    args = tuple(jnp.asarray(x[k]) for k in DCN_KEYS[:5])
    _, (_, want_w, _, want_off, want_m) = shift_vjp(args, jnp.asarray(x["g"]))
    xs, w, off, m, g = (t(x[k]) for k in ("x", "weight", "offset", "mask", "g"))
    N, H, W, C = xs.shape
    dcols = (g.reshape(-1, w.shape[1]) @ w.t()).reshape(N, H, W, 9 * C)
    dweight, doff, dmask = dcn.dcn_sample_backward_reference(xs, off, m, dcols, g, BOUND)
    for name, got, want in (("weight", dweight, want_w), ("offset", doff, want_off),
                            ("mask", dmask, want_m)):
        close_scaled(got.numpy(), want, 1e-4, 1e-5, name)
    if kind == "int":
        assert not doff.any()


DX_TH, DX_TW = 8, 16  # dcn_bwd_dx's tile of input pixels


@functools.lru_cache(maxsize=None)
def bounded_vjp(bound):
    """shift_vjp at another max_offset."""
    if bound == BOUND:
        return shift_vjp
    return jax.jit(lambda args, g: (lambda out, vjp: (out, vjp(g)))(
        *jax.vjp(lambda *a: DC.deform_conv2d_shift(*a, max_offset=bound), *args)))


def dx_emulated(off, mask, dcols, bound):
    """dcn_bwd_dx's arithmetic: for each tile and tap, the halo pixels'
    entries (target, weight, dcols row) in halo order, each target's list
    summed in order into its accumulator (taps outer)."""
    N, H, W, C9 = dcols.shape
    C = C9 // 9
    R = dcn.reach(bound)
    d = off.reshape(N, H, W, 9, 2).clamp(-bound, bound)
    m = mask.reshape(N, H, W, 9)
    g = dcols.reshape(N, H, W, 9, C)
    dx = torch.zeros(N, H, W, C)
    for n in range(N):
        for ty0 in range(0, H, DX_TH):
            for tx0 in range(0, W, DX_TW):
                oy, ox = ty0 - R - 2, tx0 - R - 2
                hy = torch.arange(DX_TH + 2 * R + 3)[:, None] + oy
                hx = torch.arange(DX_TW + 2 * R + 3)[None, :] + ox
                hy, hx = torch.broadcast_to(hy, (hy.shape[0], hx.shape[1])).reshape(-1), \
                    torch.broadcast_to(hx, (hy.shape[0], hx.shape[1])).reshape(-1)
                inside = (hy >= 0) & (hy < H) & (hx >= 0) & (hx < W)
                py, px = hy[inside], hx[inside]  # the halo's pixels, row-major
                acc = torch.zeros(DX_TH * DX_TW, C)
                for k in range(9):
                    dy, dxo = d[n, py, px, k, 0], d[n, py, px, k, 1]
                    fy0, fx0 = torch.floor(dy), torch.floor(dxo)
                    fy, fx = dy - fy0, dxo - fx0
                    y0 = py - 1 + k // 3 + fy0.long() - ty0
                    x0 = px - 1 + k % 3 + fx0.long() - tx0
                    targets, weights, src = [], [], []
                    for j in range(4):
                        yy, xx = y0 + (j >> 1), x0 + (j & 1)
                        wt = (fy if j >> 1 else 1 - fy) * (fx if j & 1 else 1 - fx) * m[n, py, px, k]
                        ok = ((yy >= 0) & (yy < DX_TH) & (xx >= 0) & (xx < DX_TW)
                              & (ty0 + yy < H) & (tx0 + xx < W) & (wt != 0))
                        targets.append(torch.where(ok, yy * DX_TW + xx, -1))
                        weights.append(wt)
                        src.append(torch.arange(len(py)))
                    # entries in halo order (pixel, then neighbour)
                    t = torch.stack(targets, 1).reshape(-1)
                    w = torch.stack(weights, 1).reshape(-1)
                    i = torch.stack(src, 1).reshape(-1)
                    keep = t >= 0
                    t, w, i = t[keep], w[keep], i[keep]
                    order = torch.sort(t, stable=True).indices
                    t, w, i = t[order], w[order], i[order]
                    start = torch.searchsorted(t, t, right=False)
                    rank = torch.arange(len(t)) - start
                    rows = g[n, py[i], px[i], k]
                    for r in range(int(rank.max()) + 1 if len(t) else 0):
                        sel = rank == r
                        acc[t[sel]] = acc[t[sel]] + w[sel, None] * rows[sel]
                ys, xs = torch.meshgrid(torch.arange(DX_TH) + ty0, torch.arange(DX_TW) + tx0,
                                        indexing="ij")
                ok = ((ys < H) & (xs < W)).reshape(-1)
                dx[n, ys.reshape(-1)[ok], xs.reshape(-1)[ok]] = acc[ok]
    return dx


@pytest.mark.parametrize("kind,bound", [("int", 2.0), ("frac", 2.0), ("beyond", 2.0),
                                        ("mixed", 2.0), ("mixed", 1.0), ("mixed", 8.0)])
def test_dx_emulation_matches_jax_vjp(kind, bound):
    """dcn_bwd_dx's halo lists and target sums on an 11 x 19 map (2 x 2
    tiles, both ragged) against jax.vjp's d x."""
    x = dcn_inputs(14, N=2, H=11, W=19, C=5, O=4, kind=kind, max_offset=bound)
    args = tuple(jnp.asarray(x[k]) for k in DCN_KEYS[:5])
    _, (want, *_) = bounded_vjp(bound)(args, jnp.asarray(x["g"]))
    xs, w, off, m, g = (t(x[k]) for k in ("x", "weight", "offset", "mask", "g"))
    N, H, W, C = xs.shape
    dcols = (g.reshape(-1, w.shape[1]) @ w.t()).reshape(N, H, W, 9 * C)
    close_scaled(dx_emulated(off, m, dcols, bound).numpy(), want, 1e-4, 1e-5, "d x")
