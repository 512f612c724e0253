"""Modulated deformable convolution v2 (the counterpart of
trackmpnn_tpu/backbones/deform_conv.py), in two forms:

  * `deform_conv2d`, the exact arbitrary-offset form: a 4-neighbour
    bilinear gather of the deformed taps and one product with the weight,
    plain PyTorch (in the JAX package it is XLA code).  Autograd gives the
    usual floor-based gradient, as jax.grad does there.  DLA-34 runs it by
    default, and converted reference checkpoints, whose offsets are
    unbounded, need it.
  * `deform_conv2d_shift`, offsets clamped to +-max_offset: the hand-written
    CUDA kernels of ops/dcn.py (kernel #15 and its backward), whose offset
    gradient is the JAX VJP's, exactly 0 at an integer offset.

Convention (DCNv2's): offset channels are (dy, dx) pairs per tap, taps in
row-major (kh, kw) order; sampling outside the input is zero; the mask
multiplies the sample before the weight.  The functions take the JAX
package's layouts (x [N, H, W, C], weight [K*K*C, O], offset [N, Ho, Wo,
2*K*K], mask [N, Ho, Wo, K*K]); the DCN module is NCHW like the rest of the
backbones and holds its weight as [O, C, K, K], the reference's layout.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from trackmpnn_tpu_torch.ops import dcn as dcn_ops


def _gather_bilinear(x, ys, xs):
    """x [N, H, W, C]; ys, xs [N, ...] float sample coordinates.  Zero
    outside the image.  Returns [N, ..., C]."""
    N, H, W, C = x.shape
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = ys - y0, xs - x0
    y0i, x0i = y0.long(), x0.long()
    flat = x.reshape(N * H * W, C)
    base = (torch.arange(N, device=x.device) * (H * W)).reshape((N,) + (1,) * (ys.dim() - 1))

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        v = flat[base + yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)]
        return torch.where(valid[..., None], v, 0.0)

    v00, v01 = tap(y0i, x0i), tap(y0i, x0i + 1)
    v10, v11 = tap(y0i + 1, x0i), tap(y0i + 1, x0i + 1)
    wy, wx = wy[..., None], wx[..., None]
    return ((1 - wy) * (1 - wx) * v00 + (1 - wy) * wx * v01
            + wy * (1 - wx) * v10 + wy * wx * v11)


def bilinear_sample(x, ys, xs):
    """x [H, W, C]; ys, xs [...] float sample coordinates.  Zero padding
    outside (deform_conv.py:42).  Returns [..., C]."""
    return _gather_bilinear(x[None], ys[None], xs[None])[0]


def deform_conv2d(x, weight, bias, offset, mask, *, stride=1, padding=1, dilation=1, ksize=3):
    """The exact form (deform_conv.py:72): x [N, H, W, Cin]; weight
    [K*K*Cin, Cout]; bias [Cout] or None; offset [N, Ho, Wo, 2*K*K]; mask
    [N, Ho, Wo, K*K].  Returns [N, Ho, Wo, Cout]."""
    N, H, W, Cin = x.shape
    K = ksize
    Ho = (H + 2 * padding - dilation * (K - 1) - 1) // stride + 1
    Wo = (W + 2 * padding - dilation * (K - 1) - 1) // stride + 1
    dev, f32 = x.device, x.dtype
    oy = torch.arange(Ho, device=dev, dtype=f32) * stride - padding
    ox = torch.arange(Wo, device=dev, dtype=f32) * stride - padding
    kk = torch.arange(K, device=dev, dtype=f32) * dilation
    base_y = (oy[:, None, None, None] + kk[None, None, :, None]).expand(Ho, Wo, K, K)
    base_x = (ox[None, :, None, None] + kk[None, None, None, :]).expand(Ho, Wo, K, K)
    off = offset.reshape(N, Ho, Wo, K * K, 2)
    ys = base_y.reshape(Ho, Wo, K * K) + off[..., 0]
    xs = base_x.reshape(Ho, Wo, K * K) + off[..., 1]
    cols = _gather_bilinear(x, ys, xs) * mask[..., None]  # [N, Ho, Wo, K*K, Cin]
    out = cols.reshape(N, Ho, Wo, K * K * Cin) @ weight
    return out if bias is None else out + bias


def deform_conv2d_shift(x, weight, bias, offset, mask, *, stride=1, padding=1, dilation=1,
                        ksize=3, max_offset=8.0):
    """The bounded form (deform_conv.py:110) on the kernels of ops/dcn.py:
    offsets clamped to +-max_offset.  The kernels take the geometry DLA-34
    uses, 3x3 taps with stride, padding and dilation 1."""
    if (stride, padding, dilation, ksize) != (1, 1, 1, 3):
        raise ValueError("deform_conv2d_shift runs 3x3 taps with stride, padding and dilation "
                         f"1; got stride={stride}, padding={padding}, dilation={dilation}, "
                         f"ksize={ksize}")
    return dcn_ops.deform_conv_shift(x, weight, bias, offset, mask, max_offset)


class DCN(nn.Module):
    """DCNv2 (init_dcn + apply_dcn, deform_conv.py:254-298): a 3x3 offset /
    mask conv, zero-initialised so that training starts as a regular conv,
    then the deformable conv.  NCHW in and out.

    max_offset None runs the exact form; a float runs the bounded kernels.
    Keys: weight [O, C, 3, 3], bias [O], conv_offset_mask.{weight, bias}
    (27 channels: (dy, dx) of the 9 taps, then the 9 mask logits)."""

    K = 3

    def __init__(self, cin: int, cout: int, max_offset=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        K = self.K
        self.max_offset = max_offset
        std = math.sqrt(2.0 / (K * K * cout))
        self.weight = nn.Parameter(torch.empty(cout, cin, K, K).normal_(0.0, std,
                                                                       generator=generator))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.conv_offset_mask = nn.Conv2d(cin, 3 * K * K, K, padding=1, bias=True)
        nn.init.zeros_(self.conv_offset_mask.weight)
        nn.init.zeros_(self.conv_offset_mask.bias)

    def forward(self, x):
        kk = self.K * self.K
        om = self.conv_offset_mask(x).permute(0, 2, 3, 1)
        offset = om[..., :2 * kk]
        mask = torch.sigmoid(om[..., 2 * kk:])
        weight = self.weight.permute(2, 3, 1, 0).reshape(kk * self.weight.shape[1], -1)
        x = x.permute(0, 2, 3, 1)
        if self.max_offset is None:
            out = deform_conv2d(x, weight, self.bias, offset, mask)
        else:
            out = deform_conv2d_shift(x, weight, self.bias, offset, mask,
                                      max_offset=self.max_offset)
        return out.permute(0, 3, 1, 2)
