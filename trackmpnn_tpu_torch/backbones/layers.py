"""Conv-net primitives of the appearance backbones (the counterpart of
trackmpnn_tpu/backbones/layers.py), in PyTorch's idiom: nn.Modules on NCHW
tensors, nn.Conv2d weights [O, I/groups, kh, kw], BatchNorm's running
statistics as buffers.

State-dict keys are the JAX package's flat parameter names, which are the
reference's torch module paths (layers.py:4-7), so weights carry across by
key with a per-key layout change (backbones/weights.py).

BatchNorm follows nn.BatchNorm2d(eps 1e-5, momentum 0.1), as the JAX bn2d
(:96-144) does: in eval mode it normalises by the running statistics; in
train mode by the biased batch variance, folding the unbiased one into the
buffers.  The embedding trainer decides the mode (train/embed.py).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def same_padding(k: int, dilation: int = 1) -> int:
    """The JAX package's "SAME_TORCH" padding: (k - 1) // 2 * dilation a side
    (layers.py:73)."""
    return (k - 1) // 2 * dilation


def conv(cin: int, cout: int, k: int, stride: int = 1, groups: int = 1, dilation: int = 1,
         bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=same_padding(k, dilation),
                     dilation=dilation, groups=groups, bias=bias)


def bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)


def avg_pool2d(x, ksize: int = 3, stride: int = 2, padding: int = 1):
    """F.avg_pool2d with count_include_pad: the window sum over k^2
    (layers.py:152)."""
    return F.avg_pool2d(x, ksize, stride, padding, count_include_pad=True)


def resize_bilinear_align_corners(x, out_h: int, out_w: int):
    """Bilinear resize on the align_corners=True grid, i_src = i_dst * (in-1)
    / (out-1) (layers.py:162-184).  A size-1 axis, in or out, reads index 0,
    as the JAX function's degenerate branch does."""
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=True)


def upsample2x(x):
    return resize_bilinear_align_corners(x, x.shape[2] * 2, x.shape[3] * 2)


# ------------------------------------------------------------------- init ----
def kaiming_fan_out_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """normal(0, sqrt(2 / fan_out)), fan_out = k * k * O, in place (conv_init,
    layers.py:193: the reference's kaiming_normal_(mode='fan_out'))."""
    k = w.shape[-1]
    std = math.sqrt(2.0 / (k * k * w.shape[0]))
    with torch.no_grad():
        return w.normal_(0.0, std, generator=generator)


def init_convs_(module: nn.Module, generator: torch.Generator) -> None:
    """Every nn.Conv2d weight in `module` kaiming fan_out; biases left to the
    caller."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            kaiming_fan_out_(m.weight, generator)


# ---------------------------------------------------------------- modules ----
class CBR(nn.Module):
    """conv -> BN -> PReLU (apply_cbr, keys .conv .bn .act)."""

    def __init__(self, cin, cout, k, stride=1, groups=1, dilation=1):
        super().__init__()
        self.conv = conv(cin, cout, k, stride, groups, dilation)
        self.bn = bn(cout)
        self.act = nn.PReLU(cout)

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class CB(nn.Module):
    """conv -> BN (apply_cb)."""

    def __init__(self, cin, cout, k, stride=1, groups=1):
        super().__init__()
        self.conv = conv(cin, cout, k, stride, groups)
        self.bn = bn(cout)

    def forward(self, x):
        return self.bn(self.conv(x))


class BR(nn.Module):
    """BN -> PReLU (apply_br)."""

    def __init__(self, c):
        super().__init__()
        self.bn = bn(c)
        self.act = nn.PReLU(c)

    def forward(self, x):
        return self.act(self.bn(x))


class C(nn.Module):
    """A bias-free conv under the key .conv."""

    def __init__(self, cin, cout, k, stride=1, groups=1, dilation=1):
        super().__init__()
        self.conv = conv(cin, cout, k, stride, groups, dilation)

    def forward(self, x):
        return self.conv(x)
