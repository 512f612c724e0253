"""DLA-34 with deformable-conv upsampling, the 'dla34' embedding backbone
(the counterpart of trackmpnn_tpu/backbones/dla.py; behavioural spec the
reference's models/dla/pose_dla_dcn.py).

The DLA-34 base (trees of BasicBlocks), DLAUp / IDAUp iterative deep
aggregation whose projections and nodes are DeformConv blocks (DCNv2 + BN +
ReLU) and whose upsampling is a depthwise ConvTranspose2d with bilinear
initial weights, and the DLASeg heads ('trk' for the 128-d embedding map).
NCHW.  Module paths are the JAX package's parameter names.  DLA-34 has 16
deform blocks: 12 in DLAUp (1 + 2 + 3 IDAUp pairs) and 4 in the final
IDAUp; `dcn_max_offset` None runs them all in the exact form, a float
through the bounded kernels (backbones/deform_conv.py).

`load_pretrained` (dla.py:271), which reads downloaded ImageNet weights, is
not ported (ROADMAP.md queue 1, 'Tail').
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from trackmpnn_tpu_torch.backbones import layers as L
from trackmpnn_tpu_torch.backbones.deform_conv import DCN

DLA34_CHANNELS = [16, 32, 64, 128, 256, 512]


def conv_bn_relu(cin, cout, k, stride=1):
    """conv -> BN -> ReLU under keys .0, .1 (the reference's _make_conv_level)."""
    return nn.Sequential(L.conv(cin, cout, k, stride), L.bn(cout), nn.ReLU())


def bilinear_up_kernel(f: int) -> np.ndarray:
    """fill_up_weights' bilinear kernel for a (2f x 2f) stride-f up-conv."""
    k = 2 * f
    fc = math.ceil(k / 2)
    c = (2 * fc - 1 - fc % 2) / (2.0 * fc)
    w = np.zeros((k, k), np.float32)
    for i in range(k):
        for j in range(k):
            w[i, j] = (1 - abs(i / fc - c)) * (1 - abs(j / fc - c))
    return w


def depthwise_up(o: int, f: int) -> nn.ConvTranspose2d:
    """ConvTranspose2d(o, o, 2f, stride f, padding f // 2, groups o) with the
    bilinear kernel (depthwise_conv_transpose, dla.py:69)."""
    up = nn.ConvTranspose2d(o, o, 2 * f, stride=f, padding=f // 2, groups=o, bias=False)
    with torch.no_grad():
        up.weight.copy_(torch.from_numpy(bilinear_up_kernel(f))[None, None].expand(o, 1, -1, -1))
    return up


class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1 = L.conv(cin, cout, 3, stride)
        self.bn1 = L.bn(cout)
        self.conv2 = L.conv(cout, cout, 3)
        self.bn2 = L.bn(cout)

    def forward(self, x, residual):
        out = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(out)) + residual)


class Root(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = L.conv(cin, cout, 1)
        self.bn = L.bn(cout)

    def forward(self, xs):
        return F.relu(self.bn(self.conv(torch.cat(xs, 1))))


class Tree(nn.Module):
    """init_tree / apply_tree (dla.py:104-151)."""

    def __init__(self, levels, cin, cout, stride=1, level_root=False, root_dim=0):
        super().__init__()
        if root_dim == 0:
            root_dim = 2 * cout
        if level_root:
            root_dim += cin
        self.levels, self.stride, self.level_root = levels, stride, level_root
        if levels == 1:
            self.tree1 = BasicBlock(cin, cout, stride)
            self.tree2 = BasicBlock(cout, cout)
            self.root = Root(root_dim, cout)
        else:
            self.tree1 = Tree(levels - 1, cin, cout, stride)
            self.tree2 = Tree(levels - 1, cout, cout, root_dim=root_dim + cout)
        self.project = (nn.Sequential(L.conv(cin, cout, 1), L.bn(cout)) if cin != cout
                        else None)

    def forward(self, x, children=None):
        children = [] if children is None else children
        bottom = F.max_pool2d(x, self.stride, self.stride) if self.stride > 1 else x
        residual = self.project(bottom) if self.project is not None else bottom
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            x1 = self.tree1(x, residual)
            x2 = self.tree2(x1, x1)
            return self.root([x2, x1] + children)
        x1 = self.tree1(x)
        children.append(x1)
        return self.tree2(x1, children=children)


class DLABase(nn.Module):
    """The DLA-34 base (init_dla34_base / apply_dla34_base): six levels."""

    def __init__(self):
        super().__init__()
        ch = DLA34_CHANNELS
        self.base_layer = conv_bn_relu(3, ch[0], 7)
        self.level0 = conv_bn_relu(ch[0], ch[0], 3)
        self.level1 = conv_bn_relu(ch[0], ch[1], 3, stride=2)
        self.level2 = Tree(1, ch[1], ch[2], stride=2)
        self.level3 = Tree(2, ch[2], ch[3], stride=2, level_root=True)
        self.level4 = Tree(2, ch[3], ch[4], stride=2, level_root=True)
        self.level5 = Tree(1, ch[4], ch[5], stride=2, level_root=True)

    def forward(self, x) -> List[torch.Tensor]:
        x = self.base_layer(x)
        y = []
        for name in ("level0", "level1", "level2", "level3", "level4", "level5"):
            x = getattr(self, name)(x)
            y.append(x)
        return y


class DeformConv(nn.Module):
    """DCN -> BN -> ReLU (init/apply_deform_block, keys .conv and .actf.0)."""

    def __init__(self, cin, cout, max_offset=None, generator=None):
        super().__init__()
        self.actf = nn.Sequential(L.bn(cout), nn.ReLU())
        self.conv = DCN(cin, cout, max_offset, generator)

    def forward(self, x):
        return self.actf(self.conv(x))


class IDAUp(nn.Module):
    """init_ida_up / apply_ida_up (dla.py:211-237): proj_i, up_i, node_i."""

    def __init__(self, o, channels, up_f, max_offset=None, generator=None):
        super().__init__()
        for i in range(1, len(channels)):
            setattr(self, f"proj_{i}", DeformConv(channels[i], o, max_offset, generator))
            setattr(self, f"up_{i}", depthwise_up(o, int(up_f[i])))
            setattr(self, f"node_{i}", DeformConv(o, o, max_offset, generator))

    def forward(self, layers, startp, endp):
        for i in range(startp + 1, endp):
            r = i - startp
            x = getattr(self, f"up_{r}")(getattr(self, f"proj_{r}")(layers[i]))
            layers[i] = getattr(self, f"node_{r}")(x + layers[i - 1])


class DLAUp(nn.Module):
    def __init__(self, channels, scales, max_offset=None, generator=None):
        super().__init__()
        in_ch, sc = list(channels), np.array(scales, int)
        self.n = len(channels) - 1
        for i in range(self.n):
            j = -i - 2
            setattr(self, f"ida_{i}", IDAUp(channels[j], in_ch[j:], (sc[j:] // sc[j]).tolist(),
                                            max_offset, generator))
            sc[j + 1:] = sc[j]
            in_ch[j + 1:] = [channels[j] for _ in channels[j + 1:]]

    def forward(self, layers):
        out = [layers[-1]]
        for i in range(self.n):
            getattr(self, f"ida_{i}")(layers, len(layers) - i - 2, len(layers))
            out.insert(0, layers[-1])
        return out


class DLASeg(nn.Module):
    """init_dlaseg / apply_dlaseg (dla.py:243, :320): x [N, 3, H, W] ->
    {head: [N, classes, H / down_ratio, W / down_ratio]}."""

    def __init__(self, heads: Dict[str, int], head_conv: int = 256, down_ratio: int = 4,
                 last_level: int = 5, dcn_max_offset=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.heads, self.head_conv = dict(heads), head_conv
        self.first, self.last_level = int(np.log2(down_ratio)), last_level
        ch = DLA34_CHANNELS
        self.base = DLABase()
        chans = ch[self.first:]
        self.dla_up = DLAUp(chans, [2 ** i for i in range(len(chans))], dcn_max_offset,
                            generator)
        self.ida_up = IDAUp(ch[self.first], ch[self.first:last_level],
                            [2 ** i for i in range(last_level - self.first)], dcn_max_offset,
                            generator)
        for head, classes in self.heads.items():
            bias = -2.19 if "hm" in head else 0.0
            if head_conv > 0:
                h = nn.Sequential(nn.Conv2d(ch[self.first], head_conv, 3, padding=1),
                                  nn.ReLU(), nn.Conv2d(head_conv, classes, 1))
                nn.init.zeros_(h[0].bias)
                nn.init.constant_(h[2].bias, bias)
            else:
                h = nn.Conv2d(ch[self.first], classes, 1)
                nn.init.constant_(h.bias, bias)
            setattr(self, head, h)
        # kaiming fan_out for the plain convs; the bilinear up-convs keep
        # their kernel and the DCN offset / mask convs stay zero (DCNv2:
        # training starts as a regular conv)
        L.init_convs_(self, generator)
        for m in self.modules():
            if isinstance(m, DCN):
                nn.init.zeros_(m.conv_offset_mask.weight)

    def forward(self, x):
        layers = self.base(x)
        out = self.dla_up(layers)
        y = [out[i] for i in range(self.last_level - self.first)]
        self.ida_up(y, 0, len(y))
        return {head: getattr(self, head)(y[-1]) for head in self.heads}
