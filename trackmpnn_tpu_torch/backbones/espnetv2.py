"""ESPNetv2 segmentation backbone, the 'espv2' appearance-embedding network
(the counterpart of trackmpnn_tpu/backbones/espnetv2.py; behavioural spec
the reference's models/espv2/).

It produces a `classes`-channel embedding map at the input resolution
(down_ratio 1); the tracker samples it at detection centres.

  EESP block: 1x1 grouped reduce -> k parallel depthwise dilated 3x3
  branches -> hierarchical additive fusion -> BN + PReLU -> 1x1 grouped
  expand (+ residual, PReLU).
  DownSampler: stride-2 'avg'-mode EESP || 3x3 avg-pool, concatenated, plus
  the repeatedly avg-pooled RGB input.
  Seg head: L4 -> L3 projection + PSP module + staged bilinear upsampling
  with L2 / L1 skip projections, and two Dropout2d(0.2) sites.

NCHW.  Module paths are the JAX package's parameter names.  The dropout
sites drop only in train mode (the embedding trainer's train_bn), with keep
masks given by the caller or drawn from its torch.Generator.
`load_pretrained` (espnetv2.py:213), which reads downloaded ImageNet
weights, is not ported (ROADMAP.md queue 1, 'Tail').
"""

from __future__ import annotations

import math

import torch
from torch import nn

from trackmpnn_tpu_torch.backbones import layers as L

RECEPTIVE_DILATION = {3: 1, 5: 2, 7: 3, 9: 4, 11: 5, 13: 6, 15: 7, 17: 8}
REPS = [0, 3, 7, 3]
R_LIMS = [13, 11, 9, 7, 5]
DROP_P = 0.2


def _eesp_ksizes(k: int, r_lim: int):
    return sorted(3 + 2 * i if 3 + 2 * i <= r_lim else 3 for i in range(k))


def espnet_config(s: float = 1.0):
    base, K = 32, 4
    base_s = math.ceil(int(base * s) / K) * K
    c0 = base if base_s > base else base_s
    return [c0] + [base_s * (2 ** i) for i in range(1, 5)] + [1024 if s <= 1.5 else 1280]


class EESP(nn.Module):
    """init_eesp / apply_eesp (espnetv2.py:52-81)."""

    def __init__(self, n_in, n_out, stride=1, k=4, r_lim=7, down_avg=False):
        super().__init__()
        n = n_out // k
        self.stride, self.down_avg = stride, down_avg
        self.proj_1x1 = L.CBR(n_in, n, 1, groups=k)
        ks = _eesp_ksizes(k, r_lim)
        self.spp_dw = nn.ModuleList(
            L.C(n, n, 3, stride=stride, groups=n, dilation=RECEPTIVE_DILATION[s]) for s in ks)
        self.conv_1x1_exp = L.CB(n_out, n_out, 1, groups=k)
        self.br_after_cat = L.BR(n_out)
        self.module_act = nn.PReLU(n_out)

    def forward(self, x):
        red = self.proj_1x1(x)
        outs = []
        for branch in self.spp_dw:
            b = branch(red)
            if outs:
                b = b + outs[-1]  # hierarchical feature fusion
            outs.append(b)
        expanded = self.conv_1x1_exp(self.br_after_cat(torch.cat(outs, 1)))
        if self.stride == 2 and self.down_avg:
            return expanded
        if expanded.shape == x.shape:
            expanded = expanded + x
        return self.module_act(expanded)


class DownSampler(nn.Module):
    """init_downsampler / apply_downsampler (espnetv2.py:85-110)."""

    def __init__(self, n_in, n_out, k=4, r_lim=9):
        super().__init__()
        self.eesp = EESP(n_in, n_out - n_in, stride=2, k=k, r_lim=r_lim, down_avg=True)
        self.inp_reinf = nn.Sequential(L.CBR(3, 3, 3), L.CB(3, n_out, 1))
        self.act = nn.PReLU(n_out)

    def forward(self, x, rgb):
        avg = L.avg_pool2d(x, 3, 2, 1)
        out = torch.cat([avg, self.eesp(x)], 1)
        r = rgb
        while r.shape[2] != avg.shape[2]:
            r = L.avg_pool2d(r, 3, 2, 1)
        return self.act(out + self.inp_reinf(r))


class EESPNet(nn.Module):
    """Levels 1-4 of the backbone (level 5 is dropped by the seg model)."""

    def __init__(self, cfg):
        super().__init__()
        self.level1 = L.CBR(3, cfg[0], 3, stride=2)
        self.level2_0 = DownSampler(cfg[0], cfg[1], r_lim=R_LIMS[0])
        self.level3_0 = DownSampler(cfg[1], cfg[2], r_lim=R_LIMS[1])
        self.level3 = nn.ModuleList(EESP(cfg[2], cfg[2], r_lim=R_LIMS[2])
                                    for _ in range(REPS[1]))
        self.level4_0 = DownSampler(cfg[2], cfg[3], r_lim=R_LIMS[2])
        self.level4 = nn.ModuleList(EESP(cfg[3], cfg[3], r_lim=R_LIMS[3])
                                    for _ in range(REPS[2]))


class PSPModule(nn.Module):
    """Four avg-pooled depthwise 3x3 stages + a 1x1 projection (apply_psp)."""

    def __init__(self, c):
        super().__init__()
        self.stages = nn.ModuleList(L.C(c, c, 3, groups=c) for _ in range(4))
        self.project = L.CBR(5 * c, c, 1)

    def forward(self, x):
        h, w = x.shape[2], x.shape[3]
        outs, feats = [x], x
        for stage in self.stages:
            feats = L.avg_pool2d(feats, 3, 2, 1)
            outs.append(L.resize_bilinear_align_corners(stage(feats), h, w))
        return self.project(torch.cat(outs, 1))


class ESPNetv2Seg(nn.Module):
    """init_espnetv2_seg / apply_espnetv2_seg: x [N, 3, H, W] (normalised
    RGB) -> [N, classes, H, W]."""

    def __init__(self, classes: int = 128, s: float = 1.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        cfg = espnet_config(s)
        self.cfg, self.classes = cfg, classes
        self.net = EESPNet(cfg)
        self.proj_L4_C = L.CBR(cfg[3], cfg[2], 1)
        psp = 2 * cfg[2]
        self.pspMod = nn.Sequential(EESP(psp, psp // 2, k=4, r_lim=7), PSPModule(psp // 2))
        # key "1": the reference's Sequential has its Dropout2d at 0, applied
        # here in forward with explicit keep masks
        self.project_l3 = nn.ModuleDict({"1": L.C(psp // 2, classes, 1)})
        self.act_l3 = L.BR(classes)
        self.project_l2 = L.CBR(cfg[1] + classes, classes, 1)
        self.project_l1 = nn.ModuleDict({"1": L.C(cfg[0] + classes, classes, 1)})
        L.init_convs_(self, generator)

    def drop_shapes(self, n: int):
        """The keep-mask shapes [N, C] of the two Dropout2d sites."""
        return (n, self.cfg[2]), (n, self.cfg[0] + self.classes)

    def _drop(self, x, keep):
        """Dropout2d(p 0.2) with a keep mask [N, C] (1 keeps the channel)."""
        return x * keep.to(x.dtype)[:, :, None, None] / (1.0 - DROP_P)

    def forward(self, x, keep=None, generator: torch.Generator | None = None):
        """keep: the two sites' keep masks (drop_shapes), used in train mode
        only; in train mode without them they are drawn from `generator`."""
        net = self.net
        rgb = x
        l1 = net.level1(x)
        l2 = net.level2_0(l1, rgb)
        l3 = net.level3_0(l2, rgb)
        for block in net.level3:
            l3 = block(l3)
        l4 = net.level4_0(l3, rgb)
        for block in net.level4:
            l4 = block(l4)
        up4 = L.upsample2x(self.proj_L4_C(l4))
        m3 = self.pspMod(torch.cat([l3, up4], 1))
        if self.training and keep is None:
            keep = [torch.rand(shape, generator=generator, device=x.device) < 1.0 - DROP_P
                    for shape in self.drop_shapes(x.shape[0])]
        if self.training:
            m3 = self._drop(m3, keep[0])
        up3 = L.upsample2x(self.act_l3(self.project_l3["1"](m3)))
        up2 = L.upsample2x(self.project_l2(torch.cat([l2, up3], 1)))
        m1 = torch.cat([l1, up2], 1)
        if self.training:
            m1 = self._drop(m1, keep[1])
        return L.upsample2x(self.project_l1["1"](m1))
