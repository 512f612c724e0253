"""Joint appearance-embedding training (the counterpart of
trackmpnn_tpu/train/embed.py).

The trainer owns the embedding backbone and its optimizer.  A chunk's
frames go through the backbone as one [T, 3, H, W] batch; a train step is
backbone forward -> gather at the detection centres -> FairMOT id loss ->
backward -> Adam with L2.  The sampled features are returned detached (the
reference's features.detach(): the tracker's loss never reaches the
backbone).

Recipes (ref kitti_mot.py:119-126): espv2 -> Adam(5e-4, L2 5e-4), down
ratio 1; dla34 -> Adam(1.25e-4), down ratio 4.  BatchNorm is frozen by
default: it normalises by its running statistics even while training
(train_bn=False; the module runs in eval mode), and the optimizer never
sees the running statistics, which are buffers.  train_bn=True trains in
the reference's .train() mode: batch statistics normalise, the buffers
take the momentum update, and ESPNetv2's two Dropout2d sites drop, drawing
from the trainer's torch.Generator unless the caller gives keep masks.

`frame_chunk` is a TPU memory workaround in the JAX package (embed.py:70-
89) that changes no number.  The port runs a training chunk's frames as
one batch whatever it is given (the card has 80 GB); the argument stays
for the JAX trainer's signature and its train_bn check.  `infer` runs the
backbone INFER_FRAMES frames at a time, so that a whole eval sequence
(hundreds of frames) needs no more memory than a training chunk.

Both run their convolutions and products in full f32 (`full_f32`):
PyTorch lets cuDNN convolve in TF32 by default, a 10-bit mantissa.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import numpy as np
import torch

from trackmpnn_tpu_torch.backbones.weights import make_backbone
from trackmpnn_tpu_torch.decode.tracker import resolve_device
from trackmpnn_tpu_torch.losses.embedding import fairmot_id_loss
from trackmpnn_tpu_torch.train.optim import make_optimizer

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
RECIPES = {"espv2": (1, 5e-4, 5e-4), "dla34": (4, 1.25e-4, 0.0)}  # down ratio, lr, L2
INFER_FRAMES = 8  # a training chunk: cur_win_size 5 and the skip pair, padded to 8


@contextlib.contextmanager
def full_f32():
    """cuDNN convolutions and cuBLAS products in f32, not TF32, inside the
    block, whatever the process's flags; the flags are put back on exit."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def load_image(path: str, hflip: bool, input_hw: Tuple[int, int]) -> np.ndarray:
    """PIL load -> resize -> ImageNet-normalise -> HWC float32.  A missing
    PIL raises ImportError; an unreadable image becomes zeros, as in the
    JAX package (frame-count placeholders in its tests)."""
    import PIL.Image

    h, w = input_hw
    try:
        with PIL.Image.open(path) as im:
            if hflip:
                im = im.transpose(PIL.Image.FLIP_LEFT_RIGHT)
            im = im.convert("RGB").resize((w, h), PIL.Image.BILINEAR)
            arr = np.asarray(im, np.float32) / 255.0
    except Exception:
        arr = np.zeros((h, w, 3), np.float32)
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def normalized_vis_features(raw_feats: np.ndarray) -> np.ndarray:
    """softmax over the embedding dim, then the reference's (x-0.5)/0.5
    standardisation of the vis block (kitti_mot.py:163-177, 563-566)."""
    e = np.exp(raw_feats - raw_feats.max(axis=1, keepdims=True))
    sm = e / e.sum(axis=1, keepdims=True)
    return ((sm - 0.5) / 0.5).astype(np.float32)


class EmbedTrainer:
    """Owns the backbone and its optimizer; runs batched embed steps on
    `device` (the card unless the caller asks for the CPU)."""

    def __init__(self, arch: str = "espv2", num_vis_feats: int = 128,
                 input_hw: Tuple[int, int] = (384, 1280), seed: int = 5, max_dets: int = 256,
                 train_bn: bool = False, dcn_max_offset: float = None, frame_chunk="auto",
                 conv_dtype=None, device="cuda"):
        if conv_dtype not in (None, "", "f32", "float32", torch.float32):
            raise NotImplementedError(f"conv_dtype={conv_dtype!r}: the port's backbones run "
                                      "in f32 (ROADMAP.md queue 1, 'bf16 rectangles')")
        if arch not in RECIPES:
            raise ValueError(f"unknown embed arch {arch!r}")
        if frame_chunk not in (None, "auto") and train_bn:
            raise ValueError("frame_chunk is incompatible with train_bn "
                             "(batch statistics would be per-chunk)")
        self.arch, self.num_vis_feats, self.input_hw = arch, num_vis_feats, input_hw
        self.max_dets, self.train_bn = max_dets, train_bn
        self.device = resolve_device(device)
        self.down_ratio, lr, wd = RECIPES[arch]
        # weights drawn on the CPU: the same seed gives the same net anywhere
        self.net = make_backbone(arch, num_vis_feats, dcn_max_offset,
                                 torch.Generator().manual_seed(seed)).to(self.device)
        self.opt = make_optimizer(self.net.parameters(), lr, wd)
        self._drop_gen = torch.Generator(device=self.device).manual_seed(seed + 1)

    # ------------------------------------------------------------ backbone ----
    def _apply(self, images, keep=None):
        if self.arch == "espv2":
            return self.net(images, keep=keep, generator=self._drop_gen)
        return self.net(images)["trk"]

    def _tensors(self, images, *ints):
        dev = self.device
        x = torch.as_tensor(images, dtype=torch.float32, device=dev).permute(0, 3, 1, 2)
        return (x.contiguous(),) + tuple(torch.as_tensor(a, device=dev).long() for a in ints)

    # --------------------------------------------------------------- steps ----
    def step(self, images, fr_of, cy, cx, track_ids, valid, keep=None):
        """One train step on packed arrays (the JAX trainer's _step): images
        [T, H, W, 3]; fr_of, cy, cx, track_ids int [Nmax] (fmap coordinates,
        -1 ids are false positives); valid bool [Nmax]; keep: ESPNetv2's
        dropout keep masks (train_bn only).  Returns (loss, features
        [Nmax, C]), both detached tensors on the device."""
        x, fr_of, cy, cx, track_ids = self._tensors(images, fr_of, cy, cx, track_ids)
        valid = torch.as_tensor(valid, device=self.device).bool()
        self.net.train(self.train_bn)
        self.opt.zero_grad(set_to_none=False)
        with full_f32():
            feats = self._apply(x, keep)[fr_of, :, cy, cx]
            loss = fairmot_id_loss(feats, track_ids, valid, self.num_vis_feats)
            loss.backward()
        # a parameter off the loss's path (a tree's unused projection) gets
        # a zero gradient, so that Adam's L2 decays it as optax's does
        for p in self.net.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.opt.step()
        return loss.detach(), feats.detach()

    @torch.no_grad()
    def infer(self, images, fr_of, cy, cx):
        """Features [Nmax, C] at the centres, BN on its running statistics and
        no dropout (the JAX trainer's _infer), INFER_FRAMES frames a backbone
        call."""
        x, fr_of, cy, cx = self._tensors(images, fr_of, cy, cx)
        self.net.eval()
        feats = None
        with full_f32():
            for t0 in range(0, x.shape[0], INFER_FRAMES):
                fmap = self._apply(x[t0:t0 + INFER_FRAMES])
                t = fr_of - t0
                got = fmap[t.clamp(0, fmap.shape[0] - 1), :, cy, cx]
                here = ((t >= 0) & (t < fmap.shape[0]))[:, None]
                feats = got if feats is None else torch.where(here, got, feats)
        return feats

    def _pack(self, vis_meta):
        """Frames, centres and validity as fixed-shape numpy arrays
        (embed.py:205-244): the frame axis padded to a multiple of 4 by
        cycling real frames (all-zero frames would shift train-mode BN
        statistics), the detection capacity max_dets doubled until it fits."""
        T = len(vis_meta["images"])
        h, w = self.input_hw
        t_cap = max(((T + 3) // 4) * 4, 4)
        images = np.zeros((t_cap, h, w, 3), np.float32)
        for t, (p, hf) in enumerate(vis_meta["images"]):
            images[t] = load_image(p, hf, self.input_hw)
        for t in range(T, t_cap):
            images[t] = images[t % T]
        fr_of, cys, cxs = [], [], []
        for t, (cy, cx) in enumerate(vis_meta["centers"]):
            fr_of.extend([t] * len(cy))
            cys.extend(np.asarray(cy).tolist())
            cxs.extend(np.asarray(cx).tolist())
        n = len(fr_of)
        cap = self.max_dets
        while cap < n:
            cap *= 2
        pad = cap - n
        fr_of = np.array(fr_of + [0] * pad, np.int32)
        cys = np.array(cys + [0] * pad, np.int32)
        cxs = np.array(cxs + [0] * pad, np.int32)
        # centres must be feature-map coordinates (data.common.center_indices
        # divides by down_ratio); input-pixel ones would gather edge pixels
        fh, fw = h // self.down_ratio, w // self.down_ratio
        if n and (cys[:n].max() >= fh or cxs[:n].max() >= fw):
            raise ValueError(
                f"center coords exceed the {fh}x{fw} feature map (down_ratio="
                f"{self.down_ratio}); pass fmap-space centers, see "
                "data.common.center_indices")
        return images, fr_of, cys, cxs, np.arange(cap) < n, n

    def train_chunk(self, vis_meta, track_ids: np.ndarray):
        """One train step over a chunk; track_ids one int per detection (-1 =
        false positive).  Returns (features [n, C] numpy, loss)."""
        images, fr_of, cy, cx, valid, n = self._pack(vis_meta)
        tids = np.full(len(valid), -1, np.int32)
        tids[:n] = track_ids[:n]
        loss, feats = self.step(images, fr_of, cy, cx, tids, valid)
        return feats[:n].cpu().numpy(), float(loss)

    def infer_chunk(self, vis_meta):
        images, fr_of, cy, cx, _, n = self._pack(vis_meta)
        return self.infer(images, fr_of, cy, cx)[:n].cpu().numpy()
