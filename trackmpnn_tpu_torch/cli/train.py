"""Helpers of the training entry point that serving shares (the
counterpart of trackmpnn_tpu/cli/train.py:35-120): the embedding input
size, the embedding trainer, its snapshot and the vis columns.  The training loop
itself is ROADMAP.md queue 1, 'Training CLI'.
"""

from __future__ import annotations

import os

import numpy as np


def default_input_hw(args):
    """The embedding net's input (h, w): --embed-input-h/-w where given, else
    KITTI's 384 x 1280 (BDD100K's 720 x 1280)."""
    if getattr(args, "embed_input_h", 0) and getattr(args, "embed_input_w", 0):
        return (args.embed_input_h, args.embed_input_w)
    return (384, 1280) if args.dataset == "kitti" else (720, 1280)


def make_embed_trainer(args):
    """The EmbedTrainer of a config whose features include vis, on
    args.device (the card unless --device cpu); None otherwise."""
    if "vis" not in args.feats:
        return None
    from trackmpnn_tpu_torch.train.embed import EmbedTrainer

    return EmbedTrainer(arch=args.embed_arch, input_hw=default_input_hw(args),
                        seed=args.seed, train_bn=getattr(args, "train_bn", False),
                        conv_dtype="bfloat16" if getattr(args, "embed_bf16", False) else None,
                        device=args.device)


def load_vis_net(embed, snapshot_path: str):
    """Restore the embedding net saved beside a tracker snapshot, found by
    the reference's naming (track-mpnn_X -> vis-net_X, ref infer.py:15-16).
    An entry point that attaches vis features to a loaded tracker must call
    it: a freshly initialised backbone gives meaningless appearance
    features."""
    from trackmpnn_tpu_torch.train import checkpoint

    if embed is None:
        return
    vis_path = os.path.join(os.path.dirname(snapshot_path),
                            os.path.basename(snapshot_path).replace("track-mpnn", "vis-net"))
    if not os.path.exists(vis_path):
        raise FileNotFoundError(
            f"feats include 'vis' but no embedding checkpoint at {vis_path} "
            "(saved alongside the tracker snapshot)")
    checkpoint.load_embed(vis_path, embed)


def attach_vis(features, vis_meta, embed):
    """The sequence's vis features, inferred by the embedding net, appended
    to `features` as the normalised vis block.  (The training CLI's form,
    which trains the net on the chunk, comes with it.)"""
    from trackmpnn_tpu_torch.train.embed import normalized_vis_features

    if embed is None or vis_meta is None:
        return features
    raw = embed.infer_chunk(vis_meta)
    if raw.shape[0] != features.shape[0]:
        raise RuntimeError(
            f"vis feature rows {raw.shape[0]} != detection rows {features.shape[0]}")
    return np.concatenate([features, normalized_vis_features(raw)], axis=1)
