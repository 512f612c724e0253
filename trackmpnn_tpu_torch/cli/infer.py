"""Inference entry point: test-split tracking + KITTI result files (the
counterpart of trackmpnn_tpu/cli/infer.py).  Inherits model-shape flags
from the snapshot's training config.json and reads the JAX package's
checkpoint format, so a JAX-trained snapshot serves as it is.  With vis in
the features (the default, 2d+temp+vis), the embedding net's snapshot
vis-net_X.npz must lie beside track-mpnn_X.npz; --embed-arch is inherited
too.

Run: python -m trackmpnn_tpu_torch.cli.infer --snapshot <ckpt> \
         --dataset-root-path <kitti root> [--hungarian] [--device cpu]
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from trackmpnn_tpu_torch.utils.config import parse_infer_args


def main(argv: Optional[List[str]] = None):
    args = parse_infer_args(argv)

    from trackmpnn_tpu_torch.cli.train import (attach_vis, default_input_hw, load_vis_net,
                                               make_embed_trainer)
    from trackmpnn_tpu_torch.data.kitti import KittiMOTDataset, store_kitti_results
    from trackmpnn_tpu_torch.decode.tracker import Tracker, TrackerConfig
    from trackmpnn_tpu_torch.models import mpnn
    from trackmpnn_tpu_torch.train import checkpoint

    if args.dataset != "kitti":
        raise NotImplementedError(
            f"dataset {args.dataset!r} is not ported yet (ROADMAP.md queue 1, 'BDD100K data')")
    # the trainer owns the embedding net (trackmpnn_tpu/cli/train.py:41-61)
    infer_ds = KittiMOTDataset(args.dataset_root_path, "test", args.category, args.detections,
                               args.feats, down_ratio=1 if args.embed_arch == "espv2" else 4,
                               input_hw=default_input_hw(args), defer_vis=True)
    embed = make_embed_trainer(args)
    load_vis_net(embed, args.snapshot)
    cfg = mpnn.ModelConfig(
        features=args.feats, ncategories=len(infer_ds.class_dict),
        nhidden=args.num_hidden_feats, nattheads=args.num_att_heads,
        msg_type=args.msg_type,
    )
    params, stats = checkpoint.load(args.snapshot, cfg)
    tracker = Tracker(params, stats, cfg, TrackerConfig(
        cur_win_size=args.cur_win_size, ret_win_size=args.ret_win_size,
        hungarian=args.hungarian, tp_classifier=args.tp_classifier,
        prune_threshold=args.prune_threshold,
    ), device=args.device)

    for b_idx in range(len(infer_ds)):
        feats, bbox_pred, _, vis_meta = infer_ds[b_idx]
        if feats.shape[0] == 0:
            print("No detections available for sequence...")
            continue
        feats, _ = attach_vis(feats, vis_meta, embed, None, train=False)
        y_seq = bbox_pred[:, :2].astype(np.int64)
        y_out = tracker.run(
            feats, y_seq,
            progress=lambda t, te: print(
                f"Sequence {b_idx + 1}, generated tracks upto t = {t}/{te}..."
            ),
        )
        store_kitti_results(bbox_pred[:, 2:], y_out, infer_ds.class_dict,
                            os.path.join(args.output_dir, "%.4d.txt" % b_idx))
        print(f"Done with sequence {b_idx + 1} out of {len(infer_ds)}...")


if __name__ == "__main__":
    main()
