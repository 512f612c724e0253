"""Ablation / evaluation entry point: the full MOT metric dump on the val split
(the counterpart of trackmpnn_tpu/cli/ablation.py; ref ablation.py:152-187).
Inherits model-shape flags from the snapshot's training config.json and
reads the JAX package's checkpoint format.

Run: python -m trackmpnn_tpu_torch.cli.ablation --snapshot <ckpt> \
         --dataset-root-path <kitti root> [--hungarian] [--device cpu]
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from trackmpnn_tpu_torch.utils.config import parse_infer_args

METRICS = ["idf1", "idp", "idr", "recall", "precision", "num_unique_objects",
           "mostly_tracked", "partially_tracked", "mostly_lost", "num_false_positives",
           "num_misses", "num_switches", "num_fragmentations", "mota", "motp"]


def main(argv: Optional[List[str]] = None):
    args = parse_infer_args(argv)

    from trackmpnn_tpu_torch.cli.train import (attach_vis, load_vis_net, make_dataset,
                                               make_embed_trainer)
    from trackmpnn_tpu_torch.decode import Tracker, TrackerConfig
    from trackmpnn_tpu_torch.eval.mot import accumulate_sequence, summarize
    from trackmpnn_tpu_torch.models import mpnn
    from trackmpnn_tpu_torch.train import checkpoint

    val_ds = make_dataset(args, "val")
    embed = make_embed_trainer(args)
    load_vis_net(embed, args.snapshot)
    cfg = mpnn.ModelConfig(
        features=args.feats, ncategories=len(val_ds.class_dict),
        nhidden=args.num_hidden_feats, nattheads=args.num_att_heads,
        msg_type=args.msg_type,
    )
    params, stats = checkpoint.load(args.snapshot, cfg)
    tracker = Tracker(params, stats, cfg, TrackerConfig(
        cur_win_size=args.cur_win_size, ret_win_size=args.ret_win_size,
        hungarian=args.hungarian, tp_classifier=args.tp_classifier,
        prune_threshold=args.prune_threshold,
    ), device=args.device)

    accs = []
    for b_idx in range(len(val_ds)):
        feats, bbox_pred, bbox_gt, vis_meta = val_ds[b_idx]
        if feats.shape[0] == 0 or bbox_gt.shape[0] == 0:
            continue
        feats, _ = attach_vis(feats, vis_meta, embed, None, train=False)
        y_out = tracker.run(feats, bbox_pred[:, :2].astype(np.int64))
        acc = accumulate_sequence(bbox_pred[:, 2:], bbox_gt[:, 2:], y_out,
                                  bbox_gt[:, :2].astype(np.int64))
        if acc is not None:
            accs.append(acc)
        print(f"Done with sequence {b_idx + 1} of {len(val_ds)}...")

    m = summarize(accs)
    print("\n================ MOT metrics (OVERALL) ================")
    for k in METRICS:
        print(f"{k:>24}: {m[k]:.4f}" if isinstance(m[k], float) else f"{k:>24}: {m[k]}")
    return m


if __name__ == "__main__":
    main()
