"""Training entry point: epoch loop, validation and checkpoints (the counterpart
of trackmpnn_tpu/cli/train.py).

Every chunk of the train split becomes a teacher-forced WindowSchedule on
the host, bucketed to a bounded set of padded shapes, and one train step
on the device: the batch-1 step (train/step.py) with --batch-windows 1,
the block step (train/block.py) over that many windows, or the packed step
(train/packed.py) with TM_PACKED=1.  Validation tracks the val split's
sequences in lockstep (decode/batch_tracker.py) and selects on MOTA like
the reference (train.py:300-307); checkpoints carry the full train state
(optimizer, epoch, best metric) in the JAX package's format, so either
package resumes the other's.  With vis in the features the embedding net
trains on each chunk before the tracker's step.

Run: python -m trackmpnn_tpu_torch.cli.train --dataset-root-path <kitti> \\
         --output-dir <new dir> [--feats 2d+temp+vis] [--device cpu] ...
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np


def _bucket(n: int, base: int = 256) -> int:
    c = base
    while c < n:
        c *= 2
    return c


def _t_bucket(t: int, base: int = 4) -> int:
    return ((t + base - 1) // base) * base


def default_input_hw(args):
    """The embedding net's input (h, w): --embed-input-h/-w where given, else
    KITTI's 384 x 1280 (BDD100K's 720 x 1280)."""
    if getattr(args, "embed_input_h", 0) and getattr(args, "embed_input_w", 0):
        return (args.embed_input_h, args.embed_input_w)
    return (384, 1280) if args.dataset == "kitti" else (720, 1280)


def make_dataset(args, split: str):
    """The KITTI split with the vis columns deferred to the trainer."""
    from trackmpnn_tpu_torch.data.kitti import KittiMOTDataset

    if args.dataset != "kitti":
        raise NotImplementedError(
            f"dataset {args.dataset!r} is not ported yet (ROADMAP.md queue 1, 'BDD100K data')")
    return KittiMOTDataset(
        args.dataset_root_path, split, args.category, args.detections, args.feats,
        args.cur_win_size, args.ret_win_size,
        random_transforms=split == "train" and getattr(args, "random_transforms", False),
        seed=args.seed, defer_vis=True, input_hw=default_input_hw(args),
        down_ratio=1 if args.embed_arch == "espv2" else 4)


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
    """Restore the embedding net (and its Adam state) saved beside a tracker
    snapshot, found by the reference's naming (track-mpnn_X -> vis-net_X,
    ref infer.py:15-16).  An entry point that attaches vis features to a
    loaded tracker must call it: a freshly initialised backbone gives
    meaningless appearance features."""
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


def attach_vis(features, vis_meta, embed, track_ids, train: bool):
    """Compute a chunk's vis features and append the normalised block;
    with train=True the embedding net first takes a train step on the chunk
    (track_ids one per detection, -1 a false positive).  Returns (features,
    embedding loss)."""
    from trackmpnn_tpu_torch.train.embed import normalized_vis_features

    if embed is None or vis_meta is None:
        return features, 0.0
    if train:
        raw, loss = embed.train_chunk(vis_meta, track_ids)
    else:
        raw, loss = embed.infer_chunk(vis_meta), 0.0
    if raw.shape[0] != features.shape[0]:
        raise RuntimeError(
            f"vis feature rows {raw.shape[0]} != detection rows {features.shape[0]}")
    return np.concatenate([features, normalized_vis_features(raw)], axis=1), loss


def f1_from_counts(tp, fp, fn) -> float:
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom > 0 else 0.0


def run_validation(args, cfg, params, stats, val_ds, log, embed=None, stats_out=None):
    """(val F1, val MOTA %, val mAP %) of the val split, tracked by the
    BatchedTracker on args.device; the per-step F1 against the teacher
    targets (ref train.py:244-253), per-sequence MOTA logged.  stats_out, a
    dict, receives the tracked frames, the tracker's forwards and the
    decoded tracks."""
    import torch

    from trackmpnn_tpu_torch.decode import BatchedTracker, TrackerConfig
    from trackmpnn_tpu_torch.eval.detection import compute_map
    from trackmpnn_tpu_torch.eval.mot import accumulate_sequence, summarize
    from trackmpnn_tpu_torch.losses.losses import f1_counts, make_targets

    seqs, metas = [], []
    for b_idx in range(len(val_ds)):
        feats, bbox_pred, bbox_gt, vis_meta = val_ds[b_idx]
        if feats.shape[0] == 0 or bbox_gt.shape[0] == 0:
            log("No detections available for sequence...")
            continue
        feats, _ = attach_vis(feats, vis_meta, embed, bbox_pred[:, 1].astype(np.int32),
                              train=False)
        seqs.append((feats, bbox_pred[:, :2].astype(np.int64)))
        metas.append((bbox_pred, bbox_gt))

    f1s = []

    def on_step(_seq_idx, g, scores2):
        n = g.n
        ar = np.arange(n)
        is_det = torch.from_numpy(g.ts != -1)
        past = torch.from_numpy(np.where(g.past >= 0, g.past, ar))
        fut = torch.from_numpy(np.where(g.fut >= 0, g.fut, ar))
        live = torch.ones(n, dtype=torch.bool)
        tgt = make_targets(torch.from_numpy(g.label.astype(np.int32)), is_det, past, fut, live)
        tp, fp, fn = f1_counts(torch.from_numpy(scores2[:, 1]), tgt, is_det, live,
                               args.tp_classifier)
        f1s.append(f1_from_counts(int(tp), int(fp), int(fn)))

    tracker = BatchedTracker(params, stats, cfg, TrackerConfig(
        cur_win_size=args.cur_win_size, ret_win_size=args.ret_win_size,
        hungarian=args.hungarian, tp_classifier=args.tp_classifier,
    ), device=args.device)
    y_outs = tracker.run(seqs, on_step=on_step)
    if stats_out is not None:
        stats_out["frames"] = sum(len(np.unique(y[:, 0])) for _, y in seqs)
        stats_out["forwards"] = tracker.n_forwards
        stats_out["tracks"] = y_outs

    accs = []
    pred_dict, gt_dict = {}, {}
    for b_idx, ((bbox_pred, bbox_gt), y_out) in enumerate(zip(metas, y_outs)):
        y_gt = bbox_gt[:, :2].astype(np.int64)
        acc = accumulate_sequence(bbox_pred[:, 2:], bbox_gt[:, 2:], y_out, y_gt)
        if acc is not None:
            accs.append(acc)
        sel = y_out[:, 1] >= 0
        pred_dict[str(b_idx)] = (y_out[sel], bbox_pred[sel, 2:])
        gt_dict[str(b_idx)] = (y_gt, bbox_gt[:, 2:])
        log(f"Done with sequence {b_idx + 1} of {len(metas)}...")

    val_f1 = float(np.mean(f1s)) if f1s else 0.0
    for i, acc in enumerate(accs):
        log(f"Validation MOTA for sequence {i} = {100.0 * summarize([acc])['mota']:.2f}%")
    val_mota = 100.0 * summarize(accs)["mota"] if accs else -1.0
    val_map = 100.0 * compute_map(pred_dict, gt_dict) if gt_dict else 0.0
    return val_f1, val_mota, val_map


def main(argv: Optional[List[str]] = None):
    """Train as the JAX CLI does; returns the per-epoch history (losses, F1,
    MOTA, mAP, and the walls, chunks and frames the CLI timed)."""
    from trackmpnn_tpu_torch.utils.config import parse_train_args, train_route

    args = parse_train_args(argv)

    import torch

    from trackmpnn_tpu_torch.decode.tracker import resolve_device
    from trackmpnn_tpu_torch.graph.schedule import build_window_schedule
    from trackmpnn_tpu_torch.models import mpnn, weights
    from trackmpnn_tpu_torch.train import checkpoint, optim
    from trackmpnn_tpu_torch.train.block import param_leaves, trainable

    device = resolve_device(args.device)
    log_f = open(os.path.join(args.output_dir, "logs.txt"), "w")

    def log(msg):
        print(msg)
        log_f.write(str(msg) + "\n")
        log_f.flush()

    train_ds = make_dataset(args, "train")
    val_ds = make_dataset(args, "val")
    embed = make_embed_trainer(args)

    cfg = mpnn.ModelConfig(
        features=args.feats, ncategories=len(train_ds.class_dict),
        nhidden=args.num_hidden_feats, nattheads=args.num_att_heads,
        msg_type=args.msg_type,
    )
    start_epoch = 1
    best_mota = -float("inf")
    if args.snapshot is not None:
        params, stats, epoch, best_mota = checkpoint.load_state(args.snapshot, cfg, device)
        start_epoch = epoch + 1
    else:
        # weights drawn on the CPU: one seed gives the same net on any device
        params = mpnn.init_params(torch.Generator().manual_seed(args.seed), cfg)
        stats = mpnn.init_batch_stats(cfg)
    params, stats = weights.to_device(params, stats, cfg, device)
    params = trainable(params)
    optimizer = optim.make_optimizer(param_leaves(params), args.learning_rate,
                                     args.weight_decay)
    if args.snapshot is not None:
        checkpoint.load_optimizer_state(args.snapshot, optimizer, params, cfg)
        # vis branch: restore the embedding net saved beside the snapshot
        load_vis_net(embed, args.snapshot)
        log(f"resumed from {args.snapshot} at epoch {start_epoch}")

    route = train_route(args)
    batch_windows = max(args.batch_windows, 1)
    if route == "block":
        from trackmpnn_tpu_torch.train.block import (block_dims, build_block_batch,
                                                     make_block_train_step)

        step = make_block_train_step(cfg, args.tp_classifier)
        block_dims_max = [0, 0, 0]  # growing buckets bound the distinct shapes
        log(f"block-structured batched training: {batch_windows} windows/step")
        if args.fused or args.defer_loss:
            log("--fused / --defer-loss choose TPU compositions with the same result; "
                "the card runs one block round, its kernels")
    elif route == "packed":
        from trackmpnn_tpu_torch.train.packed import make_packed_train_step, pack_schedules

        step = make_packed_train_step(cfg, args.tp_classifier)
        log(f"packed batched training: {batch_windows} windows/step")
    else:
        from trackmpnn_tpu_torch.train.step import make_train_step, schedule_to_device

        step = make_train_step(cfg, args.tp_classifier)
    lr_of = optim.step_lr(args.learning_rate)
    rng = np.random.default_rng(args.seed)
    # GAT attention dropout: torch's stream from --seed (not JAX's fold_in keys)
    gat_gen = (torch.Generator(device=device).manual_seed(args.seed)
               if cfg.nattheads > 0 else None)

    def _build_sched(feats, bbox_pred, cap=None, t_cap=None):
        y = bbox_pred[:, :2].astype(np.int64)
        if cap is None:
            ws = build_window_schedule(feats, y, cap=args.slot_cap or None, bucket=256)
            if ws is None:
                return None
            cap = args.slot_cap or _bucket(ws.n_rows)
            t_cap = _t_bucket(ws.n_steps)
        return build_window_schedule(feats, y, cap=cap, t_cap=t_cap)

    def build_chunk(i):
        feats, bbox_pred, _, vis_meta = train_ds[int(i)]
        if feats.shape[0] == 0:
            return None
        if embed is not None:
            # vis path: the embedding step changes device state; stay serial
            return ("raw", feats, bbox_pred, vis_meta)
        ws = _build_sched(feats, bbox_pred)
        return ("sched", ws, feats, bbox_pred) if ws is not None else None

    history = {"loss_c": [], "loss_f": [], "loss": [], "train_f1": [],
               "val_f1": [], "val_mota": [], "val_map": [], "epoch_wall_s": [],
               "steps": [], "val_wall_s": [], "val_frames": [], "val_forwards": []}

    for epoch in range(start_epoch, args.epochs + 1):
        optim.set_lr(optimizer, lr_of(epoch))
        order = rng.permutation(len(train_ds))
        ep_losses, ep_c, ep_f, ep_d, ep_f1 = [], [], [], [], []
        t0 = time.time()

        def record(loss, aux):
            ep_losses.append(float(loss))
            ep_c.append(float(aux["loss_ce"].mean()))
            ep_f.append(float(aux["loss_f"].mean()))
            tp, fp, fn = (int(aux[k].sum()) for k in ("tp", "fp", "fn"))
            ep_f1.append(f1_from_counts(tp, fp, fn))

        def flush_batch(buffer):
            nonlocal stats
            cap = max(len(w.is_det) for w, _, _ in buffer)
            t_cap = max(len(w.n_before) for w, _, _ in buffer)
            scheds = []
            for ws, feats_b, bbox_b in buffer:
                if len(ws.is_det) != cap or len(ws.n_before) != t_cap:
                    ws = _build_sched(feats_b, bbox_b, cap=cap, t_cap=t_cap)
                scheds.append(ws)
            if route == "block":
                dims = block_dims(scheds)
                for i in range(3):
                    block_dims_max[i] = max(block_dims_max[i], dims[i])
                batch = build_block_batch(scheds, t_cap, *block_dims_max, device=device)
            else:
                batch = pack_schedules(scheds, cap, t_cap, device=device)
            _, stats, loss, aux = step(params, stats, optimizer, batch, generator=gat_gen)
            record(loss, aux)

        from trackmpnn_tpu_torch.data.loader import PrefetchLoader

        loader = PrefetchLoader(build_chunk, order, depth=4,
                                workers=1 if embed is not None else 2)
        batch_buf = []
        for it, item in enumerate(loader):
            if item is None:
                log("No detections available for sequence...")
                continue
            if item[0] == "raw":
                _, feats, bbox_pred, vis_meta = item
                feats, loss_d = attach_vis(feats, vis_meta, embed,
                                           bbox_pred[:, 1].astype(np.int32), train=True)
                ep_d.append(loss_d)
                ws = _build_sched(feats, bbox_pred)
            else:
                _, ws, feats, bbox_pred = item
            if ws is None:
                continue
            if route != "batch1":
                batch_buf.append((ws, feats, bbox_pred))
                if len(batch_buf) == batch_windows:
                    flush_batch(batch_buf)
                    batch_buf = []
            else:
                sb = schedule_to_device(ws, device)
                _, stats, loss, aux = step(params, stats, optimizer, sb, generator=gat_gen)
                record(loss, aux)
            if ep_losses and it % args.log_schedule == 0:
                log(f"Epoch: {epoch} [{it + 1}/{len(order)}]\tLoss: {ep_losses[-1]:.5f}")
        if batch_buf:
            log(f"dropping {len(batch_buf)} leftover chunk(s) (< batch-windows)")

        log("------------------------")
        if embed is not None and ep_d:
            log(f"Average embedding loss for epoch = {np.mean(ep_d):.2f}")
        log(f"Average cross-entropy loss for epoch = {np.mean(ep_c):.2f}")
        log(f"Average focal loss for epoch = {np.mean(ep_f):.2f}")
        log(f"Average loss for epoch = {np.mean(ep_losses):.2f}")
        log(f"Average F1 score for epoch = {np.mean(ep_f1):.4f}")
        wall = time.time() - t0
        log(f"Epoch wall time = {wall:.1f}s")
        history["loss"].append(float(np.mean(ep_losses)))
        history["loss_c"].append(float(np.mean(ep_c)))
        history["loss_f"].append(float(np.mean(ep_f)))
        history["train_f1"].append(float(np.mean(ep_f1)))
        history["epoch_wall_s"].append(wall)
        history["steps"].append(len(ep_losses))

        t0 = time.time()
        val = {}
        val_f1, val_mota, val_map = run_validation(args, cfg, params, stats, val_ds, log,
                                                   embed=embed, stats_out=val)
        history["val_wall_s"].append(time.time() - t0)
        history["val_frames"].append(val.get("frames", 0))
        history["val_forwards"].append(val.get("forwards", 0))
        log(f"Validation F1 score = {val_f1:.4f}")
        log(f"Validation MOTA = {val_mota:.2f}%")
        log(f"Validation mAP = {val_map:.2f}%")
        history["val_f1"].append(val_f1)
        history["val_mota"].append(val_mota)
        history["val_map"].append(val_map)

        if val_mota > best_mota:
            best_mota = val_mota
            for name in ("track-mpnn_%.4d.npz" % epoch, "track-mpnn_best.npz"):
                checkpoint.save_state(os.path.join(args.output_dir, name), params, stats,
                                      optimizer, cfg, epoch, best_mota)
                if embed is not None:
                    checkpoint.save_embed(os.path.join(
                        args.output_dir, name.replace("track-mpnn", "vis-net")), embed)
            log(f"saved best checkpoint (MOTA {best_mota:.2f}%)")

        _save_plots(args.output_dir, history)

    log_f.close()
    return history


def _save_plots(output_dir, history):
    """The loss, F1 and MOTA/mAP curves as JPEGs; skipped (and said so)
    where matplotlib is missing or fails: plotting never stops training."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        for name, curves in (
                ("train_loss.jpg", (("loss_c", "g", "Cross-entropy loss"),
                                    ("loss_f", "b", "Focal loss"), ("loss", "k", "Total loss"))),
                ("train_val_f1.jpg", (("train_f1", "g", "Train F1 score"),
                                      ("val_f1", "b", "Validation F1 score"))),
                ("val_mota+map.jpg", (("val_mota", "b", "Validation MOTA"),
                                      ("val_map", "r", "Validation mAP")))):
            fig, ax = plt.subplots()
            ax.grid(True)
            for key, color, label in curves:
                ax.plot(history[key], color, label=label)
            ax.legend()
            fig.savefig(os.path.join(output_dir, name))
            plt.close(fig)
    except Exception as e:  # plotting must never kill training
        print(f"plotting skipped: {e}")


if __name__ == "__main__":
    main()
