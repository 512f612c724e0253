"""Training and inference flags (the counterpart of
trackmpnn_tpu/utils/config.py): the same flags, defaults and validation.

Inference inherits the model-shape flags from the training config.json
found next to the snapshot, so they cannot drift from the weights (ref
infer_options.py:32-47).  The port adds --device to both: the card unless
the caller asks for the CPU.  Training refuses, by name of their
ROADMAP.md item, the flags whose paths are not ported (check_ported).
"""

from __future__ import annotations

import argparse
import json
import os
from datetime import datetime
from typing import Optional

KITTI_CATS = ["Pedestrian", "Car", "Cyclist", "All"]
BDD_CATS = ["pedestrian", "rider", "car", "bus", "truck", "train",
            "motorcycle", "bicycle", "All"]

INHERITED_KEYS = [
    "dataset", "category", "detections", "feats", "embed_arch",
    "cur_win_size", "ret_win_size", "no_tp_classifier",
    "num_hidden_feats", "num_att_heads", "msg_type",
]


def build_train_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("TrackMPNN (PyTorch) training options")
    p.add_argument("--dataset", type=str, default="kitti", help="kitti/bdd100k")
    p.add_argument("--dataset-root-path", type=str, default=None, help="path to dataset")
    p.add_argument("--output-dir", type=str, default=None)
    p.add_argument("--snapshot", type=str, default=None,
                   help="full train state to resume (JAX or port written)")
    p.add_argument("--category", type=str, default="All")
    p.add_argument("--detections", type=str, default="centertrack")
    p.add_argument("--feats", type=str, default="2d+temp+vis",
                   help="any combination of 2d, temp, vis")
    p.add_argument("--embed-arch", type=str, default="espv2", help="espv2/dla34")
    p.add_argument("--cur-win-size", type=int, default=5)
    p.add_argument("--ret-win-size", type=int, default=0)
    p.add_argument("--hungarian", action="store_true", default=False)
    p.add_argument("--no-tp-classifier", action="store_true", default=False)
    p.add_argument("--num-hidden-feats", type=int, default=64)
    p.add_argument("--num-att-heads", type=int, default=0)
    p.add_argument("--msg-type", type=str, default="diff", help="diff/concat")
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--learning-rate", type=float, default=1e-4)
    p.add_argument("--momentum", type=float, default=0.9,
                   help="accepted for reference config compatibility; "
                        "the Adam recipe (like the reference's) ignores it")
    p.add_argument("--weight-decay", type=float, default=5e-4)
    p.add_argument("--log-schedule", type=int, default=10)
    p.add_argument("--seed", type=int, default=5)
    p.add_argument("--plot-gradients", action="store_true", default=False)
    p.add_argument("--random-transforms", action="store_true", default=False)
    p.add_argument("--batch-windows", type=int, default=1,
                   help="windows per step: 1 the batch-1 step, more the block step "
                        "(the packed step with TM_PACKED=1)")
    p.add_argument("--mesh", type=str, default=None,
                   help="device mesh, e.g. 'data=4,edge=2' (not ported)")
    p.add_argument("--slot-cap", type=int, default=0,
                   help="fixed slot capacity (0 = auto bucket)")
    p.add_argument("--embed-input-h", type=int, default=0,
                   help="embedding-net input height (0 = dataset default)")
    p.add_argument("--embed-input-w", type=int, default=0,
                   help="embedding-net input width (0 = dataset default)")
    p.add_argument("--train-bn", action="store_true", default=False,
                   help="embed net uses live batch BN statistics while "
                        "training (reference .train() semantics); default "
                        "freezes BN to running stats")
    p.add_argument("--embed-bf16", action=argparse.BooleanOptionalAction, default=False,
                   help="bf16 embedding-net convs (not ported: the backbones run in f32)")
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=True,
                   help="bf16 edge state in the block step (not ported: the block "
                        "route needs --no-bf16)")
    p.add_argument("--fused", action=argparse.BooleanOptionalAction, default=True,
                   help="a TPU composition of the block round with the same result; "
                        "the card has one block round, its kernels")
    p.add_argument("--defer-loss", action=argparse.BooleanOptionalAction, default=None,
                   help="a TPU composition of the block step's losses with the same "
                        "result; parsed and ignored on the card")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the model runs; cuda raises if there is no card")
    return p


def validate_train_args(args) -> None:
    if args.dataset == "kitti":
        if args.category not in KITTI_CATS:
            raise ValueError("unrecognized KITTI category")
        if args.detections not in ("centertrack", "rrc"):
            raise ValueError("unrecognized KITTI detections")
    elif args.dataset == "bdd100k":
        if args.category not in BDD_CATS:
            raise ValueError("unrecognized BDD100K category")
        if args.detections not in ("hin", "libra"):
            raise ValueError("unrecognized BDD100K detections")
    else:
        raise ValueError("unrecognized dataset")
    if args.embed_arch not in ("espv2", "dla34"):
        raise ValueError("unrecognized embedding architecture")


def train_route(args) -> str:
    """The train step --batch-windows and TM_PACKED pick, as the JAX CLI
    routes them (cli/train.py:259-320): "batch1" (train/step.py), "block"
    (train/block.py) or "packed" (train/packed.py)."""
    if max(args.batch_windows, 1) == 1:
        return "batch1"
    return "packed" if os.environ.get("TM_PACKED", "0") == "1" else "block"


def check_ported(args) -> None:
    """Raise NotImplementedError for a flag whose path the port does not
    run, naming its ROADMAP.md queue 1 item."""
    refuse = []
    if args.dataset == "bdd100k":
        refuse.append("--dataset bdd100k ('BDD100K data')")
    if args.mesh:
        refuse.append("--mesh ('Multi-GPU')")
    if args.plot_gradients:
        refuse.append("--plot-gradients ('Tail')")
    if args.embed_bf16:
        refuse.append("--embed-bf16 ('bf16 rectangles')")
    if args.bf16 and train_route(args) == "block":
        refuse.append("--bf16 on the block route ('bf16 rectangles'; pass --no-bf16)")
    if refuse:
        raise NotImplementedError("not ported yet (ROADMAP.md queue 1): " + "; ".join(refuse))


def parse_train_args(argv=None):
    """Parse, validate and refuse before the output directory is made."""
    args = build_train_parser().parse_args(argv)
    validate_train_args(args)
    check_ported(args)
    return finalize_args(args, "train")


def build_infer_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("TrackMPNN (PyTorch) inference options")
    p.add_argument("--dataset-root-path", type=str, default=None)
    p.add_argument("--output-dir", type=str, default=None)
    p.add_argument("--snapshot", type=str, required=True)
    p.add_argument("--hungarian", action="store_true", default=False)
    p.add_argument("--seed", type=int, default=5,
                   help="accepted so that the JAX CLI's command lines run unchanged; "
                        "the weights all come from the snapshot")
    p.add_argument("--override-cur-win-size", type=int, default=0,
                   help="override the inherited rolling-window size "
                        "(window-sweep ablations); 0 = inherit")
    p.add_argument("--prune-threshold", type=float, default=None,
                   help="optional per-step low-score edge pruning")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the model runs; cuda raises if there is no card")
    return p


def inherit_training_config(args, snapshot_path: Optional[str] = None):
    """Pull model-shape flags from the training config.json beside the
    snapshot (ref infer_options.py:32-47)."""
    snapshot_path = snapshot_path or args.snapshot
    cfg_path = os.path.join(os.path.dirname(snapshot_path), "config.json")
    if not os.path.exists(cfg_path):
        raise FileNotFoundError(
            f"no config.json beside the snapshot ({cfg_path}); inference "
            "inherits model-shape flags from the training config "
            "(ref infer_options.py:32-47) - copy it next to the checkpoint")
    with open(cfg_path) as f:
        train_cfg = json.load(f)
    for k in INHERITED_KEYS:
        if k in train_cfg:
            setattr(args, k, train_cfg[k])
    args.tp_classifier = not getattr(args, "no_tp_classifier", False)
    return args


def finalize_args(args, kind: str = "infer"):
    """Derive tp_classifier, create the output dir (refusing to overwrite)
    and persist config.json (ref training_options.py:56-71)."""
    args.tp_classifier = not getattr(args, "no_tp_classifier", False)
    if args.output_dir is None:
        stamp = datetime.now().strftime("%Y-%m-%d-%H:%M")
        if kind != "train":
            stamp += "-" + kind
        args.output_dir = os.path.join(".", "experiments", stamp)
    if os.path.exists(args.output_dir):
        raise FileExistsError(f"output directory exists: {args.output_dir}")
    os.makedirs(args.output_dir)
    with open(os.path.join(args.output_dir, "config.json"), "w") as f:
        json.dump(vars(args), f)
    return args


def parse_infer_args(argv=None):
    args = build_infer_parser().parse_args(argv)
    args = inherit_training_config(args)
    if args.override_cur_win_size:
        args.cur_win_size = args.override_cur_win_size
    return finalize_args(args)
