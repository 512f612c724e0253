"""Checkpoints in the JAX package's format (trackmpnn_tpu/train/checkpoint.py).

One .npz whose array keys are pytree key paths prefixed "arr:"
("arr:params/branches/0/edge_gru/w_ih", ...) and whose "__scalars__" entry
is a JSON dict of the Python scalars (epoch, best_mota, ...).  None
subtrees (an absent optimizer state) write nothing.  So a snapshot trained
by the JAX package serves in the port as it is, and one the port writes
loads in the JAX package.

The embedding net's snapshot (vis-net_*.npz beside track-mpnn_*.npz) is
the JAX package's checkpoint.save({"params", "opt_state"}) of its
EmbedTrainer: the backbone's flat dict under params/ (backbones/weights.py
maps it) and optax's inject_hyperparams(masked(adam with L2)) state under
opt_state/ (save_embed, load_embed).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from trackmpnn_tpu_torch.backbones.weights import (backbone_to_jax_params, state_dict_from_jax,
                                                  state_dict_to_jax)
from trackmpnn_tpu_torch.models import weights
from trackmpnn_tpu_torch.models.mpnn import ModelConfig


def _flatten(tree, prefix=""):
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def save(path: str, state) -> None:
    """state: nested dicts/lists of tensors, numpy arrays, Python scalars and None."""
    arrays, scalars = {}, {}
    for key, leaf in _flatten(state):
        if isinstance(leaf, (int, float, bool, str)):
            scalars[key] = leaf
        elif isinstance(leaf, torch.Tensor):
            arrays["arr:" + key] = leaf.detach().cpu().numpy()
        else:
            arrays["arr:" + key] = np.asarray(leaf)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, __scalars__=json.dumps(scalars), **arrays)


def save_model(path: str, params, batch_stats, cfg: ModelConfig, epoch: int = 0,
               best_mota: float = 0.0) -> None:
    """A snapshot with the keys the JAX inference CLI restores."""
    p, s = weights.to_jax_params(params, batch_stats, cfg)
    save(path, {"params": p, "batch_stats": s, "epoch": epoch, "best_mota": best_mota})


def load(path: str, cfg: ModelConfig, device="cpu"):
    """(params, batch_stats) of `cfg` from a snapshot, on `device`; extra
    entries (optimizer state, scalars) are ignored."""
    with np.load(path, allow_pickle=False) as data:
        def read(prefix):
            def leaf(_, shape, key):
                name = f"arr:{prefix}/{key}"
                if name not in data.files:
                    raise KeyError(f"checkpoint {path} is missing leaf {name[4:]!r}")
                return data[name]
            return leaf

        shapes, stat_shapes = weights.param_shapes(cfg), weights.stats_shapes(cfg)
        params_np = weights.map_shaped(read("params"), shapes, shapes)
        stats_np = weights.map_shaped(read("batch_stats"), stat_shapes, stat_shapes)
    return weights.from_jax_params(params_np, stats_np, cfg, device)


def save_embed(path: str, trainer) -> None:
    """An EmbedTrainer's net and Adam state as the JAX package's vis-net
    snapshot, which its cli/train.py::load_vis_net restores: params/<key>
    the backbone's flat dict; opt_state/count and .../inner_state/1/count
    the step count, opt_state/hyperparams the lr and L2, .../1/mu/<key> and
    .../1/nu/<key> Adam's moments of each trained parameter (the BN running
    statistics are masked out there and have none), zero before a step."""
    group = trainer.opt.param_groups[0]
    moments = {"mu": {}, "nu": {}}
    count = 0
    for name, p in trainer.net.named_parameters():
        st = trainer.opt.state.get(p, {})
        count = max(count, int(st["step"]) if "step" in st else 0)
        moments["mu"][name] = st.get("exp_avg", torch.zeros_like(p))
        moments["nu"][name] = st.get("exp_avg_sq", torch.zeros_like(p))
    adam = {"count": np.int32(count),
            **{k: state_dict_to_jax(v) for k, v in moments.items()}}
    save(path, {"params": backbone_to_jax_params(trainer.net),
                "opt_state": {"count": np.int32(count),
                              "hyperparams": {"learning_rate": np.float32(group["lr"]),
                                              "weight_decay": np.float32(group["weight_decay"])},
                              "inner_state": {"inner_state": [None, adam]}}})


def load_embed(path: str, trainer) -> None:
    """Set an EmbedTrainer's net (weights and BN running statistics) from a
    JAX-format vis-net snapshot.  Its optimizer state is not read: it
    matters only to a trainer that goes on training, and the port's
    trainer serves from a snapshot (the training CLI that would resume one
    is ROADMAP.md queue 1, 'Training CLI')."""
    with np.load(path, allow_pickle=False) as data:
        flat = {name[len("arr:params/"):]: data[name] for name in data.files
                if name.startswith("arr:params/")}
    trainer.net.load_state_dict(state_dict_from_jax(flat, trainer.net.state_dict()))
