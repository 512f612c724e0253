"""Checkpoints in the JAX package's format (trackmpnn_tpu/train/checkpoint.py).

One .npz whose array keys are pytree key paths prefixed "arr:"
("arr:params/branches/0/edge_gru/w_ih", ...) and whose "__scalars__" entry
is a JSON dict of the Python scalars (epoch, best_mota, ...).  None
subtrees (an absent optimizer state) write nothing.  So a snapshot trained
by the JAX package serves in the port as it is, and one the port writes
loads in the JAX package.

The training CLI's checkpoints hold the full train state
(trackmpnn_tpu/train/checkpoint.py): params, batch_stats, the optimizer
state, epoch and best_mota.  The optimizer state is optax's
inject_hyperparams(chain(add_decayed_weights, scale_by_adam, scale))
(trackmpnn_tpu/train/optim.py:24-41): opt_state/count, opt_state/
hyperparams/{learning_rate, weight_decay} and opt_state/inner_state/1/
{count, mu/<param path>, nu/<param path>}, which are torch Adam's step, lr,
weight_decay, exp_avg and exp_avg_sq (save_state, load_state,
load_optimizer_state).

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
from trackmpnn_tpu_torch.train.block import param_leaves


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


def _adam_moments(optimizer, leaves):
    """(count, exp_avg of each leaf, exp_avg_sq of each leaf): zeros for a
    leaf without state; count the largest step (one count in optax)."""
    count, mu, nu = 0, [], []
    for p in leaves:
        st = optimizer.state.get(p, {})
        count = max(count, int(st["step"]) if "step" in st else 0)
        mu.append(st.get("exp_avg", torch.zeros_like(p)))
        nu.append(st.get("exp_avg_sq", torch.zeros_like(p)))
    return count, mu, nu


def _set_adam_moments(optimizer, leaves, count, mu, nu):
    """Torch Adam's per-parameter state from optax's; no state at count 0
    (a fresh Adam's)."""
    for p, m, v in zip(leaves, mu, nu):
        optimizer.state.pop(p, None)
        if count > 0:
            moment = lambda a: torch.as_tensor(a, dtype=torch.float32, device=p.device).clone()
            optimizer.state[p] = {"step": torch.tensor(float(count)), "exp_avg": moment(m),
                                  "exp_avg_sq": moment(v)}


def _hyperparams(group):
    return {"learning_rate": np.float32(group["lr"]),
            "weight_decay": np.float32(group["weight_decay"])}


def save_state(path: str, params, batch_stats, optimizer, cfg: ModelConfig, epoch: int,
               best_mota: float) -> None:
    """The full train state as the JAX training CLI writes it, so that
    either package resumes it: params and batch_stats, optimizer (torch Adam
    over train/block.py::param_leaves(params)) as optax's state, epoch and
    best_mota."""
    p, s = weights.to_jax_params(params, batch_stats, cfg)
    shapes = weights.param_shapes(cfg)
    count, mu, nu = _adam_moments(optimizer, param_leaves(params))
    tree = lambda leaves: _unflatten_like(shapes, iter(leaves))
    save(path, {"params": p, "batch_stats": s,
                "opt_state": {"count": np.int32(count),
                              "hyperparams": _hyperparams(optimizer.param_groups[0]),
                              "inner_state": [None, {"count": np.int32(count), "mu": tree(mu),
                                                     "nu": tree(nu)}]},
                "epoch": int(epoch), "best_mota": float(best_mota)})


def _unflatten_like(shapes, it):
    """A tree of `shapes`' structure whose leaves are taken from `it` in
    train/block.py::param_leaves order (dict keys sorted)."""
    if isinstance(shapes, dict):
        return {k: _unflatten_like(shapes[k], it) for k in sorted(shapes)}
    if isinstance(shapes, list):
        return [_unflatten_like(v, it) for v in shapes]
    return next(it)


def _read(data, path):
    """An npz entry: the array of "arr:path", or the scalar "path"."""
    if "arr:" + path in data.files:
        return data["arr:" + path]
    scalars = json.loads(str(data["__scalars__"]))
    if path not in scalars:
        raise KeyError(f"checkpoint is missing leaf {path!r}")
    return np.asarray(scalars[path])


def load_state(path: str, cfg: ModelConfig, device="cpu"):
    """(params, batch_stats, epoch, best_mota) of a full train state (JAX
    or port written), on `device`; the optimizer state is read by
    load_optimizer_state."""
    params, stats = load(path, cfg, device)
    with np.load(path, allow_pickle=False) as data:
        return params, stats, int(_read(data, "epoch")), float(_read(data, "best_mota"))


def load_optimizer_state(path: str, optimizer, params, cfg: ModelConfig) -> None:
    """Set `optimizer` (torch Adam over param_leaves(params)) from the
    checkpoint's optax state: each leaf's step, exp_avg and exp_avg_sq, and
    the group's lr and weight_decay."""
    shapes = weights.param_shapes(cfg)
    with np.load(path, allow_pickle=False) as data:
        count = int(_read(data, "opt_state/inner_state/1/count"))

        def moments(kind):
            def leaf(_, shape, key):
                a = _read(data, f"opt_state/inner_state/1/{kind}/{key}")
                if a.shape != tuple(shape):
                    raise ValueError(f"{kind}/{key}: expected shape {tuple(shape)}, "
                                     f"got {a.shape}")
                return a.astype(np.float32)
            return param_leaves(weights.map_shaped(leaf, shapes, shapes))

        mu, nu = moments("mu"), moments("nu")
        lr = float(_read(data, "opt_state/hyperparams/learning_rate"))
        wd = float(_read(data, "opt_state/hyperparams/weight_decay"))
    _set_adam_moments(optimizer, param_leaves(params), count, mu, nu)
    for group in optimizer.param_groups:
        group["lr"], group["weight_decay"] = lr, wd


def save_embed(path: str, trainer) -> None:
    """An EmbedTrainer's net and Adam state as the JAX package's vis-net
    snapshot, which its cli/train.py::load_vis_net restores: params/<key>
    the backbone's flat dict; opt_state/count and .../inner_state/1/count
    the step count, opt_state/hyperparams the lr and L2, .../1/mu/<key> and
    .../1/nu/<key> Adam's moments of each trained parameter (the BN running
    statistics are masked out there and have none), zero before a step."""
    names, leaves = zip(*trainer.net.named_parameters())
    count, mu, nu = _adam_moments(trainer.opt, leaves)
    adam = {"count": np.int32(count), "mu": state_dict_to_jax(dict(zip(names, mu))),
            "nu": state_dict_to_jax(dict(zip(names, nu)))}
    save(path, {"params": backbone_to_jax_params(trainer.net),
                "opt_state": {"count": np.int32(count),
                              "hyperparams": _hyperparams(trainer.opt.param_groups[0]),
                              "inner_state": {"inner_state": [None, adam]}}})


def load_embed(path: str, trainer) -> None:
    """Set an EmbedTrainer's net (weights and BN running statistics) and its
    Adam state (step, moments, lr, L2) from a JAX-format vis-net snapshot."""
    prefix = "arr:opt_state/inner_state/inner_state/1/"
    names, leaves = zip(*trainer.net.named_parameters())
    like = dict(zip(names, leaves))
    with np.load(path, allow_pickle=False) as data:
        flat = {name[len("arr:params/"):]: data[name] for name in data.files
                if name.startswith("arr:params/")}
        trainer.net.load_state_dict(state_dict_from_jax(flat, trainer.net.state_dict()))
        moments = {kind: state_dict_from_jax(
            {name[len(prefix) + 3:]: data[name] for name in data.files
             if name.startswith(f"{prefix}{kind}/")}, like) for kind in ("mu", "nu")}
        count = int(_read(data, "opt_state/inner_state/inner_state/1/count"))
        lr = float(_read(data, "opt_state/hyperparams/learning_rate"))
        wd = float(_read(data, "opt_state/hyperparams/weight_decay"))
    _set_adam_moments(trainer.opt, leaves, count, [moments["mu"][n] for n in names],
                      [moments["nu"][n] for n in names])
    for group in trainer.opt.param_groups:
        group["lr"], group["weight_decay"] = lr, wd
