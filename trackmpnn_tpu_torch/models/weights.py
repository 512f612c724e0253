"""Carry weights between the JAX package and the port.

The JAX package's parameters (mpnn.init_params) and BatchNorm running
stats (mpnn.init_batch_stats) are pytrees of nested dicts and lists.  The
port keeps the same nesting and the same layout (models/nn.py: linear w
[in, out], GRU w_ih/w_hh [in, 3H] with column blocks [r | z | n]), so the
conversion is a checked copy: every leaf must be present with the shape
the config implies, and nothing else may be.
"""

from __future__ import annotations

import numpy as np
import torch

from trackmpnn_tpu_torch.models.mpnn import ModelConfig, check_supported


def param_shapes(cfg: ModelConfig):
    """The parameter tree of `cfg`, each leaf its shape."""
    H = cfg.nhidden
    gru = lambda n_in: {"w_ih": (n_in, 3 * H), "w_hh": (H, 3 * H),
                        "b_ih": (3 * H,), "b_hh": (3 * H,)}
    branches = [{
        "input": {"lin1": {"w": (width, H), "b": (H,)},
                  "bn": {"gamma": (H,), "beta": (H,)},
                  "lin2": {"w": (H, H), "b": (H,)}},
        "edge_gru": gru(2 * H if cfg.msg_type == "concat" else H),
        "node_gru": gru(H),
    } for _, width in cfg.branches]
    if cfg.nattheads > 0:
        for b in branches:
            b["gat"] = [{"W_att": (H, H), "a": (H, 1)} for _ in range(cfg.nattheads)]
    nb = len(cfg.branches)
    return {"branches": branches,
            "out_node": {"w": (nb * H, 1), "b": (1,)},
            "out_edge": {"w": (nb * H, 1), "b": (1,)}}


def stats_shapes(cfg: ModelConfig):
    return {"branches": [{"bn": {"mean": (cfg.nhidden,), "var": (cfg.nhidden,)}}
                         for _ in cfg.branches]}


def map_shaped(fn, tree, shapes, path=""):
    """fn(leaf, shape, path) over `tree`, which must have exactly the keys
    and list lengths of `shapes`."""
    if isinstance(shapes, dict):
        if not isinstance(tree, dict) or set(tree) != set(shapes):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"{path or '<root>'}: expected keys {sorted(shapes)}, got {got}")
        return {k: map_shaped(fn, tree[k], shapes[k], f"{path}/{k}") for k in shapes}
    if isinstance(shapes, list):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(shapes):
            raise ValueError(f"{path}: expected a list of {len(shapes)}")
        return [map_shaped(fn, t, s, f"{path}/{i}") for i, (t, s) in enumerate(zip(tree, shapes))]
    return fn(tree, shapes, path.lstrip("/"))


def _to_tensor(device):
    def conv(leaf, shape, path):
        a = np.asarray(leaf, dtype=np.float32)
        if a.shape != tuple(shape):
            raise ValueError(f"{path}: expected shape {tuple(shape)}, got {a.shape}")
        return torch.tensor(a, device=device)
    return conv


def from_jax_params(params_np, batch_stats_np, cfg: ModelConfig, device="cpu"):
    """JAX parameter and BN-stat pytrees (numpy leaves) -> the port's."""
    check_supported(cfg)
    params = map_shaped(_to_tensor(device), params_np, param_shapes(cfg))
    stats = map_shaped(_to_tensor(device), batch_stats_np, stats_shapes(cfg))
    return params, stats


def _to_numpy(leaf, shape, path):
    return leaf.detach().cpu().numpy()


def to_jax_params(params, batch_stats, cfg: ModelConfig):
    """The port's parameters and BN stats -> JAX-layout pytrees of numpy arrays."""
    return (map_shaped(_to_numpy, params, param_shapes(cfg)),
            map_shaped(_to_numpy, batch_stats, stats_shapes(cfg)))


def to_device(params, batch_stats, cfg: ModelConfig, device):
    """Both trees with every tensor moved to `device`."""
    move = lambda leaf, shape, path: leaf.to(device)
    return (map_shaped(move, params, param_shapes(cfg)),
            map_shaped(move, batch_stats, stats_shapes(cfg)))
