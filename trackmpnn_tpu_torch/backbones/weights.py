"""Carry backbone weights between the JAX package and the port.

The JAX package keeps a backbone's parameters and BatchNorm running
statistics in one flat dict keyed by the reference's torch module paths
(trackmpnn_tpu/backbones/layers.py:4-7).  The port's state_dict has the
same keys (plus BatchNorm's num_batches_tracked, which JAX does not keep),
so the conversion is a layout change per key:

  conv            HWIO [kh, kw, I/groups, O]  <->  OIHW [O, I/groups, kh, kw]
  DCN weight      [9*C, O], row k*C + c (k = kh*3 + kw)  <->  [O, C, 3, 3]
  up-conv weight  [2f, 2f, 1, o]  <->  [o, 1, 2f, 2f]  (the conv rule)
  everything else (biases, BN, PReLU) as it is.
"""

from __future__ import annotations

import numpy as np
import torch

from trackmpnn_tpu_torch.backbones.dla import DLASeg
from trackmpnn_tpu_torch.backbones.espnetv2 import ESPNetv2Seg

_SKIP = "num_batches_tracked"


def _is_dcn_weight(key: str, keys) -> bool:
    return key.rpartition(".")[2] == "weight" and f"{key[:-6]}conv_offset_mask.weight" in keys


def state_dict_from_jax(params_np, like: dict) -> dict:
    """The port's state dict for the JAX flat dict `params_np`, with the
    keys and shapes of `like` (a module's state_dict()); every key of one
    must be in the other, num_batches_tracked aside."""
    want = {k for k in like if not k.endswith(_SKIP)}
    if want != set(params_np):
        raise KeyError(f"parameter names differ: only in the port {sorted(want - set(params_np))}"
                       f", only in the JAX dict {sorted(set(params_np) - want)}")
    out = {}
    for key, ref in like.items():
        if key.endswith(_SKIP):
            out[key] = ref.clone()
            continue
        a = np.asarray(params_np[key], np.float32)
        if _is_dcn_weight(key, like):
            o, c, kh, kw = ref.shape
            a = a.reshape(kh, kw, c, o).transpose(3, 2, 0, 1)
        elif a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        if tuple(a.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: JAX shape {np.shape(params_np[key])} does not map to "
                             f"{tuple(ref.shape)}")
        out[key] = torch.from_numpy(np.ascontiguousarray(a)).to(ref.dtype)
    return out


def state_dict_to_jax(state_dict: dict) -> dict:
    """The JAX flat dict (numpy leaves) for a port state dict."""
    out = {}
    for key, t in state_dict.items():
        if key.endswith(_SKIP):
            continue
        a = t.detach().cpu().numpy()
        if _is_dcn_weight(key, state_dict):
            o, c, kh, kw = a.shape
            a = a.transpose(2, 3, 1, 0).reshape(kh * kw * c, o)
        elif a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)
        out[key] = np.ascontiguousarray(a)
    return out


def make_backbone(arch: str, num_vis_feats: int = 128, dcn_max_offset=None,
                  generator: torch.Generator | None = None):
    """The embedding trainer's backbone: 'espv2' (ESPNetv2Seg) or 'dla34'
    (DLASeg with the 'trk' head)."""
    if arch == "espv2":
        return ESPNetv2Seg(classes=num_vis_feats, generator=generator)
    if arch == "dla34":
        return DLASeg({"trk": num_vis_feats}, dcn_max_offset=dcn_max_offset, generator=generator)
    raise ValueError(f"unknown embed arch {arch!r}")


def backbone_from_jax_params(arch: str, params_np, dcn_max_offset=None):
    """A backbone module holding the JAX flat dict's weights (CPU)."""
    key = "project_l1.1.conv.weight" if arch == "espv2" else "trk.2.weight"
    net = make_backbone(arch, int(np.shape(params_np[key])[-1]), dcn_max_offset)
    net.load_state_dict(state_dict_from_jax(params_np, net.state_dict()))
    return net


def backbone_to_jax_params(net: torch.nn.Module) -> dict:
    """The JAX flat dict of a backbone module's weights."""
    return state_dict_to_jax(net.state_dict())
