"""NN primitives as plain functions on parameter dicts of tensors (the
counterpart of trackmpnn_tpu/models/nn.py).

Weights keep the JAX package's layout, so a converted checkpoint needs no
transposes: a linear weight is [in, out] and is right-multiplied; a GRU's
w_ih/w_hh are [in, 3H] with column blocks [r | z | n], the transpose of
torch.nn.GRUCell's weight_ih/weight_hh (whose row blocks are r; z; n).
"""

from __future__ import annotations

import torch

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


# ---------------------------------------------------------------- linear ----
def linear_init(generator, n_in, n_out, w_std=0.01, b_val=0.0, device="cpu"):
    """Reference-style init: N(0, w_std) weights, constant bias."""
    w = w_std * torch.randn(n_in, n_out, generator=generator)
    return {"w": w.to(device), "b": torch.full((n_out,), float(b_val), device=device)}


def linear(params, x):
    return x @ params["w"] + params["b"]


def xavier_uniform(generator, shape, gain=1.0, device="cpu"):
    """torch.nn.init.xavier_uniform_: U(-a, a), a = gain * sqrt(6 / (fan_in + fan_out))."""
    a = gain * (6.0 / (shape[0] + shape[1])) ** 0.5
    return ((2.0 * torch.rand(shape, generator=generator) - 1.0) * a).to(device)


# ------------------------------------------------------------- batchnorm ----
def batchnorm_init(n, device="cpu"):
    return {"gamma": torch.ones(n, device=device), "beta": torch.zeros(n, device=device)}


def batchnorm_stats_init(n, device="cpu"):
    return {"mean": torch.zeros(n, device=device), "var": torch.ones(n, device=device)}


def masked_batchnorm(params, stats, x, mask, *, train):
    """BatchNorm1d over the masked rows of x.

    torch semantics: train mode normalizes with the biased batch variance and
    updates running stats with the *unbiased* variance
    (running = (1-m)*running + m*batch); eval mode uses running stats.
    Rows where mask is False neither contribute statistics nor produce
    meaningful output (they are normalized too, but callers mask them out).

    Returns (y, new_stats).
    """
    if train:
        mask_f = mask.to(x.dtype)[:, None]
        cnt = torch.clamp(mask_f.sum(), min=1.0)
        mean = (x * mask_f).sum(0) / cnt
        var_b = (((x - mean) ** 2) * mask_f).sum(0) / cnt  # biased
        y = (x - mean) * torch.rsqrt(var_b + BN_EPS)
        var_u = var_b * cnt / torch.clamp(cnt - 1.0, min=1.0)  # unbiased
        new_stats = {
            "mean": (1 - BN_MOMENTUM) * stats["mean"] + BN_MOMENTUM * mean,
            "var": (1 - BN_MOMENTUM) * stats["var"] + BN_MOMENTUM * var_u,
        }
    else:
        y = (x - stats["mean"]) * torch.rsqrt(stats["var"] + BN_EPS)
        new_stats = stats
    return y * params["gamma"] + params["beta"], new_stats


# ------------------------------------------------------------------- gru ----
def gru_init(generator, n_in, n_hidden, w_std=0.01, device="cpu"):
    """GRU cell params in the JAX layout: [in, 3H], column blocks [r | z | n]."""
    w_ih = w_std * torch.randn(n_in, 3 * n_hidden, generator=generator)
    w_hh = w_std * torch.randn(n_hidden, 3 * n_hidden, generator=generator)
    return {
        "w_ih": w_ih.to(device),
        "w_hh": w_hh.to(device),
        "b_ih": torch.zeros(3 * n_hidden, device=device),
        "b_hh": torch.zeros(3 * n_hidden, device=device),
    }


def gru_cell(params, x, h):
    """torch.nn.GRUCell:  r,z gates sigmoid; n tanh with r-gated hidden path.

    h' = (1 - z) * n + z * h
    """
    H = h.shape[-1]
    gi = x @ params["w_ih"] + params["b_ih"]
    gh = h @ params["w_hh"] + params["b_hh"]
    r = torch.sigmoid(gi[..., :H] + gh[..., :H])
    z = torch.sigmoid(gi[..., H : 2 * H] + gh[..., H : 2 * H])
    n = torch.tanh(gi[..., 2 * H :] + r * gh[..., 2 * H :])
    return (1.0 - z) * n + z * h


# ------------------------------------------------------- input transform ----
def input_transform_init(generator, n_in, n_out, device="cpu"):
    """Linear -> BatchNorm1d -> ReLU -> Linear (ref track_mpnn.py:45-52)."""
    return {
        "lin1": linear_init(generator, n_in, n_out, device=device),
        "bn": batchnorm_init(n_out, device),
        "lin2": linear_init(generator, n_out, n_out, device=device),
    }


def input_transform(params, stats, x, mask, *, train):
    y = linear(params["lin1"], x)
    y, new_stats = masked_batchnorm(params["bn"], stats, y, mask, train=train)
    y = torch.relu(y)
    y = linear(params["lin2"], y)
    return y, new_stats
