"""Optimizer and LR schedule of the reference recipe (the counterpart of
trackmpnn_tpu/train/optim.py).

torch.optim.Adam with weight_decay adds wd * param to the *gradient* before
the moment updates (L2, not AdamW), which is the form the JAX package
builds from optax (add_decayed_weights, then scale_by_adam), and StepLR
multiplies the lr by gamma every `step_size` epochs (ref train.py:329-330:
Adam(lr=1e-4, wd=5e-4), StepLR(15, 0.2)).
"""

from __future__ import annotations

import torch


def step_lr(base_lr: float, step_size: int = 15, gamma: float = 0.2):
    """epoch (1-indexed like the reference loop) -> lr."""

    def lr(epoch: int) -> float:
        return base_lr * (gamma ** ((epoch - 1) // step_size))

    return lr


def make_optimizer(params, learning_rate: float = 1e-4, weight_decay: float = 5e-4):
    """Adam with L2 over `params`, an iterable of leaf tensors (see
    train/block.py::param_leaves for the parameter tree)."""
    return torch.optim.Adam(list(params), lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay)


def set_lr(optimizer, lr: float):
    for group in optimizer.param_groups:
        group["lr"] = lr
    return optimizer
