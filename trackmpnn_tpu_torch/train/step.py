"""The batch-1 train step in row layout (the counterpart of
trackmpnn_tpu/train/step.py): one window's schedule, step after step.

Every step runs mpnn.forward on the window's live prefix (the gather-diff
and signed-scatter kernels of ops/mp.py, each the other's backward; with
msg 'concat' gather_concat, whose backward is the halves pull) and the
row-layout losses (losses/losses.py); the loss of the window is the sum
over steps of CE + BCE, and one backward runs through all steps (the
truncated BPTT over the whole chunk of ref train.py:92-134).

The JAX package scans all t_cap steps and masks the padding ones.  Here the
per-step counts stay on the host, so the loop builds each step's masks
without waiting for the card and skips a padding step outright: it would
keep h and the BN stats and add zero loss (step.py:83-91 of the JAX
package), so the result is the same.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from trackmpnn_tpu_torch.graph.view import GraphView
from trackmpnn_tpu_torch.losses.losses import step_losses
from trackmpnn_tpu_torch.models import mpnn
from trackmpnn_tpu_torch.ops import mp


class ScheduleBatch(NamedTuple):
    """One WindowSchedule (graph/schedule.py): the slot arrays on the
    device, the per-step counts on the host."""

    is_det: torch.Tensor      # bool[cap]
    past: torch.Tensor        # int32[cap]
    fut: torch.Tensor         # int32[cap]
    label: torch.Tensor       # int32[cap]
    feat: torch.Tensor        # f32[cap, F]
    n_before: np.ndarray      # int32[t_cap]  (host)
    n_after: np.ndarray       # int32[t_cap]  (host)
    step_valid: np.ndarray    # bool[t_cap]   (host)
    # signed_segment_sum's incidence of past/fut (ops/mp.py::
    # segment_incidence), built once here for every round and backward on
    # the card; None on the CPU
    inc: tuple


def schedule_to_device(ws, device="cuda") -> ScheduleBatch:
    """The schedule's arrays on `device`, with its incidence built there
    where the kernel reads it (mp.kernel_incidence)."""
    put = lambda a, dtype: torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)
    past, fut = put(ws.past, np.int32), put(ws.fut, np.int32)
    return ScheduleBatch(
        is_det=put(ws.is_det, bool), past=past, fut=fut, label=put(ws.label, np.int32),
        feat=put(ws.feat, np.float32),
        n_before=np.asarray(ws.n_before, np.int32), n_after=np.asarray(ws.n_after, np.int32),
        step_valid=np.asarray(ws.step_valid, bool), inc=mp.kernel_incidence(past, fut, len(past)))


def tree_map(fn, tree):
    """fn over the leaves of a nested dict/list of tensors."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def window_forward(params, batch_stats, cfg: mpnn.ModelConfig, sb: ScheduleBatch,
                   tp_classifier: bool, train: bool = True,
                   generator: Optional[torch.Generator] = None,
                   att_keep: Optional[Sequence] = None):
    """(total_loss, aux) of one window: the sum over valid steps of CE + BCE.

    aux: loss_ce, loss_f (detached), per-step tp, fp, fn and step_valid
    [t_cap], the final hidden state and the new BN running stats (both
    detached).  With attention heads, training drops attention weights:
    att_keep[s] is step s's per-branch, per-head keep masks (mpnn.forward),
    or else `generator` draws them; one of the two is needed."""
    mpnn.check_supported(cfg)
    if train and cfg.nattheads > 0 and generator is None and att_keep is None:
        raise ValueError("training with attention heads needs a generator for the "
                         "attention dropout (pass generator=...)")
    cap = sb.is_det.shape[0]
    dev = sb.feat.device
    idx = torch.arange(cap, device=dev)
    h = torch.zeros(cap, len(cfg.branches) * cfg.nhidden, device=dev)
    stats = batch_stats
    zero = torch.zeros((), device=dev)
    izero = torch.zeros((), dtype=torch.int64, device=dev)
    l_ce, l_f, tp, fp, fn = [], [], [], [], []
    for s in range(len(sb.step_valid)):
        if not sb.step_valid[s]:
            for acc, z in ((l_ce, zero), (l_f, zero), (tp, izero), (fp, izero), (fn, izero)):
                acc.append(z)
            continue
        live = idx < int(sb.n_after[s])
        new = (idx >= int(sb.n_before[s])) & live
        g = GraphView(is_det=sb.is_det, past=sb.past, fut=sb.fut, live=live, new=new,
                      feat=sb.feat, inc=sb.inc)
        out, stats = mpnn.forward(params, stats, cfg, g, h, train=train, generator=generator,
                                  att_keep=None if att_keep is None else att_keep[s])
        ce, f, (t_p, f_p, f_n), _ = step_losses(out.scores, out.logits, sb.label, sb.is_det,
                                                sb.past, sb.fut, live, tp_classifier)
        h = out.hidden
        for acc, v in ((l_ce, ce), (l_f, f), (tp, t_p), (fp, f_p), (fn, f_n)):
            acc.append(v)
    l_ce, l_f = torch.stack(l_ce), torch.stack(l_f)
    aux = {
        "loss_ce": l_ce.sum().detach(), "loss_f": l_f.sum().detach(),
        "tp": torch.stack(tp), "fp": torch.stack(fp), "fn": torch.stack(fn),
        "step_valid": torch.from_numpy(np.asarray(sb.step_valid, bool)),
        "hidden": h.detach(), "batch_stats": tree_map(torch.Tensor.detach, stats),
    }
    return l_ce.sum() + l_f.sum(), aux


def make_train_step(cfg: mpnn.ModelConfig, tp_classifier: bool):
    """The batch-1 train step (make_train_step, step.py:107):

        step(params, batch_stats, optimizer, sb, generator=None, att_keep=None)
            -> (params, batch_stats, loss, aux)

    params: the parameter tree with leaves that require grad
    (train/block.py::trainable); optimizer: train/optim.py::make_optimizer
    over param_leaves(params), which it updates in place.  aux: loss_ce,
    loss_f, per-step tp/fp/fn and step_valid.  The step's gradients stay on
    each leaf's .grad until the next step (for gradient-flow plots, ref
    train.py:140-145; the JAX package returns them with return_grads)."""
    mpnn.check_supported(cfg)

    def step(params, batch_stats, optimizer, sb: ScheduleBatch, generator=None,
             att_keep=None):
        optimizer.zero_grad(set_to_none=True)
        loss, aux = window_forward(params, batch_stats, cfg, sb, tp_classifier,
                                   generator=generator, att_keep=att_keep)
        loss.backward()
        out_aux = {k: aux[k] for k in ("loss_ce", "loss_f", "tp", "fp", "fn", "step_valid")}
        optimizer.step()
        return params, aux["batch_stats"], loss.detach(), out_aux

    return step


def make_eval_window(cfg: mpnn.ModelConfig, tp_classifier: bool):
    """run(params, batch_stats, sb) -> (loss, aux): the window in eval mode
    (BN from the running stats, no dropout), without autograd."""
    mpnn.check_supported(cfg)

    def run(params, batch_stats, sb: ScheduleBatch):
        with torch.no_grad():
            return window_forward(params, batch_stats, cfg, sb, tp_classifier, train=False)

    return run

