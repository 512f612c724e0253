"""Packed window batching in row layout (the counterpart of
trackmpnn_tpu/train/packed.py): the B windows of a batch concatenated into
one block-diagonal graph of B*cap slots, each window's edge endpoints
offset by k*cap, so that every GRU product is one [B*cap, H] x [H, 3H]
product and the gathers and scatters run over the longer row axis.

Loss semantics match the per-window path: CE is a per-window sum, so the
global sum / B is the mean of window sums; the BCE mean is taken per window
(_per_window_bce), then averaged.  BatchNorm statistics pool across the
packed batch (cross-window batch statistics).

packed_window_forward(fused_round=True) runs each message-passing round
through ops/round.py's fused round (msg 'diff', no attention heads) on the
[B, cap, H] view of the batch; input injection, BatchNorm and the output
heads stay plain tensor code.  As in the JAX package, make_packed_train_step
takes the unfused path (mpnn.forward, ops/mp.py's kernels).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from trackmpnn_tpu_torch.graph.view import GraphView
from trackmpnn_tpu_torch.losses.losses import EPS, f1_counts, targets_and_ce
from trackmpnn_tpu_torch.models import mpnn, nn
from trackmpnn_tpu_torch.ops import mp
from trackmpnn_tpu_torch.ops.round import fused_round, round_incidence
from trackmpnn_tpu_torch.train.step import tree_map


class PackedBatch(NamedTuple):
    """B windows packed into one [B*cap]-slot graph.  The slot arrays and
    per-step counts live on the device, as in the JAX package; the host
    keeps its own copy of step_valid, so the step loop never reads the card."""

    is_det: torch.Tensor      # bool[B*cap]
    past: torch.Tensor        # int32[B*cap] (globally offset)
    fut: torch.Tensor         # int32[B*cap]
    label: torch.Tensor       # int32[B*cap]
    feat: torch.Tensor        # f32[B*cap, F]
    window: torch.Tensor      # int32[B*cap] window id per slot
    n_before: torch.Tensor    # int32[t_cap, B]
    n_after: torch.Tensor     # int32[t_cap, B]
    step_valid: torch.Tensor  # bool[t_cap, B]
    valid_host: np.ndarray    # bool[t_cap, B], step_valid on the host
    inc_ptr: torch.Tensor     # int32[B*cap + 1] the fused round's incidence
    inc_idx: torch.Tensor     # int32[n]         (ops/round.py::round_incidence)
    # signed_segment_sum's incidence of past/fut for the unfused rounds
    # (ops/mp.py::segment_incidence), built once a batch on the card; None
    # on the CPU
    seg_inc: tuple

    @property
    def n_windows(self) -> int:
        return self.n_before.shape[1]

    @property
    def cap(self) -> int:
        return self.is_det.shape[0] // self.n_windows


def pack_schedules(schedules: List, cap: int, t_cap: int, device="cuda") -> PackedBatch:
    """Pack WindowSchedules (graph/schedule.py, each of `cap` slots and
    `t_cap` steps) in numpy, then move every array to `device` once.  The
    incidence lists every slot that is an edge at any step (the static
    edges of the final graph); each step's idxw flags its live prefix."""
    B = len(schedules)
    cat = lambda field, dtype: np.concatenate([np.asarray(getattr(w, field), dtype)
                                               for w in schedules])
    offset = lambda field: np.concatenate([np.asarray(getattr(w, field), np.int32) + k * cap
                                           for k, w in enumerate(schedules)])
    stack = lambda field, dtype: np.stack([np.asarray(getattr(w, field), dtype)
                                           for w in schedules], 1)
    static = np.zeros((B, cap, 4), np.int32)
    for k, w in enumerate(schedules):
        static[k, :, 0], static[k, :, 1] = w.past, w.fut
        static[k, : w.n_rows, 2] = ~np.asarray(w.is_det[: w.n_rows], bool)
    inc_ptr, inc_idx = round_incidence(static)
    valid = stack("step_valid", bool)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    past, fut = put(offset("past")), put(offset("fut"))
    return PackedBatch(
        is_det=put(cat("is_det", bool)), past=past, fut=fut, label=put(cat("label", np.int32)),
        feat=put(cat("feat", np.float32)),
        window=put(np.repeat(np.arange(B, dtype=np.int32), cap)),
        n_before=put(stack("n_before", np.int32)), n_after=put(stack("n_after", np.int32)),
        step_valid=put(valid), valid_host=valid, inc_ptr=put(inc_ptr), inc_idx=put(inc_idx),
        seg_inc=mp.kernel_incidence(past, fut, B * cap))


def _per_window_bce(probs, targets, mask, n_windows):
    """Per-window mean BCE (reference eps placement), then the sum of the
    means.  Windows are contiguous slot blocks: a reshape-sum."""
    pt = torch.where(targets == 1, probs, 1.0 - probs)
    lp = torch.log(pt + EPS)
    s = torch.where(mask, lp, 0.0).reshape(n_windows, -1).sum(1)
    c = mask.reshape(n_windows, -1).sum(1).to(probs.dtype)
    return -(s / torch.clamp(c, min=1.0)).sum()


def _window_idxw(pb: PackedBatch, past_l, fut_l, live):
    """The fused round's int32[B, cap, 4] (past, fut, is_live_edge,
    is_live_det), indices window-local (packed.py:103-110)."""
    edge_live = live & ~pb.is_det
    det_live = live & pb.is_det
    return torch.stack([past_l, fut_l, edge_live.to(torch.int32), det_live.to(torch.int32)],
                       1).reshape(pb.n_windows, pb.cap, 4)


def _forward_fused_round(params, batch_stats, cfg, pb: PackedBatch, idxw, live, new, h, train):
    """mpnn.forward's semantics with the round run by ops/round.py's fused
    round (packed.py:89-142): input injection, BatchNorm and the output
    heads stay tensor code."""
    cap, B = pb.cap, pb.n_windows
    n = cap * B
    H = cfg.nhidden
    new_det = new & pb.is_det
    has_new = new.any()
    outs, stats_out = [], []
    off = 0
    for bi, (_, width) in enumerate(cfg.branches):
        bp = params["branches"][bi]
        bs = batch_stats["branches"][bi]["bn"]
        x = pb.feat[:, off:off + width]
        off += width
        xt, bn_stats = nn.input_transform(bp["input"], bs, x, new, train=train)
        stats_out.append({"bn": {k: torch.where(has_new, bn_stats[k], bs[k]) for k in bs}})
        h_b = h[:, bi * H:(bi + 1) * H]
        h_b = torch.where(new_det[:, None], xt, torch.where(new[:, None], 0.0, h_b))
        h_b = torch.where(live[:, None], h_b, 0.0)
        out_b = fused_round(h_b.reshape(B, cap, H), idxw, bp["edge_gru"], bp["node_gru"],
                            inc=(pb.inc_ptr, pb.inc_idx))
        outs.append(out_b.reshape(n, H))

    h_out = torch.cat(outs, dim=-1)
    y_node = nn.linear(params["out_node"], h_out)[:, 0]
    y_edge = nn.linear(params["out_edge"], h_out)[:, 0]
    logits = torch.where(live, torch.where(pb.is_det, y_node, y_edge), 0.0)
    scores = torch.where(live, torch.sigmoid(logits), 0.0)
    return mpnn.ModelOutput(scores=scores, logits=logits, hidden=h_out), {"branches": stats_out}


def packed_window_forward(params, batch_stats, cfg: mpnn.ModelConfig, pb: PackedBatch,
                          tp_classifier: bool, train: bool = True, fused_round: bool = False,
                          generator: Optional[torch.Generator] = None):
    """(mean-per-window loss, aux) of the packed batch (packed.py:145-213).

    aux: loss_ce, loss_f (detached), tp, fp, fn summed over steps, the new
    BN running stats and the final hidden state (both detached).
    fused_round=True runs each round through the fused round (msg 'diff'
    without attention heads; it raises otherwise).  generator draws the
    attention dropout when training with heads.  A step where no window is
    valid would add nothing and change nothing, so it is skipped."""
    mpnn.check_supported(cfg)
    if fused_round and (cfg.msg_type != "diff" or cfg.nattheads > 0):
        raise ValueError("fused round supports msg 'diff' without GAT heads")
    if train and cfg.nattheads > 0 and generator is None:
        raise ValueError("training with GAT heads needs a generator for the "
                         "attention dropout (pass generator=...)")
    cap, B = pb.cap, pb.n_windows
    n = cap * B
    dev = pb.feat.device
    rows = torch.arange(n, device=dev, dtype=torch.int32)
    within = rows % cap
    if fused_round:
        past_l, fut_l = pb.past - (rows - within), pb.fut - (rows - within)
    h = torch.zeros(n, len(cfg.branches) * cfg.nhidden, device=dev)
    stats = batch_stats
    l_ce, l_f, tp, fp, fn = [], [], [], [], []
    for s in range(pb.valid_host.shape[0]):
        valid_w = pb.valid_host[s]
        if not valid_w.any():
            continue
        valid = pb.step_valid[s][pb.window]
        live = (within < pb.n_after[s][pb.window]) & valid
        new = (within >= pb.n_before[s][pb.window]) & live
        if fused_round:
            idxw = _window_idxw(pb, past_l, fut_l, live)
            out, stats = _forward_fused_round(params, stats, cfg, pb, idxw, live, new, h, train)
        else:
            g = GraphView(is_det=pb.is_det, past=pb.past, fut=pb.fut, live=live, new=new,
                          feat=pb.feat, inc=pb.seg_inc)
            out, stats = mpnn.forward(params, stats, cfg, g, h, train=train,
                                      generator=generator)
        targets, ce = targets_and_ce(out.logits, pb.label, pb.is_det, pb.past, pb.fut, live)
        edge_mask = live & ~pb.is_det
        f = _per_window_bce(out.scores, targets, edge_mask, B)
        if tp_classifier:
            f = _per_window_bce(out.scores, targets, live & pb.is_det, B) + f
        counts = f1_counts(out.scores, targets, pb.is_det, live, tp_classifier)
        # windows whose schedule already ended keep their hidden state
        h = out.hidden if valid_w.all() else torch.where(valid[:, None], out.hidden, h)
        for acc, v in zip((l_ce, l_f, tp, fp, fn), (ce, f) + tuple(counts)):
            acc.append(v)
    total = (torch.stack(l_ce).sum() + torch.stack(l_f).sum()) / B
    aux = {"loss_ce": (torch.stack(l_ce).sum() / B).detach(),
           "loss_f": (torch.stack(l_f).sum() / B).detach(),
           "tp": torch.stack(tp).sum(), "fp": torch.stack(fp).sum(), "fn": torch.stack(fn).sum(),
           "batch_stats": tree_map(torch.Tensor.detach, stats), "hidden": h.detach()}
    return total, aux


def make_packed_train_step(cfg: mpnn.ModelConfig, tp_classifier: bool):
    """The packed train step (make_packed_train_step, packed.py:216):

        step(params, batch_stats, optimizer, pb, generator=None)
            -> (params, batch_stats, loss, aux)

    with the unfused round, as the JAX package builds it.  params, optimizer
    and aux (loss_ce, loss_f, tp, fp, fn) as train/step.py::make_train_step."""
    mpnn.check_supported(cfg)

    def step(params, batch_stats, optimizer, pb: PackedBatch, generator=None):
        optimizer.zero_grad(set_to_none=True)
        loss, aux = packed_window_forward(params, batch_stats, cfg, pb, tp_classifier,
                                          generator=generator)
        loss.backward()
        optimizer.step()
        return params, aux["batch_stats"], loss.detach(), {
            k: aux[k] for k in ("loss_ce", "loss_f", "tp", "fp", "fn")}

    return step
