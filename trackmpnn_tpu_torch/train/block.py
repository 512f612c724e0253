"""Block-structured train step (the counterpart of trackmpnn_tpu/train/block.py).

Every step's new edges form a complete bipartite block active x new (ref
graph.py:281: rows laid out i*nt + j), so the window's graph is a union of
dense rectangles.  Edge hidden state lives in padded block layout
[blocks, na_cap, nt_cap, H], detection hidden state in a compact
per-window layout [B*capD, H]:

  * node_support over a rectangle factorises: the edge GRU's input gates
    are ga[act_i] + sign * gb[new_j] with ga = gb = h_dets @ w_ih computed
    once on the detection layout (ops.block.window_gather2);
  * the edge GRU, the masking and the row/column sums of the edge hidden
    run in one kernel per step (ops.block.fused_block_round);
  * edge_support (signed incident sums per detection) is one scatter of
    the row sums (+) and column sums (-) into the detection layout
    (ops.block.window_scatter), a pull over the batch's detection incidence
    (BlockBatch.det_inc_ptr / det_inc_slot), as is the gather's backward.

With attention heads (cfg.nattheads > 0) edge_support is instead the mean
over heads of attention-weighted signed sums (_block_gat_support): the
stacked-head score and aggregation kernels (ops.gat), a segment max and sum
for the per-detection softmax, and the same window scatter.  With
gat_fused=False the heads run one at a time instead
(_block_gat_support_per_head, the JAX package's per-head loop): the
single-head score and aggregation kernels, one launch of each a head.

Every feature branch (2d, temp, vis) runs its own input transform, edge
and node GRUs and attention heads on its own slice of the hidden state, as
in the JAX package's branch loop; each branch's edge rectangle stays a
tensor of its own, and the branches meet in the edge head (the sum of
their head partials) and in the node head.

By default this is the composition the JAX package runs on the TPU (fused
round, defer_loss, hoisted BN, window scatter/gather, the stacked attention
kernels), for any of the feature branches, msg 'diff' or 'concat' (sign +1
and the two halves of w_ih as the round's input gates), f32.  Two keyword
arguments select its two other block-step compositions (TM_ES_KERNEL=1 and
TM_FUSED_LOSS=1 there):

  * es_kernel: one kernel gathers the input gates and reduces edge_support
    itself (ops.block.fused_block_round_es), over the batch's detection
    incidence (BlockBatch.det_inc_ptr / det_inc_slot), in place of the
    gather, the round and the scatter; no attention heads;
  * fused_loss: every step computes its edge-side targets, CE, BCE and F1
    counts inside the loop through the fused loss kernels
    (ops.loss.edge_losses) over every branch's edge hidden side by side,
    the detection side in plain tensor ops.

Blocks are step-major (block q = s*B + w), so at step s the live blocks are
exactly the first (s+1)*B: each step runs on that prefix and never touches
a future block.  Without fused_loss the loss of every step runs after the
loop over steps, batched over a leading step axis.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from trackmpnn_tpu_torch.graph.schedule import round_up
from trackmpnn_tpu_torch.losses.losses import EPS
from trackmpnn_tpu_torch.models import mpnn, nn
from trackmpnn_tpu_torch.ops.block import (block_incidence, fused_block_round,
                                           fused_block_round_es, window_gather2, window_scatter)
from trackmpnn_tpu_torch.ops.gat import (gat_aggregate, gat_aggregate_1h, gat_scores_stats,
                                         gat_scores_stats_1h)
from trackmpnn_tpu_torch.ops.loss import edge_losses
from trackmpnn_tpu_torch.ops.segment import segment_max, segment_min, segment_sum

_BIG = float(1 << 30)  # larger than any slot row id (exact in f32)
_NEG = -1e30


class BlockBatch(NamedTuple):
    """B windows in dual layout: compact detections + padded edge rectangles.

    Detection slots of window w occupy [w*capD, (w+1)*capD); block b of
    window w is flat block id w*t_cap + b (one block per schedule step; a
    step that appended nothing is an empty block with nt = 0)."""

    det_feat: torch.Tensor    # f32[B*capD, F]
    det_label: torch.Tensor   # i32[B*capD]
    det_step: torch.Tensor    # i32[B*capD]  introduction step (t_cap = padding)
    active_idx: torch.Tensor  # i32[B*T, na_cap] global compact det id per row i
    newdet_idx: torch.Tensor  # i32[B*T, nt_cap] global compact det id per col j
    blk_na: torch.Tensor      # i32[B*T]
    blk_nt: torch.Tensor      # i32[B*T]
    blk_edge_base: torch.Tensor  # i32[B*T] original slot row of edge (0, 0)
    edge_label: torch.Tensor  # i32[B*T, na_cap, nt_cap]
    step_valid: torch.Tensor  # bool[t_cap, B]
    # the detection incidence of the step-major blocks (ops/block.py::
    # block_incidence), for the es round and the window ops:
    # i32[B*capD + 1], i32[n]
    det_inc_ptr: torch.Tensor
    det_inc_slot: torch.Tensor

    @property
    def t_cap(self) -> int:
        return self.step_valid.shape[0]

    @property
    def n_windows(self) -> int:
        return self.step_valid.shape[1]

    @property
    def capD(self) -> int:
        return self.det_feat.shape[0] // self.n_windows

    @property
    def na_cap(self) -> int:
        return self.active_idx.shape[1]

    @property
    def nt_cap(self) -> int:
        return self.newdet_idx.shape[1]


def block_dims(schedules: List) -> tuple:
    """(capD, na_cap, nt_cap) buckets for a batch of WindowSchedules."""
    capD = na = nt = 1
    for ws in schedules:
        capD = max(capD, int(np.sum(ws.is_det[: ws.n_rows])))
        for blk in ws.blocks:
            if blk is not None:
                na, nt = max(na, blk.na), max(nt, blk.nt)
    return round_up(capD, 64), round_up(na, 8), round_up(nt, 8)


def build_block_batch(schedules: List, t_cap: int, capD=None, na_cap=None,
                      nt_cap=None, device="cuda") -> BlockBatch:
    """Pack WindowSchedules (graph/schedule.py) into block-table form in
    numpy, then move every array to `device` once."""
    d_capD, d_na, d_nt = block_dims(schedules)
    capD = capD or d_capD
    na_cap = na_cap or d_na
    nt_cap = nt_cap or d_nt
    B = len(schedules)
    F = schedules[0].feat.shape[1]

    det_feat = np.zeros((B * capD, F), np.float32)
    det_label = np.zeros(B * capD, np.int32)
    det_step = np.full(B * capD, t_cap, np.int32)
    active_idx = np.zeros((B * t_cap, na_cap), np.int32)
    newdet_idx = np.zeros((B * t_cap, nt_cap), np.int32)
    blk_na = np.zeros(B * t_cap, np.int32)
    blk_nt = np.zeros(B * t_cap, np.int32)
    blk_edge_base = np.zeros(B * t_cap, np.int32)
    edge_label = np.zeros((B * t_cap, na_cap, nt_cap), np.int32)
    step_valid = np.zeros((t_cap, B), bool)

    for w, ws in enumerate(schedules):
        n = ws.n_rows
        is_det = np.asarray(ws.is_det[:n])
        dr = np.where(is_det)[0]
        ndet = len(dr)
        if ndet > capD:
            raise ValueError(f"capD {capD} < detections {ndet}")
        dc = np.full(n, -1, np.int64)  # slot row -> compact det id
        dc[dr] = np.arange(ndet)
        dof = w * capD
        det_feat[dof : dof + ndet] = np.asarray(ws.feat)[dr]
        det_label[dof : dof + ndet] = np.asarray(ws.label)[dr]
        for s in range(ws.n_steps):
            step_valid[s, w] = True
            b, a = int(ws.n_before[s]), int(ws.n_after[s])
            new_dets = dc[np.arange(b, a)[is_det[b:a]]]
            det_step[dof + new_dets] = s
            blk = ws.blocks[s]
            bid = w * t_cap + s
            if blk is None:
                if a > b:
                    raise ValueError(f"step {s} added rows but has no block")
                continue
            if blk.na > na_cap or blk.nt > nt_cap:
                raise ValueError("block exceeds (na_cap, nt_cap)")
            blk_na[bid], blk_nt[bid] = blk.na, blk.nt
            blk_edge_base[bid] = blk.edge_base
            active_idx[bid, : blk.na] = dof + dc[blk.active_rows]
            newdet_idx[bid, : blk.nt] = dof + dc[blk.det_base] + np.arange(blk.nt)
            lbl = np.asarray(ws.label)[
                blk.edge_base : blk.edge_base + blk.na * blk.nt
            ].reshape(blk.na, blk.nt)
            edge_label[bid, : blk.na, : blk.nt] = lbl

    perm = np.arange(B * t_cap).reshape(B, t_cap).T.reshape(-1)  # step-major order
    inc_ptr, inc_slot = block_incidence(active_idx[perm], newdet_idx[perm], blk_na[perm],
                                        blk_nt[perm], B * capD)
    put = lambda a: torch.from_numpy(a).to(device)
    return BlockBatch(
        det_feat=put(det_feat), det_label=put(det_label), det_step=put(det_step),
        active_idx=put(active_idx), newdet_idx=put(newdet_idx),
        blk_na=put(blk_na), blk_nt=put(blk_nt), blk_edge_base=put(blk_edge_base),
        edge_label=put(edge_label), step_valid=put(step_valid),
        det_inc_ptr=put(inc_ptr), det_inc_slot=put(inc_slot),
    )


# ------------------------------------------------------------ device step ----
def _hoisted_bn_all_steps(bp_in, bs, y1, ids_c, det_isnew, nph_T, T, train):
    """Per-intro-step BatchNorm for ALL steps at once (block.py:198).

    Each step's BN pools the detections introduced at that step plus
    n_phantom copies of lin1's bias (what the zero-feature new edge rows
    contribute in the row layout, ref track_mpnn.py:58-61), so the whole
    thing is a pair of segment reductions keyed on the intro step.  The
    sequential running-stat EMA folds in closed form:
        final = (1-m)^K old + m * sum_s q_s (1-m)^{r_s} stat_s
    (q_s = step had rows, r_s = # such steps after s).

    Returns (y_normed [nD, H], each detection by its own intro step's
    statistics, finite but meaningless on padding rows; the final running
    stats, detached)."""
    b1 = bp_in["lin1"]["b"]
    if train:
        ones = y1.new_ones(y1.shape[0], 1)
        cnt_raw = segment_sum(ones, ids_c, T, mask=det_isnew)[:, 0] + nph_T   # [T]
        cnt = torch.clamp(cnt_raw, min=1.0)[:, None]
        sum_T = segment_sum(y1, ids_c, T, mask=det_isnew)                    # [T, H]
        mean_T = (sum_T + nph_T[:, None] * b1) / cnt
        d2 = (y1 - mean_T[ids_c]) ** 2
        var_T = (segment_sum(d2, ids_c, T, mask=det_isnew)
                 + nph_T[:, None] * (b1 - mean_T) ** 2) / cnt
        y = (y1 - mean_T[ids_c]) * torch.rsqrt(var_T[ids_c] + nn.BN_EPS)
        with torch.no_grad():
            var_u = var_T * cnt / torch.clamp(cnt - 1.0, min=1.0)
            m = nn.BN_MOMENTUM
            q = (cnt_raw > 0).to(y1.dtype)
            r = torch.flip(torch.cumsum(torch.flip(q, [0]), 0), [0]) - q  # suffix count
            w = (m * q * (1 - m) ** r)[:, None]
            decay = (1 - m) ** q.sum()
            new_stats = {"mean": decay * bs["mean"] + (w * mean_T).sum(0),
                         "var": decay * bs["var"] + (w * var_u).sum(0)}
    else:
        y = (y1 - bs["mean"]) * torch.rsqrt(bs["var"] + nn.BN_EPS)
        new_stats = bs
    bn = bp_in["bn"]
    return y * bn["gamma"] + bn["beta"], new_stats


class StaticTargets(NamedTuple):
    """Per-batch target structure, the same at every step (block.py:245).

    Every pick of the target derivation (ref loss.py:8-44) is label- and
    layout-determined, not logits-determined, and does not change as the
    live set grows; masking by each step's live cells restores the per-step
    semantics."""

    tpos: torch.Tensor      # bool[BT, na, nt] target-positive edges
    part_b: torch.Tensor    # bool[BT, na, nt] earliest-positive per det
    col_has: torch.Tensor   # bool[BT, nt]     column has a positive target
    sel_mask: torch.Tensor  # bool[BT, na, nt] latest positive per column


def build_static_targets(bb: BlockBatch, row_m, col_m) -> StaticTargets:
    nD = bb.det_feat.shape[0]
    dev = bb.det_feat.device
    ii = torch.arange(bb.na_cap, device=dev)[None, :, None]
    jj = torch.arange(bb.nt_cap, device=dev)[None, None, :]
    # original slot row of edge (i, j), the reference's tie-break key, in f32
    # (slot rows << 2^24, so exact)
    rowid = (bb.blk_edge_base[:, None, None].long() + ii * bb.blk_nt[:, None, None].long()
             + jj).float()
    msk = row_m[:, :, None] & col_m[:, None, :]
    lbl_pos = (bb.edge_label == 1) & msk
    # past part: latest (max i) positive-label edge in each column
    max_i = torch.where(lbl_pos, ii, -1).amax(1)                        # [BT, nt]
    part_a = lbl_pos & (ii == max_i[:, None, :])
    # future part: earliest (min rowid) positive-label edge out of each det
    r_min = torch.where(lbl_pos, rowid, _BIG).amin(2)                   # [BT, na]
    act_m = (row_m & (bb.blk_nt > 0)[:, None]).reshape(-1)
    sel1 = segment_min(r_min.reshape(-1), bb.active_idx.reshape(-1), nD, mask=act_m)
    part_b = lbl_pos & (rowid == sel1[bb.active_idx.long()][:, :, None])
    tpos = part_a | part_b
    col_has = tpos.any(1)
    sel_i = torch.where(tpos, ii, -1).amax(1)  # latest positive
    sel_mask = tpos & (ii == sel_i[:, None, :])
    return StaticTargets(tpos=tpos, part_b=part_b, col_has=col_has, sel_mask=sel_mask)


def _block_targets_and_ce(logits_d, logits_e, det_label, active_idx, blk_na, blk_nt, st,
                          det_live, blk_live, row_m, em3):
    """Targets + per-detection CE in block layout for every step at once
    (block.py:312, batched over a leading step axis S).

    logits_d [S, nD]; logits_e, em3 [S, BT, na, nt]; det_live [S, nD];
    blk_live [S, BT]; the rest is per batch.  A detection's past incident
    set is one block column, so the "latest positive" pick and the CE past
    term are dense column reductions; its future set spans the active lists
    of later blocks: per-(block, active-row) partials + one segment
    reduction over the active ids (offset by step, so steps stay apart).
    Returns (targets_d, targets_e, ce summed over steps)."""
    S, nD = logits_d.shape
    dev = logits_d.device
    tpos = st.tpos & em3
    targets_e = tpos.to(torch.int32)
    targets_d = ((det_label == 1) & det_live).to(torch.int32)
    step_off = (torch.arange(S, device=dev) * nD)[:, None]
    act_flat = (active_idx.reshape(1, -1).long() + step_off).reshape(-1)
    act_m = (blk_live[:, :, None] & row_m).reshape(-1)

    # ---- CE past side: dense per column ----
    col_has = st.col_has & blk_live[:, :, None]                             # [S, BT, nt]
    m_col = torch.where(em3, logits_e, _NEG).amax(2)
    # shift every nonempty column: an unshifted live column can overflow
    # exp, and the masked-out forward still NaNs the backward through 0 * inf
    safe_m = torch.where(m_col > _NEG / 2, m_col, 0.0)
    sumexp = torch.where(em3, torch.exp(logits_e - safe_m[:, :, None, :]), 0.0).sum(2)
    lse_col = safe_m + torch.log(torch.clamp(sumexp, min=1e-30))
    sel_logit = torch.where(st.sel_mask, logits_e, 0.0).sum(2)
    size_col = torch.clamp(blk_na[None, :, None].float(), min=1.0)
    ce_past = torch.where(col_has, (lse_col - sel_logit) / size_col, 0.0).sum()

    # ---- CE future side: per-(block, active-row) partials + segment ops ----
    # the shift is per detection: one global max lets exp() underflow to 0
    # for detections whose logits sit far below it
    m_r = torch.where(em3, logits_e, _NEG).amax(3)                          # [S, BT, na]
    m_d = segment_max(m_r.reshape(-1), act_flat, S * nD, mask=act_m).detach()
    safe_d = torch.where(m_d > _NEG / 2, m_d, 0.0)
    shift = safe_d[act_flat].reshape(m_r.shape)[..., None]
    sexp_row = torch.where(em3, torch.exp(logits_e - shift), 0.0).sum(3)
    cnt_row = torch.where(blk_live[:, :, None] & row_m, blk_nt[None, :, None].float(), 0.0)
    packed = torch.stack([sexp_row, cnt_row], dim=-1).reshape(-1, 2)
    sums = segment_sum(packed, act_flat, S * nD, mask=act_m)
    lse_d = safe_d + torch.log(torch.clamp(sums[:, 0], min=1e-30))
    size_d = torch.clamp(sums[:, 1], min=1.0)
    # the earliest positive-TARGET edge out of a detection is its earliest
    # positive-LABEL edge (part_b)
    part_b = st.part_b & em3
    lse_rb = lse_d[act_flat].reshape(m_r.shape)[..., None]
    size_rb = size_d[act_flat].reshape(m_r.shape)[..., None]
    ce_fut = torch.where(part_b, (lse_rb - logits_e) / size_rb, 0.0).sum()
    return targets_d, targets_e, ce_past + ce_fut


def _per_window_bce_dual(scores_d, t_d, mask_d, scores_e, t_e, mask_e, B):
    """Sum over steps and windows of each window's masked-mean BCE across
    both layouts (block.py:516).  Detection arrays [S, B*capD] are
    window-major; edge arrays [S, P, na, nt] step-major (block q belongs to
    window q mod B)."""
    S = scores_d.shape[0]
    pt_d = torch.where(t_d == 1, scores_d, 1.0 - scores_d)
    pt_e = torch.where(t_e == 1, scores_e, 1.0 - scores_e)
    le = torch.where(mask_e, torch.log(pt_e + EPS), 0.0).reshape(S, -1, B, mask_e[0, 0].numel())
    s = (torch.where(mask_d, torch.log(pt_d + EPS), 0.0).reshape(S, B, -1).sum(2)
         + le.sum((1, 3)))
    c = (mask_d.reshape(S, B, -1).sum(2)
         + mask_e.reshape(S, -1, B, le.shape[3]).sum((1, 3))).to(scores_d.dtype)
    return -(s / torch.clamp(c, min=1.0)).sum()


def _step_losses(logits_d, logits_e, bb, st, act, bna, bnt, row_m,
                 det_live, blk_live, em3, tp_classifier, B):
    """Targets + CE + BCE + F1 counts from masked logits, all steps at once."""
    t_d, t_e, l_ce = _block_targets_and_ce(logits_d, logits_e, bb.det_label, act, bna, bnt,
                                           st, det_live, blk_live, row_m, em3)
    scores_d = torch.where(det_live, torch.sigmoid(logits_d), 0.0)
    scores_e = torch.where(em3, torch.sigmoid(logits_e), 0.0)
    no_mask_d = torch.zeros_like(det_live)
    if tp_classifier:
        l_f = (_per_window_bce_dual(scores_d, t_d, det_live, scores_e, t_e,
                                    torch.zeros_like(em3), B)
               + _per_window_bce_dual(scores_d, t_d, no_mask_d, scores_e, t_e, em3, B))
        md = det_live
    else:
        l_f = _per_window_bce_dual(scores_d, t_d, no_mask_d, scores_e, t_e, em3, B)
        md = no_mask_d
    pred_d, pred_e = scores_d >= 0.5, scores_e >= 0.5
    tp = (md & pred_d & (t_d == 1)).sum() + (em3 & pred_e & (t_e == 1)).sum()
    fp = (md & pred_d & (t_d != 1)).sum() + (em3 & pred_e & (t_e != 1)).sum()
    fn = (md & ~pred_d & (t_d == 1)).sum() + (em3 & ~pred_e & (t_e == 1)).sum()
    return l_ce, l_f, tp, fp, fn


def _heads_last(x):
    """[nh, P, n] -> [P*n, nh]: rows aligned with the segment ids, heads as
    features."""
    return x.permute(1, 2, 0).reshape(-1, x.shape[0])


def _heads_first(x_d, idx):
    """Rows idx [P, n] of a [nD, nh] detection array, as [nh, P, n]."""
    return x_d[idx].permute(2, 0, 1).contiguous()


def draw_att_keep(generator, nh, shape, device):
    """The two [nh, P, na, nt] f32 0/1 keep masks (rows, columns) of one
    round's attention dropout, kept with probability 1 - ATT_DROPOUT, as the
    JAX package's stacked path draws them (block.py:448-453).  The stream
    differs from JAX's; the distribution is the same."""
    keep = 1.0 - mpnn.ATT_DROPOUT
    return tuple((torch.rand((nh,) + tuple(shape), generator=generator, device=device)
                  < keep).to(torch.float32) for _ in range(2))


def _block_gat_support(gat_params, h_d_b, h_e, act, new, act_l, new_l, m3, row_live,
                       col_live, B, capD, att_keep=None, inc=None):
    """edge_support with attention heads, all heads at once (the stacked
    path of _block_gat_support, block.py:402-468; ref layers.py:7-46).

    A detection's incident edges are the rows of blocks where it is active
    (sign +1) and its introduction block's column (sign -1), so the softmax
    over them is two rectangle reductions per block plus a segment max and
    a segment sum over the active/new ids.  h_d_b [nD, H] the detections'
    hiddens; h_e [P, na, nt, H] the raw edge rectangle (attention is 0 at
    padded cells); act / new [P, na] / [P, nt] global and act_l / new_l
    window-local detection ids; m3 [P, na, nt] f32 live cells; row_live /
    col_live [P, na] / [P, nt] the live rows and columns.  att_keep: the two
    keep masks of train-time dropout (draw_att_keep), or None for none.
    inc: the batch's detection incidence, for the window ops.  Returns es
    [nD, H], the mean over heads."""
    nD = h_d_b.shape[0]
    nh = len(gat_params)
    seg = torch.cat([act.reshape(-1), new.reshape(-1)])
    vm = torch.cat([row_live.reshape(-1), col_live.reshape(-1)])
    w_att = torch.cat([hp["W_att"] for hp in gat_params], dim=1)
    a_att = torch.cat([hp["a"] for hp in gat_params], dim=0)
    h_att = h_d_b @ w_att                                                 # [nD, nh*H]
    # h_att[act], h_att[new], with the window scatter kernel as backward
    ha, hn = window_gather2(h_att, h_att, act_l, new_l, B, capD, inc)
    e, rmax, cmax, sal, sbl = gat_scores_stats(ha, hn, a_att, m3, mpnn.LEAKY_ALPHA, nh)
    # the softmax shift: per-head segment max over [rows | columns] (no
    # gradient, rmax and cmax carry none)
    m_d = segment_max(torch.cat([_heads_last(rmax), _heads_last(cmax)]), seg, nD, mask=vm)
    safe_m = torch.where(m_d > _NEG / 2, m_d, 0.0)                       # [nD, nh]
    m_row, m_col = _heads_first(safe_m, act), _heads_first(safe_m, new)
    # exp(-1e30 - m) is exactly 0 for an all-masked row
    sa = torch.exp(rmax - m_row) * sal
    sb = torch.exp(cmax - m_col) * sbl
    z = segment_sum(torch.cat([_heads_last(sa), _heads_last(sb)]), seg, nD, mask=vm)
    if att_keep is None:
        keep, ka, kn = 1.0, m3[None], m3[None]  # ignored at keep 1
    else:
        keep, (ka, kn) = 1.0 - mpnn.ATT_DROPOUT, att_keep
    rs, cs = gat_aggregate(e, m_row, m_col, _heads_first(z, act), _heads_first(z, new), h_e,
                           m3, ka, kn, keep)
    # attention is 0 at every padded cell, so rs / cs are 0 at padded rows
    # and columns and the unmasked window scatter is exact
    return window_scatter(torch.cat([rs, -cs], dim=1), torch.cat([act_l, new_l], dim=1),
                          B, capD, inc) / nh


def _block_gat_support_per_head(gat_params, h_d_b, h_e, act, new, act_l, new_l, m3, row_live,
                                col_live, B, capD, att_keep=None, inc=None):
    """_block_gat_support one head at a time (the per-head loop of
    _block_gat_support, block.py:469-513; the JAX package's route with
    gat_fused=False): per head the detection projection, its window gather,
    the single-head scores and statistics (ops.gat.gat_scores_stats_1h),
    the segment max and sum of the softmax, the single-head aggregate
    (ops.gat.gat_aggregate_1h) and the window scatter of its signed sums,
    then the mean over heads.  Arguments as _block_gat_support's; head h
    reads att_keep's masks at index h.  The softmax shift carries no
    gradient (the scores op stops it)."""
    nD = h_d_b.shape[0]
    seg = torch.cat([act.reshape(-1), new.reshape(-1)])
    vm = torch.cat([row_live.reshape(-1), col_live.reshape(-1)])
    es_idx = torch.cat([act_l, new_l], dim=1)
    keep = 1.0 if att_keep is None else 1.0 - mpnn.ATT_DROPOUT
    acc = None
    for h, hp in enumerate(gat_params):
        h_att = h_d_b @ hp["W_att"]                                       # [nD, H]
        ha, hn = window_gather2(h_att, h_att, act_l, new_l, B, capD, inc)
        e, rmax, cmax, sal, sbl = gat_scores_stats_1h(ha, hn, hp["a"], m3, mpnn.LEAKY_ALPHA)
        m_d = segment_max(torch.cat([rmax.reshape(-1), cmax.reshape(-1)]), seg, nD, mask=vm)
        safe_m = torch.where(m_d > _NEG / 2, m_d, 0.0)                    # [nD]
        m_row, m_col = safe_m[act], safe_m[new]
        sa = torch.exp(rmax - m_row) * sal
        sb = torch.exp(cmax - m_col) * sbl
        z = segment_sum(torch.cat([sa.reshape(-1), sb.reshape(-1)]), seg, nD, mask=vm)
        ka, kn = (m3, m3) if att_keep is None else (att_keep[0][h], att_keep[1][h])
        rs, cs = gat_aggregate_1h(e, m_row, m_col, z[act], z[new], h_e, m3, ka, kn, keep)
        es = window_scatter(torch.cat([rs, -cs], dim=1), es_idx, B, capD, inc)
        acc = es if acc is None else acc + es
    return acc / len(gat_params)


def _branch_keeps(keep_s, nb):
    """One round's keep masks as one (rows, columns) pair per branch; a bare
    pair is the one branch's."""
    if keep_s is None:
        return [None] * nb
    if torch.is_tensor(keep_s[0]):
        keep_s = [keep_s]
    if len(keep_s) != nb:
        raise ValueError(f"att_keep holds keep masks for {len(keep_s)} branches a round, the "
                         f"model has {nb}")
    return list(keep_s)


def _fused_step_losses(partials, logits_d, det_label, det_live, B, tp_classifier):
    """One step's (CE, BCE, tp, fp, fn) from the fused edge-loss partials
    [P, 8] and the masked detection logits (block.py:983-1009): the edge
    side's per-window BCE means from the partials (block q belongs to window
    q mod B), the detection side in plain tensor ops."""
    l_ce = (partials[:, 0] + partials[:, 1]).sum()
    e_sum = partials[:, 2].reshape(-1, B).sum(0)
    e_cnt = partials[:, 3].reshape(-1, B).sum(0)
    l_f = -(e_sum / torch.clamp(e_cnt, min=1.0)).sum()
    tp, fp, fn = (partials[:, k].sum().to(torch.int64) for k in (4, 5, 6))
    if tp_classifier:
        t_d = (det_label == 1) & det_live
        scores_d = torch.where(det_live, torch.sigmoid(logits_d), 0.0)
        pt_d = torch.where(t_d, scores_d, 1.0 - scores_d)
        lp_d = torch.where(det_live, torch.log(pt_d + EPS), 0.0)
        s_dw = lp_d.reshape(B, -1).sum(1)
        c_dw = det_live.reshape(B, -1).sum(1).to(lp_d.dtype)
        l_f = l_f - (s_dw / torch.clamp(c_dw, min=1.0)).sum()
        pred_d = scores_d >= 0.5
        tp = tp + (det_live & pred_d & t_d).sum()
        fp = fp + (det_live & pred_d & ~t_d).sum()
        fn = fn + (det_live & ~pred_d & t_d).sum()
    return l_ce, l_f, tp, fp, fn


def _check_composition(cfg, es_kernel):
    mpnn.check_supported(cfg)
    if es_kernel and cfg.nattheads > 0:
        raise ValueError("es_kernel computes edge_support without attention: it takes no "
                         "attention heads (nattheads > 0)")


def block_window_forward(params, batch_stats, cfg: mpnn.ModelConfig, bb: BlockBatch,
                         tp_classifier: bool, train: bool = True,
                         generator: Optional[torch.Generator] = None,
                         att_keep: Optional[Sequence] = None, es_kernel: bool = False,
                         fused_loss: bool = False, gat_fused: bool = True):
    """(loss, aux) of a batch of windows (block_window_forward, block.py:533,
    as the TPU runs it: fused round, defer_loss, hoisted BN, window
    scatter/gather, stacked attention kernels, f32).  loss = (CE + BCE) / B;
    aux holds loss_ce, loss_f, tp, fp, fn (detached) and the new BN running
    stats of every branch (`batch_stats`).  Any feature branches, msg
    'diff' or 'concat'.

    With attention heads, training applies dropout to the attention weights:
    att_keep[s] is round s's keep masks, one (rows, columns) pair per
    feature branch in branch order, each mask [nh, P, na_cap, nt_cap]
    (draw_att_keep's shapes, P = (s+1)*B); for a one-branch model a bare
    pair also does.  Else `generator` draws them, one pair a branch and
    round; one of the two is required.  With ATT_DROPOUT 0 or train=False
    there is none.  gat_fused=False runs the heads one at a time through
    the single-head kernels (_block_gat_support_per_head, the JAX package's
    gat_fused=False) on the same masks, head h at index h; without heads it
    changes nothing.

    es_kernel: each round is one fused_block_round_es a branch (the JAX
    package's TM_ES_KERNEL=1), which gathers the input gates and reduces
    edge_support itself; refused with attention heads, whose edge_support
    the kernel does not compute (the JAX package drops the kernel there
    silently).
    fused_loss: each round computes its losses in the loop, the edge side
    through edge_losses over every branch's edge hidden side by side
    (TM_FUSED_LOSS=1 with defer_loss=False there); the round kernels' head
    partials go unused.  BN stays hoisted out of the loop: the JAX package's
    in-loop BN of that composition gives the same numbers up to rounding."""
    _check_composition(cfg, es_kernel)
    if train and cfg.nattheads > 0 and generator is None and att_keep is None:
        raise ValueError("training with attention heads needs a generator for the "
                         "attention dropout (pass generator=...)")
    dropout = train and cfg.nattheads > 0 and mpnn.ATT_DROPOUT > 0.0
    gat_support = _block_gat_support if gat_fused else _block_gat_support_per_head
    dev = bb.det_feat.device
    B, T = bb.n_windows, bb.t_cap
    capD, na_cap, nt_cap = bb.capD, bb.na_cap, bb.nt_cap
    nD, BT = B * capD, B * T
    H = cfg.nhidden
    nb = len(cfg.branches)
    det_window = torch.arange(nD, device=dev) // capD

    row_m_w = torch.arange(na_cap, device=dev)[None, :] < bb.blk_na[:, None]
    col_m_w = torch.arange(nt_cap, device=dev)[None, :] < bb.blk_nt[:, None]

    # step-major reorder: block q = s*B + w; the blocks live at step s are
    # the first (s+1)*B
    perm = torch.arange(BT, device=dev).reshape(B, T).t().reshape(-1)
    act = bb.active_idx[perm]
    new = bb.newdet_idx[perm]
    bna, bnt = bb.blk_na[perm], bb.blk_nt[perm]
    row_m, col_m = row_m_w[perm], col_m_w[perm]
    blk_window = torch.arange(BT, device=dev) % B
    blk_step = torch.arange(BT, device=dev) // B
    act_l = (act % capD).to(torch.int32)     # window-local ids for the kernels
    new_l = (new % capD).to(torch.int32)
    es_idx = torch.cat([act_l, new_l], dim=1)
    inc = (bb.det_inc_ptr, bb.det_inc_slot)
    if fused_loss:
        # per-batch inputs of the fused edge losses (block.py:652-657)
        lbl_pos = (bb.edge_label == 1).to(torch.float32)[perm]
        ebnt = torch.stack([bb.blk_edge_base.float(), bb.blk_nt.float()], 1)[perm]
        bna_f = bna.float()[:, None]

    # lin1, BN and lin2 are step-independent: hoisted out of the step loop,
    # each branch on its own feature columns and with its own running stats
    ids_c = torch.clamp(bb.det_step.long(), max=T - 1)
    det_isnew = (bb.det_step < T) & bb.step_valid[ids_c, det_window]
    blk_isnew = bb.step_valid[blk_step, blk_window]
    nph_T = segment_sum((bna * bnt).float(), blk_step, T, mask=blk_isnew)
    xts, new_stats, off = [], [], 0
    for bi, (_, width) in enumerate(cfg.branches):
        bp_in = params["branches"][bi]["input"]
        y1 = nn.linear(bp_in["lin1"], bb.det_feat[:, off:off + width])
        off += width
        yb, stats_b = _hoisted_bn_all_steps(bp_in, batch_stats["branches"][bi]["bn"], y1, ids_c,
                                            det_isnew, nph_T, T, train)
        xts.append(nn.linear(bp_in["lin2"], torch.relu(yb)))
        new_stats.append({"bn": stats_b})
    # each branch's rows of the edge head, for its round kernel's partial
    w_ebs = [params["out_edge"]["w"][bi * H:(bi + 1) * H] for bi in range(nb)]

    # per step: its validity, live detections and live cells
    valid = bb.step_valid                                                # [T, B]
    steps = torch.arange(T, device=dev)
    det_valid = valid[:, det_window]                                     # [T, nD]
    det_live = (bb.det_step[None, :] <= steps[:, None]) & det_valid
    det_new = (bb.det_step[None, :] == steps[:, None]) & det_valid
    blk_valid = valid[:, blk_window]                                     # [T, BT]
    blk_live = (blk_step[None, :] <= steps[:, None]) & blk_valid & (bnt > 0)[None, :]
    cell_m = row_m[:, :, None] & col_m[:, None, :]                       # [BT, na, nt]
    em3 = blk_live[:, :, None, None] & cell_m[None]                      # [T, BT, na, nt]
    m3 = em3.float()
    if fused_loss:
        any_valid = valid.any(1)                                         # [T]
        zero = xts[0].new_zeros(())
        l_ce = l_f = zero
        tp = fp = fn = torch.zeros((), dtype=torch.int64, device=dev)

    # each branch's hidden state: detections [nD, H], edges [P, na, nt, H]
    h_d = [xt.new_zeros(nD, H) for xt in xts]
    h_e = [xt.new_zeros(0, na_cap, nt_cap, H) for xt in xts]
    hd_steps, lg_steps = [], []
    for s in range(T):
        P = (s + 1) * B
        keeps = [None] * nb
        if cfg.nattheads > 0 and dropout:
            keeps = (_branch_keeps(att_keep[s], nb) if att_keep is not None else
                     [draw_att_keep(generator, cfg.nattheads, (P, na_cap, nt_cap), dev)
                      for _ in range(nb)])
        hd_parts, eo_parts, lg = [], [], None
        for bi in range(nb):
            bp = params["branches"][bi]
            eg = bp["edge_gru"]
            # new blocks enter with zero hidden state
            h_e[bi] = torch.cat([h_e[bi], h_e[bi].new_zeros(B, na_cap, nt_cap, H)])
            h_d_b = torch.where(det_new[s][:, None], xts[bi],
                                torch.where(det_live[s][:, None], h_d[bi], 0.0))
            # edge GRU input gates factorise over the rectangle (block.py:854-860):
            # gi[i, j] = ga_d[act_i] + sign * gb_d[new_j] + b_ih, with msg 'diff'
            # ga_d = gb_d = h_d w_ih and sign -1, with 'concat' the two halves
            # of w_ih and sign +1
            if cfg.msg_type == "concat":
                ga_d, gb_d, sign = h_d_b @ eg["w_ih"][:H], h_d_b @ eg["w_ih"][H:], 1.0
            else:
                ga_d = gb_d = h_d_b @ eg["w_ih"]
                sign = -1.0
            if es_kernel:
                edge_out, lg_b, es = fused_block_round_es(
                    h_e[bi], act_l[:P], new_l[:P], ga_d, gb_d, eg["b_ih"], eg["w_hh"],
                    eg["b_hh"], w_ebs[bi], m3[s, :P], sign, B, capD, inc)
            else:
                ga_g, gb = window_gather2(ga_d, gb_d, act_l[:P], new_l[:P], B, capD, inc)
                edge_out, rs, cs, lg_b = fused_block_round(h_e[bi], ga_g + eg["b_ih"], gb,
                                                           eg["w_hh"], eg["b_hh"], w_ebs[bi],
                                                           m3[s, :P], sign)
                if cfg.nattheads > 0:
                    # the round's rs / cs go unused: attention weighs the edges
                    es = gat_support(bp["gat"], h_d_b, h_e[bi], act[:P], new[:P], act_l[:P],
                                     new_l[:P], m3[s, :P], blk_live[s, :P, None] & row_m[:P],
                                     blk_live[s, :P, None] & col_m[:P], B, capD, keeps[bi],
                                     inc)
                else:
                    es = window_scatter(torch.cat([rs, -cs], dim=1), es_idx[:P], B, capD, inc)
            node_out = nn.gru_cell(bp["node_gru"], es, h_d_b)
            hd_parts.append(torch.where(det_live[s][:, None], node_out, 0.0))
            eo_parts.append(edge_out)
            lg = lg_b if lg is None else lg + lg_b
        h_d_out = hd_parts[0] if nb == 1 else torch.cat(hd_parts, dim=-1)
        if fused_loss:
            # this step's losses in the loop (block.py:980-1031), the edge
            # side over every branch's edge hidden with the whole edge head
            h_eo = eo_parts[0] if nb == 1 else torch.cat(eo_parts, dim=-1)
            logits_d = torch.where(det_live[s],
                                   nn.linear(params["out_node"], h_d_out)[:, 0], 0.0)
            act_m = (blk_live[s, :P, None] & row_m[:P]).reshape(-1)
            partials = edge_losses(h_eo, params["out_edge"]["w"],
                                   params["out_edge"]["b"].reshape(1, 1), lbl_pos[:P],
                                   m3[s, :P], ebnt[:P], bna_f[:P], act[:P], act_m, nD)
            ce_s, f_s, tp_s, fp_s, fn_s = _fused_step_losses(partials, logits_d, bb.det_label,
                                                             det_live[s], B, tp_classifier)
            l_ce = l_ce + torch.where(any_valid[s], ce_s, zero)
            l_f = l_f + torch.where(any_valid[s], f_s, zero)
            tp, fp, fn = tp + tp_s, fp + fp_s, fn + fn_s
        else:
            hd_steps.append(h_d_out)
            # the deferred edge logits: the branches' head partials summed
            lg_steps.append(torch.cat([lg, lg.new_zeros(BT - P, na_cap, nt_cap)]))
        for bi in range(nb):
            h_d[bi] = torch.where(det_valid[s][:, None], hd_parts[bi], h_d[bi])
            h_e[bi] = torch.where(blk_valid[s, :P, None, None, None], eo_parts[bi], h_e[bi])

    if not fused_loss:
        # the loss side of every step at once, after the loop; the static
        # targets are built window-major (they need blk_edge_base)
        st = StaticTargets(*(a[perm] for a in build_static_targets(bb, row_m_w, col_m_w)))
        logits_d = torch.where(det_live, nn.linear(params["out_node"],
                                                   torch.stack(hd_steps))[..., 0], 0.0)
        logits_e = torch.where(em3, torch.stack(lg_steps) + params["out_edge"]["b"][0], 0.0)
        l_ce, l_f, tp, fp, fn = _step_losses(logits_d, logits_e, bb, st, act, bna, bnt, row_m,
                                             det_live, blk_live, em3, tp_classifier, B)
    total = (l_ce + l_f) / B
    aux = {"loss_ce": (l_ce / B).detach(), "loss_f": (l_f / B).detach(),
           "tp": tp, "fp": fp, "fn": fn, "batch_stats": {"branches": new_stats}}
    return total, aux


# ------------------------------------------------------------- train step ----
def param_leaves(tree) -> list:
    """The tensors of a nested dict/list parameter tree, in key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in param_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in param_leaves(t)]
    return [tree]


def trainable(params):
    """A copy of `params` whose leaves are fresh tensors that require grad."""
    if isinstance(params, dict):
        return {k: trainable(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [trainable(v) for v in params]
    return params.detach().clone().requires_grad_(True)


def make_block_train_step(cfg: mpnn.ModelConfig, tp_classifier: bool, es_kernel: bool = False,
                          fused_loss: bool = False, gat_fused: bool = True):
    """A train step over a BlockBatch (make_block_train_step, block.py:1129):

        step(params, batch_stats, optimizer, bb, generator=None, att_keep=None)
            -> (params, batch_stats, loss, aux)

    es_kernel / fused_loss select block_window_forward's composition,
    gat_fused its attention route (the stacked heads, or one at a time with
    False); no probe picks one for the caller.

    params: the parameter tree with leaves that require grad (`trainable`);
    optimizer: train/optim.py::make_optimizer over param_leaves(params);
    generator / att_keep: the attention dropout of a config with heads
    (block_window_forward).  The leaves are updated in place; the returned
    batch_stats are new tensors; loss and aux (loss_ce, loss_f, tp, fp, fn)
    are detached tensors on the batch's device, so the step never waits for
    the card."""
    _check_composition(cfg, es_kernel)

    def step(params, batch_stats, optimizer, bb: BlockBatch, generator=None, att_keep=None):
        optimizer.zero_grad(set_to_none=True)
        loss, aux = block_window_forward(params, batch_stats, cfg, bb, tp_classifier,
                                         generator=generator, att_keep=att_keep,
                                         es_kernel=es_kernel, fused_loss=fused_loss,
                                         gat_fused=gat_fused)
        loss.backward()
        if fused_loss and not tp_classifier:
            # out_node feeds no loss term here, and autograd leaves its
            # gradient None where JAX's is 0: Adam's L2 still decays it
            for leaf in param_leaves(params):
                if leaf.grad is None:
                    leaf.grad = torch.zeros_like(leaf)
        optimizer.step()
        return params, aux["batch_stats"], loss.detach(), {
            k: aux[k] for k in ("loss_ce", "loss_f", "tp", "fp", "fn")}

    return step
