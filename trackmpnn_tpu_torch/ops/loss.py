"""The fused edge-side losses of the block train step (the counterpart of
trackmpnn_tpu/ops/pallas_loss.py's edge_losses).

Per round, over the blocks' edge rectangles h_eo [P, na, nt, K]:

  L1 (per block): logits = mask * (h_eo @ w_e + b_e); per row the earliest
      positive-label slot row (r_min) and the masked row max (m_r) and
      exp-sum (s_r) of the logits.
  glue (detection-sized, plain tensor ops as in the JAX package): sel1 =
      each detection's earliest positive slot row, lse_d / size_d of its
      future edges, gathered back to the rows.
  L2 (per block): the targets and the partials [P, 8]: (ce_past, ce_fut,
      bce_logpt_sum, bce_count, tp, fp, fn, 0).

The backward (one kernel) recomputes the picks and returns d h_eo, d w_e,
d b_e; the lse_d spread weight wg is detection-sized glue again.  Semantics:
train/block.py's _block_targets_and_ce, _per_window_bce_dual and the F1
counts, restricted to the edge side (ref loss.py:8-44, 77-115).

Each kernel has
  * a plain PyTorch version (`*_reference`), the semantics the tests hold
    against the JAX package and the version a CPU tensor gets;
  * for a CUDA tensor a wrapper that checks its inputs and launches the
    hand-written kernel in csrc/loss_kernels.cu, or raises.  It never
    falls back to the plain version on the card;
  * a launch counter, LAUNCHES[name], raised by one where a kernel is
    launched and nowhere else.
EdgeLosses is the autograd Function over them.
"""

from __future__ import annotations

import torch

from trackmpnn_tpu_torch.losses.losses import EPS
from trackmpnn_tpu_torch.ops import _build
from trackmpnn_tpu_torch.ops.block import _check, _on_cuda, _stream
from trackmpnn_tpu_torch.ops.segment import segment_max, segment_min, segment_sum

LAUNCHES = {"edge_loss_l1": 0, "edge_loss_l2": 0, "edge_loss_bwd": 0}
NEG = -1e30
BIG = float(1 << 30)  # larger than any slot row id (exact in f32)


# -------------------------------------------------------------- references ----
def _rowid(ebnt, na, nt):
    """Original slot row of edge (i, j) of each block, f32 [P, na, nt]
    (ebnt [P, 2] = edge_base, blk_nt)."""
    dev = ebnt.device
    ii = torch.arange(na, device=dev, dtype=torch.float32)[None, :, None]
    jj = torch.arange(nt, device=dev, dtype=torch.float32)[None, None, :]
    return ebnt[:, 0, None, None] + ii * ebnt[:, 1, None, None] + jj


def _picks(lbl, ebnt, sel1g):
    """part_b, tpos, col_has, sel_mask of the targets (pallas_loss.py:111);
    lbl bool [P, na, nt] the live positive labels."""
    P, na, nt = lbl.shape
    ii = torch.arange(na, device=lbl.device, dtype=torch.float32)[None, :, None]
    max_i = torch.where(lbl, ii, -1.0).amax(1)
    part_a = lbl & (ii == max_i[:, None, :])
    part_b = lbl & (_rowid(ebnt, na, nt) == sel1g[:, :, None])
    tpos = part_a | part_b
    sel_i = torch.where(tpos, ii, -1.0).amax(1)
    return part_b, tpos, tpos.any(1), tpos & (ii == sel_i[:, None, :])


def edge_loss_l1_reference(h_eo, w_e, b_e, lbl, mask3, ebnt):
    """(logits [P, na, nt], r_min, m_r, s_r [P, na]) of L1 (_l1_kernel,
    pallas_loss.py:88)."""
    P, na, nt, K = h_eo.shape
    logits = ((h_eo.reshape(-1, K) @ w_e).reshape(P, na, nt) + b_e) * mask3
    return (logits, *edge_loss_row_stats(logits, lbl, mask3, ebnt))


def edge_loss_row_stats(logits, lbl, mask3, ebnt):
    """L1's row statistics (r_min, m_r, s_r [P, na]) of the logits."""
    P, na, nt = logits.shape
    lblb = (lbl * mask3) > 0.5
    r_min = torch.where(lblb, _rowid(ebnt, na, nt), BIG).amin(2)
    mb = mask3 > 0.5
    m_r = torch.where(mb, logits, NEG).amax(2)
    safe_r = torch.where(m_r > NEG / 2, m_r, 0.0)
    s_r = torch.where(mb, torch.exp(logits - safe_r[:, :, None]), 0.0).sum(2)
    return r_min, m_r, s_r


def edge_loss_glue(r_min, m_r, s_r, mask3, ebnt, active_idx, act_m, nD):
    """The detection-sized segment ops between L1 and L2 (_glue,
    pallas_loss.py:252-266), plain tensor ops: (sel1, lse_d, size_d) of each
    row's detection, [P, na]."""
    cnt_row = torch.where(mask3[:, :, 0] > 0.5, ebnt[:, 1:2], 0.0)
    flat = active_idx.reshape(-1).long()
    sel1 = segment_min(r_min.reshape(-1), flat, nD, mask=act_m)
    m_star = segment_max(m_r.reshape(-1), flat, nD, mask=act_m)
    safe = torch.where(m_star > NEG / 2, m_star, 0.0)
    shift = torch.clamp(m_r.reshape(-1) - safe[flat.clamp(0, nD - 1)], max=0.0)
    s_tot = segment_sum(s_r.reshape(-1) * torch.exp(shift), flat, nD, mask=act_m)
    size_d = segment_sum(cnt_row.reshape(-1), flat, nD, mask=act_m)
    # a detection with no live row gets lse_d 0 (its part_b set is empty)
    lse_d = torch.where(size_d > 0.5, safe + torch.log(torch.clamp(s_tot, min=1e-30)), 0.0)
    idx = active_idx.long()
    return sel1[idx], lse_d[idx], size_d[idx]


def edge_loss_l2_reference(logits, lbl, mask3, ebnt, bna, sel1g, lsedg, sizedg):
    """The partials [P, 8] of L2 (_l2_kernel, pallas_loss.py:126).  Each
    block's sums run in f64 and round to f32 once, as the kernel's."""
    mb = mask3 > 0.5
    part_b, tpos, col_has, sel_mask = _picks((lbl * mask3) > 0.5, ebnt, sel1g)
    m_col = torch.where(mb, logits, NEG).amax(1)
    safe_c = torch.where(m_col > NEG / 2, m_col, 0.0)
    s_col = torch.where(mb, torch.exp(logits - safe_c[:, None, :]), 0.0).sum(1)
    lse_col = safe_c + torch.log(torch.clamp(s_col, min=1e-30))
    sel_logit = torch.where(sel_mask, logits, 0.0).sum(1)
    size_col = torch.clamp(bna[:, 0:1], min=1.0)
    ce_past = torch.where(col_has, (lse_col - sel_logit) / size_col, 0.0).double().sum(1)
    sized = torch.clamp(sizedg[:, :, None], min=1.0)
    block_sum = lambda x: x.double().sum((1, 2))
    ce_fut = block_sum(torch.where(part_b, (lsedg[:, :, None] - logits) / sized, 0.0))
    s = torch.sigmoid(logits)
    pt = torch.where(tpos, s, 1.0 - s)
    bce = block_sum(torch.where(mb, torch.log(pt + EPS), 0.0))
    pred = (s >= 0.5) & mb
    tp, fp, fn = (block_sum(m) for m in (pred & tpos, pred & ~tpos, mb & ~pred & tpos))
    out = [ce_past, ce_fut, bce, block_sum(mask3), tp, fp, fn, torch.zeros_like(tp)]
    return torch.stack(out, 1).to(torch.float32)


def edge_loss_spread(r_min, sel1g, sizedg, d_partials, active_idx, act_m, nD):
    """The lse_d spread weight wg [P, na] of the backward (pallas_loss.py:
    321-327): each detection's ce_fut cotangent (that of the block holding
    its part_b edge) over its future size, back on all of its rows."""
    has = (r_min == sel1g) & (sel1g < BIG / 2)
    w_rows = torch.where(has, d_partials[:, 1:2], 0.0)
    wd = segment_sum(w_rows.reshape(-1), active_idx.reshape(-1), nD, mask=act_m)
    return wd[active_idx.long()] / torch.clamp(sizedg, min=1.0)


def edge_loss_bwd_reference(h_eo, w_e, logits, lbl, mask3, ebnt, bna, sel1g, lsedg, sizedg,
                            wg, d_partials):
    """(d h_eo, d w_e [K, 1], d b_e [1, 1]) for the cotangent d_partials
    [P, 8] of the partials (_lb_kernel, pallas_loss.py:167-232); the counts
    carry no gradient."""
    P, na, nt, K = h_eo.shape
    mb = mask3 > 0.5
    part_b, tpos, col_has, sel_mask = _picks((lbl * mask3) > 0.5, ebnt, sel1g)
    d_cep = d_partials[:, 0, None, None]
    d_cef = d_partials[:, 1, None, None]
    d_bce = d_partials[:, 2, None, None]
    # ce_past: sum over columns of col_has * (lse_col - sel_logit) / size_col
    m_col = torch.where(mb, logits, NEG).amax(1)
    safe_c = torch.where(m_col > NEG / 2, m_col, 0.0)
    e_col = torch.where(mb, torch.exp(logits - safe_c[:, None, :]), 0.0)
    s_col = torch.clamp(e_col.sum(1), min=1e-30)
    w_col = (col_has / torch.clamp(bna[:, 0:1], min=1.0))[:, None, :]
    dl = d_cep * w_col * (e_col / s_col[:, None, :] - sel_mask.to(torch.float32))
    # ce_fut: part_b * (lse_d - logits) / size_d, lse_d's spread through wg
    sized = torch.clamp(sizedg[:, :, None], min=1.0)
    soft_d = torch.where(mb, torch.exp(logits - lsedg[:, :, None]), 0.0)
    dl = dl + (wg[:, :, None] * soft_d - d_cef * part_b.to(torch.float32) / sized)
    # bce: sum of log(pt + EPS)
    s = torch.sigmoid(logits)
    pt = torch.where(tpos, s, 1.0 - s)
    sgn = torch.where(tpos, 1.0, -1.0)
    dl = dl + d_bce * torch.where(mb, sgn * s * (1.0 - s) / (pt + EPS), 0.0)
    dl = dl * mask3
    dheo = dl[..., None] * w_e.reshape(1, 1, 1, K)
    dwe = (h_eo * dl[..., None]).reshape(-1, K).sum(0)[:, None]
    return dheo, dwe, dl.sum().reshape(1, 1)


# ---------------------------------------------------------------- wrappers ----
def _block_dims(name, lbl, mask3, ebnt, bna=None):
    if mask3.dim() != 3:
        raise TypeError(f"{name}: mask3 must be f32[P, na, nt], got {list(mask3.shape)}")
    P, na, nt = mask3.shape
    f32 = torch.float32
    _check(name, mask3.device, lbl=(lbl, f32, (P, na, nt)), mask3=(mask3, f32, (P, na, nt)),
           ebnt=(ebnt, f32, (P, 2)))
    if bna is not None:
        _check(name, mask3.device, bna=(bna, f32, (P, 1)))
    return P, na, nt


def _launch(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _l1_cuda(h_eo, w_e, b_e, lbl, mask3, ebnt):
    P, na, nt = _block_dims("edge_loss_l1", lbl, mask3, ebnt)
    if h_eo.dim() != 4:
        raise TypeError(f"edge_loss_l1: h_eo must be f32[P, na, nt, K], got {list(h_eo.shape)}")
    K = h_eo.shape[3]
    f32 = torch.float32
    _check("edge_loss_l1", mask3.device, h_eo=(h_eo, f32, (P, na, nt, K)),
           w_e=(w_e, f32, (K, 1)), b_e=(b_e, f32, (1, 1)))
    dev = h_eo.device
    logits = torch.empty(P, na, nt, dtype=f32, device=dev)
    r_min, m_r, s_r = (torch.empty(P, na, dtype=f32, device=dev) for _ in range(3))
    if logits.numel() == 0:
        return logits, r_min.fill_(BIG), m_r.fill_(NEG), s_r.zero_()
    with torch.cuda.device(dev):
        rc = _build.load("loss").tm_edge_loss_l1(
            h_eo.data_ptr(), w_e.data_ptr(), b_e.data_ptr(), lbl.data_ptr(), mask3.data_ptr(),
            ebnt.data_ptr(), logits.data_ptr(), r_min.data_ptr(), m_r.data_ptr(),
            s_r.data_ptr(), P, na, nt, K, _stream())
    _launch("edge_loss_l1", rc)
    return logits, r_min, m_r, s_r


def _l2_cuda(logits, lbl, mask3, ebnt, bna, sel1g, lsedg, sizedg):
    P, na, nt = _block_dims("edge_loss_l2", lbl, mask3, ebnt, bna)
    f32 = torch.float32
    _check("edge_loss_l2", mask3.device, logits=(logits, f32, (P, na, nt)),
           sel1g=(sel1g, f32, (P, na)), lsedg=(lsedg, f32, (P, na)),
           sizedg=(sizedg, f32, (P, na)))
    out = torch.empty(P, 8, dtype=f32, device=mask3.device)
    if logits.numel() == 0:
        return out.zero_()
    lib = _build.load("loss")
    # the column tiles' f64 sums where a block takes more than one CTA
    tiles = lib.tm_edge_loss_l2_tiles(nt)
    scratch = torch.empty(P * tiles * 8 if tiles > 1 else 1, dtype=torch.float64,
                          device=mask3.device)
    with torch.cuda.device(mask3.device):
        rc = lib.tm_edge_loss_l2(
            logits.data_ptr(), lbl.data_ptr(), mask3.data_ptr(), ebnt.data_ptr(),
            bna.data_ptr(), sel1g.data_ptr(), lsedg.data_ptr(), sizedg.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), P, na, nt, _stream())
    _launch("edge_loss_l2", rc)
    return out


def _bwd_cuda(h_eo, w_e, logits, lbl, mask3, ebnt, bna, sel1g, lsedg, sizedg, wg, d_partials):
    P, na, nt = _block_dims("edge_loss_bwd", lbl, mask3, ebnt, bna)
    if h_eo.dim() != 4:
        raise TypeError(f"edge_loss_bwd: h_eo must be f32[P, na, nt, K], got "
                        f"{list(h_eo.shape)}")
    K = h_eo.shape[3]
    f32 = torch.float32
    _check("edge_loss_bwd", mask3.device, h_eo=(h_eo, f32, (P, na, nt, K)),
           w_e=(w_e, f32, (K, 1)), logits=(logits, f32, (P, na, nt)),
           sel1g=(sel1g, f32, (P, na)), lsedg=(lsedg, f32, (P, na)),
           sizedg=(sizedg, f32, (P, na)), wg=(wg, f32, (P, na)),
           d_partials=(d_partials, f32, (P, 8)))
    dev = h_eo.device
    dheo = torch.empty_like(h_eo)
    dw = torch.empty(K + 1, dtype=f32, device=dev)  # d w_e | d b_e
    if logits.numel() == 0:
        dheo.zero_(), dw.zero_()
    else:
        lib = _build.load("loss")
        # the column statistics and the per-tile partials of d w_e | d b_e
        scratch = torch.empty(lib.tm_edge_loss_bwd_scratch_floats(P, na, nt, K), dtype=f32,
                              device=dev)
        with torch.cuda.device(dev):
            rc = lib.tm_edge_loss_bwd(
                h_eo.data_ptr(), w_e.data_ptr(), logits.data_ptr(), lbl.data_ptr(),
                mask3.data_ptr(), ebnt.data_ptr(), bna.data_ptr(), sel1g.data_ptr(),
                lsedg.data_ptr(), sizedg.data_ptr(), wg.data_ptr(), d_partials.data_ptr(),
                dheo.data_ptr(), scratch.data_ptr(), dw.data_ptr(), P, na, nt, K, _stream())
        _launch("edge_loss_bwd", rc)
    return dheo, dw[:K].view(K, 1), dw[K:].view(1, 1)


def edge_loss_l1(h_eo, w_e, b_e, lbl, mask3, ebnt):
    """L1: the kernel on a CUDA tensor, the plain version on a CPU tensor."""
    fn = _l1_cuda if _on_cuda(h_eo) else edge_loss_l1_reference
    return fn(h_eo, w_e, b_e, lbl, mask3, ebnt)


def edge_loss_l2(logits, lbl, mask3, ebnt, bna, sel1g, lsedg, sizedg):
    """L2: the kernel on a CUDA tensor, the plain version on a CPU tensor."""
    fn = _l2_cuda if _on_cuda(logits) else edge_loss_l2_reference
    return fn(logits, lbl, mask3, ebnt, bna, sel1g, lsedg, sizedg)


def edge_loss_bwd(h_eo, w_e, logits, lbl, mask3, ebnt, bna, sel1g, lsedg, sizedg, wg,
                  d_partials):
    """The backward: the kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    fn = _bwd_cuda if _on_cuda(h_eo) else edge_loss_bwd_reference
    return fn(h_eo, w_e, logits, lbl, mask3, ebnt, bna, sel1g, lsedg, sizedg, wg, d_partials)


class EdgeLosses(torch.autograd.Function):
    """partials = edge_losses(...), differentiable in h_eo, w_e and b_e with
    the hand-derived backward (the custom VJP of pallas_loss.py:234)."""

    @staticmethod
    def forward(ctx, h_eo, w_e, b_e, lbl, mask3, ebnt, bna, active_idx, act_m, nD):
        logits, r_min, m_r, s_r = edge_loss_l1(h_eo, w_e, b_e, lbl, mask3, ebnt)
        sel1g, lsedg, sizedg = edge_loss_glue(r_min, m_r, s_r, mask3, ebnt, active_idx, act_m,
                                              nD)
        partials = edge_loss_l2(logits, lbl, mask3, ebnt, bna, sel1g, lsedg, sizedg)
        ctx.save_for_backward(h_eo, w_e, lbl, mask3, ebnt, bna, logits, r_min, sel1g, lsedg,
                              sizedg, active_idx, act_m)
        ctx.nD = nD
        return partials

    @staticmethod
    def backward(ctx, d_partials):
        (h_eo, w_e, lbl, mask3, ebnt, bna, logits, r_min, sel1g, lsedg, sizedg, active_idx,
         act_m) = ctx.saved_tensors
        d_partials = d_partials.contiguous()
        wg = edge_loss_spread(r_min, sel1g, sizedg, d_partials, active_idx, act_m, ctx.nD)
        dheo, dwe, dbe = edge_loss_bwd(h_eo, w_e, logits, lbl, mask3, ebnt, bna, sel1g, lsedg,
                                       sizedg, wg.contiguous(), d_partials)
        return (dheo, dwe, dbe) + (None,) * 7


def edge_losses(h_eo, w_e, b_e, lbl, mask3, ebnt, bna, active_idx, act_m, nD):
    """Edge-side targets, CE, BCE and F1 partials of one round
    (edge_losses, pallas_loss.py:235), differentiable in h_eo, w_e, b_e.

    h_eo f32 [P, na, nt, K] the round's edge hidden; w_e [K, 1], b_e [1, 1]
    the edge output head; lbl f32 [P, na, nt] (1.0 where the edge label is
    1); mask3 f32 [P, na, nt] 0/1 live cells; ebnt f32 [P, 2] (edge_base,
    blk_nt); bna f32 [P, 1] (blk_na); active_idx int32 [P, na] global
    detection of each row; act_m bool [P*na] the live rows; nD detections.
    Returns partials f32 [P, 8]: (ce_past, ce_fut, bce_logpt_sum,
    bce_count, tp, fp, fn, 0)."""
    return EdgeLosses.apply(h_eo, w_e, b_e, lbl, mask3, ebnt, bna, active_idx, act_m, nD)
