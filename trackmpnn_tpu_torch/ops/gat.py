"""Ops of the GAT attention heads in the block train step (the counterpart
of trackmpnn_tpu/ops/pallas_gat.py's stacked-head gat_scores_stats_mh and
gat_aggregate_mh, of its single-head gat_scores_stats and gat_aggregate,
and of its raw scores gat_scores).

Each op has
  * a plain PyTorch version of its forward and of its hand-derived backward
    (`*_reference`), the semantics the tests hold against the JAX package
    and the version a CPU tensor gets;
  * an autograd Function whose forward and backward, for a CUDA tensor,
    check their inputs and launch the hand-written kernels in
    csrc/gat_kernels.cu, or raise.  They never fall back to the plain
    version on the card.  The forward saves only its inputs; the backward
    recomputes, as the JAX custom VJPs do (pallas_gat.py:611, :740);
  * launch counters, LAUNCHES[name], raised by one where a kernel is
    launched and nowhere else.

Layout (pallas_gat.py:459-485): the heads' detection projections sit side
by side on the feature axis (ha [P, na, nh*H], hn [P, nt, nh*H], a
[nh*H, 1]); scores and softmax statistics are head-leading ([nh, P, ...]);
the aggregate sums its rs / cs over the heads (the caller divides by nh).
Keep masks ka / kn are [nh or 1, P, na, nt] (one head broadcasts) and are
read only when keep < 1.

The single-head ops compute one head in the layout of the JAX package's
single-head kernels, with no head axis anywhere: gat_scores_stats_1h (for
gat_scores_stats, pallas_gat.py:224) takes ha [P, na, H], hn [P, nt, H], a
[H, 1] and gives e [P, na, nt], rmax / sa_l [P, na], cmax / sb_l [P, nt];
gat_aggregate_1h (for gat_aggregate, pallas_gat.py:350) takes e, keep masks
[P, na, nt] and the statistics [P, na] / [P, nt], and gives the head's own
rs / cs.  At one head they compute what the stacked ops compute, so their
plain versions are the stacked ones' at nh = 1; on the card they launch
single-head instances of the same kernel bodies (tm_gat1_* in
csrc/gat_kernels.cu), counted apart.  The block step's per-head attention
route (train/block.py, gat_fused=False) calls them once per head.

gat_scores (for gat_scores, pallas_gat.py:78) is the single-head scores op
without its statistics: e [P, na, nt] alone, with the VJP d ha, d hn, d a.
Its plain version is gat_scores_stats_1h's first output; on the card it
launches tm_gat0_* (the single-head bodies with the statistics compiled
out).  No path of the JAX package calls gat_scores (every attention route
needs the statistics with the scores), so no path of the port does yet.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from trackmpnn_tpu_torch.ops import _build
from trackmpnn_tpu_torch.ops.block import _check, _on_cuda, _stream, _zeros_if_none

NEG_SCORE = -1e30  # score of a masked cell in the max (pallas_gat.py:164)
Z_FLOOR = 1e-30    # floor of a softmax normaliser

LAUNCHES = {"gat_scores_fwd": 0, "gat_scores_bwd": 0,
            "gat_aggregate_fwd": 0, "gat_aggregate_bwd": 0,
            "gat1_scores_fwd": 0, "gat1_scores_bwd": 0,
            "gat1_aggregate_fwd": 0, "gat1_aggregate_bwd": 0,
            "gat0_scores_fwd": 0, "gat0_scores_bwd": 0}


# -------------------------------------------------------------- references ----
def _heads(x, nh):
    """[P, n, nh*H] -> [nh, P, n, H]."""
    P, n, HH = x.shape
    return x.reshape(P, n, nh, HH // nh).permute(2, 0, 1, 3)


def _unheads(x):
    """[nh, P, n, H] -> [P, n, nh*H]."""
    nh, P, n, H = x.shape
    return x.permute(1, 2, 0, 3).reshape(P, n, nh * H)


def _scores(ha, hn, a, mask3, alpha, nh):
    """(d, pre_m, e, e_m): d = ha_i - hn_j [nh, P, na, nt, H]; pre_m the
    masked |d| . a; e its leaky relu; e_m the scores with masked cells at
    NEG_SCORE (_mh_stats_fwd_kernel, pallas_gat.py:512-522)."""
    d = _heads(ha, nh)[:, :, :, None, :] - _heads(hn, nh)[:, :, None, :, :]
    pre_m = (d.abs() * a.reshape(nh, 1, 1, 1, -1)).sum(-1) * mask3
    e = torch.where(pre_m >= 0, pre_m, alpha * pre_m)
    return d, pre_m, e, torch.where(mask3 > 0, e, NEG_SCORE)


def _maxes(e_m):
    """Row and column maxes of the masked scores, without gradient."""
    return e_m.detach().amax(3), e_m.detach().amax(2)


def gat_scores_stats_reference(ha, hn, a, mask3, alpha, nh):
    """(e, rmax, cmax, sa_l, sb_l) of every head (gat_scores_stats_mh,
    pallas_gat.py:572):

        e      = leaky(sum_k |ha[i, hH+k] - hn[j, hH+k]| a[hH+k] * m3)   [nh, P, na, nt]
        rmax   = max_j e_m,  cmax = max_i e_m      (e_m: NEG_SCORE where masked)
        sa_l   = sum_j m3 exp(e_m - rmax),  sb_l = sum_i m3 exp(e_m - cmax)

    rmax and cmax carry no gradient: the softmax is invariant to its shift,
    so the caller stops it (block.py:428-429) and the backward ignores it."""
    _, _, e, e_m = _scores(ha, hn, a, mask3, alpha, nh)
    rmax, cmax = _maxes(e_m)
    sal = (mask3 * torch.exp(e_m - rmax[..., None])).sum(3)
    sbl = (mask3 * torch.exp(e_m - cmax[:, :, None, :])).sum(2)
    return e, rmax, cmax, sal, sbl


def gat_scores_stats_backward_reference(ha, hn, a, mask3, alpha, nh, ge, gsal, gsbl):
    """The hand-derived backward (_mh_stats_bwd_kernel, pallas_gat.py:531-568):
    recomputes the scores and returns (d ha, d hn, d a).  d|x| is sign(x),
    0 at 0."""
    d, pre_m, _, e_m = _scores(ha, hn, a, mask3, alpha, nh)
    rmax, cmax = _maxes(e_m)
    de = (ge + gsal[..., None] * mask3 * torch.exp(e_m - rmax[..., None])
          + gsbl[:, :, None, :] * mask3 * torch.exp(e_m - cmax[:, :, None, :]))
    slope = torch.where(pre_m >= 0, torch.ones_like(pre_m), torch.full_like(pre_m, alpha))
    dpre = de * slope * mask3
    t = dpre[..., None] * torch.sign(d) * a.reshape(nh, 1, 1, 1, -1)
    da = (d.abs() * dpre[..., None]).sum((1, 2, 3)).reshape(-1, 1)
    return _unheads(t.sum(3)), _unheads(-t.sum(2)), da


def _attention(e, m_row, m_col, z_row, z_col, mask3, ka, kn, keep):
    """att_a, att_n [nh, P, na, nt] (_att_rect, pallas_gat.py:294-303).  A
    masked cell weighs exactly 0: its exponent is replaced before the exp,
    so neither the value nor the gradient meets exp of a large number."""
    live = mask3 > 0
    att_a = (mask3 * torch.exp(torch.where(live, e - m_row[..., None], NEG_SCORE))
             / torch.clamp(z_row[..., None], min=Z_FLOOR))
    att_n = (mask3 * torch.exp(torch.where(live, e - m_col[:, :, None, :], NEG_SCORE))
             / torch.clamp(z_col[:, :, None, :], min=Z_FLOOR))
    if keep < 1.0:
        att_a = att_a * ka / keep
        att_n = att_n * kn / keep
    return att_a, att_n


def gat_aggregate_reference(e, m_row, m_col, z_row, z_col, h_e, mask3, ka, kn, keep):
    """(rs, cs) summed over heads (gat_aggregate_mh, pallas_gat.py:700):

        att_a = m3 exp(e - m_row) / max(z_row, 1e-30) * ka / keep
        att_n = m3 exp(e - m_col) / max(z_col, 1e-30) * kn / keep
        rs[i] = sum_h sum_j att_a h_e[i, j],  cs[j] = sum_h sum_i att_n h_e[i, j]

    e [nh, P, na, nt]; m_row, z_row [nh, P, na]; m_col, z_col [nh, P, nt];
    h_e [P, na, nt, H]; mask3 [P, na, nt] 0/1; ka, kn [nh or 1, P, na, nt]."""
    att_a, att_n = _attention(e, m_row, m_col, z_row, z_col, mask3, ka, kn, keep)
    return (torch.einsum("hpij,pijd->pid", att_a, h_e),
            torch.einsum("hpij,pijd->pjd", att_n, h_e))


def gat_aggregate_backward_reference(e, m_row, m_col, z_row, z_col, h_e, mask3, ka, kn,
                                     keep, g_rs, g_cs):
    """The hand-derived backward (_mh_agg_bwd_kernel, pallas_gat.py:664-696,
    with the datt contraction of _datt, :398-405): returns (d e, d m_row,
    d m_col, d z_row, d z_col, d h_e)."""
    att_a, att_n = _attention(e, m_row, m_col, z_row, z_col, mask3, ka, kn, keep)
    datt_a = torch.einsum("pijd,pid->pij", h_e, g_rs)
    datt_n = torch.einsum("pijd,pjd->pij", h_e, g_cs)
    pa, pn = datt_a * att_a, datt_n * att_n
    s_a, s_n = pa.sum(3), pn.sum(2)
    dhe = (att_a[..., None] * g_rs[None, :, :, None, :]
           + att_n[..., None] * g_cs[None, :, None, :, :]).sum(0)
    return (pa + pn, -s_a, -s_n, -s_a / torch.clamp(z_row, min=Z_FLOOR),
            -s_n / torch.clamp(z_col, min=Z_FLOOR), dhe)


def gat_scores_stats_1h_reference(ha, hn, a, mask3, alpha):
    """(e, rmax, cmax, sa_l, sb_l) of one head (gat_scores_stats,
    pallas_gat.py:224): gat_scores_stats_reference at nh = 1, without the
    head axis."""
    return tuple(t[0] for t in gat_scores_stats_reference(ha, hn, a, mask3, alpha, 1))


def gat_scores_stats_1h_backward_reference(ha, hn, a, mask3, alpha, ge, gsal, gsbl):
    """(d ha, d hn, d a) of one head (_stats_bwd, pallas_gat.py:264)."""
    return gat_scores_stats_backward_reference(ha, hn, a, mask3, alpha, 1, ge[None], gsal[None],
                                               gsbl[None])


def gat_scores_reference(ha, hn, a, mask3, alpha):
    """e = leaky(sum_k |ha[i, k] - hn[j, k]| a[k] * m3) [P, na, nt], 0 where
    masked (gat_scores, pallas_gat.py:78; reference_gat_scores, :134)."""
    return _scores(ha, hn, a, mask3, alpha, 1)[2][0]


def gat_scores_backward_reference(ha, hn, a, mask3, alpha, ge):
    """(d ha, d hn, d a) of gat_scores (_bwd_kernel, pallas_gat.py:50-75):
    gat_scores_stats_1h_backward_reference with zero statistic cotangents.
    A masked cell passes no cotangent; d|x| is sign(x), 0 at 0."""
    P, na, nt = mask3.shape
    return gat_scores_stats_1h_backward_reference(ha, hn, a, mask3, alpha, ge,
                                                  ge.new_zeros(P, na), ge.new_zeros(P, nt))


def gat_aggregate_1h_reference(e, m_row, m_col, z_row, z_col, h_e, mask3, ka, kn, keep):
    """(rs, cs) of one head (gat_aggregate, pallas_gat.py:350); e, ka, kn
    [P, na, nt], the statistics [P, na] / [P, nt]."""
    heads = (t[None] for t in (e, m_row, m_col, z_row, z_col))
    return gat_aggregate_reference(*heads, h_e, mask3, ka[None], kn[None], keep)


def gat_aggregate_1h_backward_reference(e, m_row, m_col, z_row, z_col, h_e, mask3, ka, kn, keep,
                                        g_rs, g_cs):
    """(d e, d m_row, d m_col, d z_row, d z_col, d h_e) of one head
    (_agg_bwd, pallas_gat.py:408, _datt included)."""
    heads = (t[None] for t in (e, m_row, m_col, z_row, z_col))
    out = gat_aggregate_backward_reference(*heads, h_e, mask3, ka[None], kn[None], keep, g_rs,
                                           g_cs)
    return tuple(t[0] for t in out[:5]) + (out[5],)


# ---------------------------------------------------------------- wrappers ----
C_INT_MAX = 2 ** 31 - 1  # the kernels' C interface passes every width as an int


@functools.lru_cache(maxsize=None)
def attention_widths(H):
    """The attention kernels' width rule, checked once for each H: any
    hidden width from 0 to C_INT_MAX.  Every kernel tiles its rectangle and
    walks H in chunks, so its shared memory is fixed by the tile, whatever
    P, na, nt, nh and H are.  Raises ValueError naming the width it refuses;
    JAX's Pallas kernels take any H."""
    if not 0 <= H <= C_INT_MAX:
        raise ValueError(f"the attention kernels take a hidden width H from 0 to {C_INT_MAX}, "
                         f"not H={H}")
    return H


def _gat_library(name, H):
    """The gat library, once H passes attention_widths."""
    try:
        attention_widths(H)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    return _build.load("gat")


def _scratch(lib, device, kind, P, na, nt, nh, H, backward, stats=True):
    """One f32 tensor holding the scratch a call's kernels need: the score
    kernels (kind 0) or the aggregate kernels (kind 1), as
    tm_gat_scratch_floats counts it for these widths (often none: an empty
    tensor, whose pointer the kernels never read)."""
    n = ctypes.c_int64(0)
    lib.tm_gat_scratch_floats(kind, P, na, nt, nh, H, int(backward), int(stats),
                              ctypes.addressof(n))
    return torch.empty(n.value, dtype=torch.float32, device=device)


def _score_inputs(name, ha, hn, a, mask3, nh):
    if ha.dim() != 3 or hn.dim() != 3:
        raise TypeError(f"{name}: ha, hn must be [P, n, nh*H], got {list(ha.shape)}, "
                        f"{list(hn.shape)}")
    P, na, HH = ha.shape
    nt = hn.shape[1]
    if nh < 1 or HH % nh != 0:
        raise ValueError(f"{name}: feature width {HH} is not nh={nh} heads")
    f32 = torch.float32
    _check(name, ha.device, ha=(ha, f32, (P, na, HH)), hn=(hn, f32, (P, nt, HH)),
           a=(a, f32, (HH, 1)), mask3=(mask3, f32, (P, na, nt)))
    return _gat_library(name, HH // nh), P, na, nt, HH // nh


def _gat_scores_fwd_cuda(ha, hn, a, mask3, alpha, nh):
    lib, P, na, nt, H = _score_inputs("gat_scores_fwd", ha, hn, a, mask3, nh)
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=ha.device)
    out = (new(nh, P, na, nt), new(nh, P, na), new(nh, P, nt), new(nh, P, na), new(nh, P, nt))
    if P == 0 or na == 0 or nt == 0:
        return tuple(t.zero_() for t in out)
    scratch = _scratch(lib, ha.device, 0, P, na, nt, nh, H, False)
    with torch.cuda.device(ha.device):
        rc = lib.tm_gat_scores_fwd(ha.data_ptr(), hn.data_ptr(), a.data_ptr(), mask3.data_ptr(),
                                   *(t.data_ptr() for t in out), scratch.data_ptr(), P, na, nt,
                                   nh, H, float(alpha), _stream())
    if rc != 0:
        raise RuntimeError(f"gat_scores_fwd kernel launch failed: CUDA error {rc}")
    LAUNCHES["gat_scores_fwd"] += 1
    return out


def _gat_scores_bwd_cuda(ha, hn, a, mask3, alpha, nh, ge, gsal, gsbl):
    lib, P, na, nt, H = _score_inputs("gat_scores_bwd", ha, hn, a, mask3, nh)
    f32 = torch.float32
    _check("gat_scores_bwd", ha.device, ge=(ge, f32, (nh, P, na, nt)),
           gsal=(gsal, f32, (nh, P, na)), gsbl=(gsbl, f32, (nh, P, nt)))
    dha, dhn = torch.empty_like(ha), torch.empty_like(hn)
    da = torch.empty(nh * H, 1, dtype=f32, device=ha.device)
    if P == 0 or na == 0 or nt == 0:
        return dha.zero_(), dhn.zero_(), da.zero_()
    scratch = _scratch(lib, ha.device, 0, P, na, nt, nh, H, True)
    with torch.cuda.device(ha.device):
        rc = lib.tm_gat_scores_bwd(ha.data_ptr(), hn.data_ptr(), a.data_ptr(), mask3.data_ptr(),
                                   ge.data_ptr(), gsal.data_ptr(), gsbl.data_ptr(),
                                   dha.data_ptr(), dhn.data_ptr(), scratch.data_ptr(),
                                   da.data_ptr(), P, na, nt, nh, H, float(alpha), _stream())
    if rc != 0:
        raise RuntimeError(f"gat_scores_bwd kernel launch failed: CUDA error {rc}")
    LAUNCHES["gat_scores_bwd"] += 1
    return dha, dhn, da


def _aggregate_inputs(name, e, m_row, m_col, z_row, z_col, h_e, mask3, ka, kn):
    if e.dim() != 4 or h_e.dim() != 4 or ka.dim() != 4:
        raise TypeError(f"{name}: e, h_e, ka must be 4-d, got {list(e.shape)}, "
                        f"{list(h_e.shape)}, {list(ka.shape)}")
    nh = e.shape[0]
    P, na, nt, H = h_e.shape
    nk = ka.shape[0]
    if nk not in (1, nh):
        raise ValueError(f"{name}: keep masks have {nk} heads, expected 1 or {nh}")
    f32 = torch.float32
    _check(name, e.device, e=(e, f32, (nh, P, na, nt)), m_row=(m_row, f32, (nh, P, na)),
           m_col=(m_col, f32, (nh, P, nt)), z_row=(z_row, f32, (nh, P, na)),
           z_col=(z_col, f32, (nh, P, nt)), h_e=(h_e, f32, (P, na, nt, H)),
           mask3=(mask3, f32, (P, na, nt)), ka=(ka, f32, (nk, P, na, nt)),
           kn=(kn, f32, (nk, P, na, nt)))
    return _gat_library(name, H), nh, P, na, nt, H, nk


def _gat_aggregate_fwd_cuda(e, m_row, m_col, z_row, z_col, h_e, mask3, ka, kn, keep):
    args = (e, m_row, m_col, z_row, z_col, h_e, mask3, ka, kn)
    lib, nh, P, na, nt, H, nk = _aggregate_inputs("gat_aggregate_fwd", *args)
    rs = torch.empty(P, na, H, dtype=torch.float32, device=e.device)
    cs = torch.empty(P, nt, H, dtype=torch.float32, device=e.device)
    if P == 0 or na == 0 or nt == 0:
        return rs.zero_(), cs.zero_()
    scratch = _scratch(lib, e.device, 1, P, na, nt, nh, H, False)
    with torch.cuda.device(e.device):
        rc = lib.tm_gat_aggregate_fwd(*(t.data_ptr() for t in args), rs.data_ptr(),
                                      cs.data_ptr(), scratch.data_ptr(), P, na, nt, nh, H, nk,
                                      float(keep), _stream())
    if rc != 0:
        raise RuntimeError(f"gat_aggregate_fwd kernel launch failed: CUDA error {rc}")
    LAUNCHES["gat_aggregate_fwd"] += 1
    return rs, cs


def _gat_aggregate_bwd_cuda(e, m_row, m_col, z_row, z_col, h_e, mask3, ka, kn, keep,
                            g_rs, g_cs):
    args = (e, m_row, m_col, z_row, z_col, h_e, mask3, ka, kn)
    lib, nh, P, na, nt, H, nk = _aggregate_inputs("gat_aggregate_bwd", *args)
    _check("gat_aggregate_bwd", e.device, g_rs=(g_rs, torch.float32, (P, na, H)),
           g_cs=(g_cs, torch.float32, (P, nt, H)))
    out = (torch.empty_like(e), torch.empty_like(m_row), torch.empty_like(m_col),
           torch.empty_like(z_row), torch.empty_like(z_col), torch.empty_like(h_e))
    if P == 0 or na == 0 or nt == 0:
        return tuple(t.zero_() for t in out)
    scratch = _scratch(lib, e.device, 1, P, na, nt, nh, H, True)
    with torch.cuda.device(e.device):
        rc = lib.tm_gat_aggregate_bwd(*(t.data_ptr() for t in args), g_rs.data_ptr(),
                                      g_cs.data_ptr(), *(t.data_ptr() for t in out),
                                      scratch.data_ptr(), P, na, nt, nh, H, nk, float(keep),
                                      _stream())
    if rc != 0:
        raise RuntimeError(f"gat_aggregate_bwd kernel launch failed: CUDA error {rc}")
    LAUNCHES["gat_aggregate_bwd"] += 1
    return out


def _gat1_scores_fwd_cuda(ha, hn, a, mask3, alpha):
    lib, P, na, nt, H = _score_inputs("gat1_scores_fwd", ha, hn, a, mask3, 1)
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=ha.device)
    out = (new(P, na, nt), new(P, na), new(P, nt), new(P, na), new(P, nt))
    if P == 0 or na == 0 or nt == 0:
        return tuple(t.zero_() for t in out)
    scratch = _scratch(lib, ha.device, 0, P, na, nt, 1, H, False)
    with torch.cuda.device(ha.device):
        rc = lib.tm_gat1_scores_fwd(ha.data_ptr(), hn.data_ptr(), a.data_ptr(), mask3.data_ptr(),
                                    *(t.data_ptr() for t in out), scratch.data_ptr(), P, na, nt,
                                    H, float(alpha), _stream())
    if rc != 0:
        raise RuntimeError(f"gat1_scores_fwd kernel launch failed: CUDA error {rc}")
    LAUNCHES["gat1_scores_fwd"] += 1
    return out


def _gat1_scores_bwd_cuda(ha, hn, a, mask3, alpha, ge, gsal, gsbl):
    lib, P, na, nt, H = _score_inputs("gat1_scores_bwd", ha, hn, a, mask3, 1)
    f32 = torch.float32
    _check("gat1_scores_bwd", ha.device, ge=(ge, f32, (P, na, nt)), gsal=(gsal, f32, (P, na)),
           gsbl=(gsbl, f32, (P, nt)))
    dha, dhn = torch.empty_like(ha), torch.empty_like(hn)
    da = torch.empty(H, 1, dtype=f32, device=ha.device)
    if P == 0 or na == 0 or nt == 0:
        return dha.zero_(), dhn.zero_(), da.zero_()
    scratch = _scratch(lib, ha.device, 0, P, na, nt, 1, H, True)
    with torch.cuda.device(ha.device):
        rc = lib.tm_gat1_scores_bwd(ha.data_ptr(), hn.data_ptr(), a.data_ptr(), mask3.data_ptr(),
                                    ge.data_ptr(), gsal.data_ptr(), gsbl.data_ptr(),
                                    dha.data_ptr(), dhn.data_ptr(), scratch.data_ptr(),
                                    da.data_ptr(), P, na, nt, H, float(alpha), _stream())
    if rc != 0:
        raise RuntimeError(f"gat1_scores_bwd kernel launch failed: CUDA error {rc}")
    LAUNCHES["gat1_scores_bwd"] += 1
    return dha, dhn, da


def _gat0_scores_fwd_cuda(ha, hn, a, mask3, alpha):
    lib, P, na, nt, H = _score_inputs("gat0_scores_fwd", ha, hn, a, mask3, 1)
    e = torch.empty(P, na, nt, dtype=torch.float32, device=ha.device)
    if P == 0 or na == 0 or nt == 0:
        return e.zero_()
    with torch.cuda.device(ha.device):
        rc = lib.tm_gat0_scores_fwd(ha.data_ptr(), hn.data_ptr(), a.data_ptr(), mask3.data_ptr(),
                                    e.data_ptr(), P, na, nt, H, float(alpha), _stream())
    if rc != 0:
        raise RuntimeError(f"gat0_scores_fwd kernel launch failed: CUDA error {rc}")
    LAUNCHES["gat0_scores_fwd"] += 1
    return e


def _gat0_scores_bwd_cuda(ha, hn, a, mask3, alpha, ge):
    lib, P, na, nt, H = _score_inputs("gat0_scores_bwd", ha, hn, a, mask3, 1)
    f32 = torch.float32
    _check("gat0_scores_bwd", ha.device, ge=(ge, f32, (P, na, nt)))
    dha, dhn = torch.empty_like(ha), torch.empty_like(hn)
    da = torch.empty(H, 1, dtype=f32, device=ha.device)
    if P == 0 or na == 0 or nt == 0:
        return dha.zero_(), dhn.zero_(), da.zero_()
    scratch = _scratch(lib, ha.device, 0, P, na, nt, 1, H, True, stats=False)
    with torch.cuda.device(ha.device):
        rc = lib.tm_gat0_scores_bwd(ha.data_ptr(), hn.data_ptr(), a.data_ptr(), mask3.data_ptr(),
                                    ge.data_ptr(), dha.data_ptr(), dhn.data_ptr(),
                                    scratch.data_ptr(), da.data_ptr(), P, na, nt, H,
                                    float(alpha), _stream())
    if rc != 0:
        raise RuntimeError(f"gat0_scores_bwd kernel launch failed: CUDA error {rc}")
    LAUNCHES["gat0_scores_bwd"] += 1
    return dha, dhn, da


def _aggregate_1h_inputs(name, e, m_row, m_col, z_row, z_col, h_e, mask3, ka, kn):
    if e.dim() != 3 or h_e.dim() != 4:
        raise TypeError(f"{name}: e must be [P, na, nt] and h_e [P, na, nt, H], got "
                        f"{list(e.shape)}, {list(h_e.shape)}")
    P, na, nt, H = h_e.shape
    f32 = torch.float32
    _check(name, e.device, e=(e, f32, (P, na, nt)), m_row=(m_row, f32, (P, na)),
           m_col=(m_col, f32, (P, nt)), z_row=(z_row, f32, (P, na)),
           z_col=(z_col, f32, (P, nt)), h_e=(h_e, f32, (P, na, nt, H)),
           mask3=(mask3, f32, (P, na, nt)), ka=(ka, f32, (P, na, nt)),
           kn=(kn, f32, (P, na, nt)))
    return _gat_library(name, H), P, na, nt, H


def _gat1_aggregate_fwd_cuda(e, m_row, m_col, z_row, z_col, h_e, mask3, ka, kn, keep):
    args = (e, m_row, m_col, z_row, z_col, h_e, mask3, ka, kn)
    lib, P, na, nt, H = _aggregate_1h_inputs("gat1_aggregate_fwd", *args)
    rs = torch.empty(P, na, H, dtype=torch.float32, device=e.device)
    cs = torch.empty(P, nt, H, dtype=torch.float32, device=e.device)
    if P == 0 or na == 0 or nt == 0:
        return rs.zero_(), cs.zero_()
    scratch = _scratch(lib, e.device, 1, P, na, nt, 1, H, False)
    with torch.cuda.device(e.device):
        rc = lib.tm_gat1_aggregate_fwd(*(t.data_ptr() for t in args), rs.data_ptr(),
                                       cs.data_ptr(), scratch.data_ptr(), P, na, nt, H,
                                       float(keep), _stream())
    if rc != 0:
        raise RuntimeError(f"gat1_aggregate_fwd kernel launch failed: CUDA error {rc}")
    LAUNCHES["gat1_aggregate_fwd"] += 1
    return rs, cs


def _gat1_aggregate_bwd_cuda(e, m_row, m_col, z_row, z_col, h_e, mask3, ka, kn, keep,
                             g_rs, g_cs):
    args = (e, m_row, m_col, z_row, z_col, h_e, mask3, ka, kn)
    lib, P, na, nt, H = _aggregate_1h_inputs("gat1_aggregate_bwd", *args)
    _check("gat1_aggregate_bwd", e.device, g_rs=(g_rs, torch.float32, (P, na, H)),
           g_cs=(g_cs, torch.float32, (P, nt, H)))
    out = (torch.empty_like(e), torch.empty_like(m_row), torch.empty_like(m_col),
           torch.empty_like(z_row), torch.empty_like(z_col), torch.empty_like(h_e))
    if P == 0 or na == 0 or nt == 0:
        return tuple(t.zero_() for t in out)
    scratch = _scratch(lib, e.device, 1, P, na, nt, 1, H, True)
    with torch.cuda.device(e.device):
        rc = lib.tm_gat1_aggregate_bwd(*(t.data_ptr() for t in args), g_rs.data_ptr(),
                                       g_cs.data_ptr(), *(t.data_ptr() for t in out),
                                       scratch.data_ptr(), P, na, nt, H, float(keep), _stream())
    if rc != 0:
        raise RuntimeError(f"gat1_aggregate_bwd kernel launch failed: CUDA error {rc}")
    LAUNCHES["gat1_aggregate_bwd"] += 1
    return out


class GatScoresStats(torch.autograd.Function):
    """(e, rmax, cmax, sa_l, sb_l) = gat_scores_stats_reference(...), with
    the hand-derived backward; rmax and cmax are not differentiable."""

    @staticmethod
    def forward(ctx, ha, hn, a, mask3, alpha, nh):
        ctx.save_for_backward(ha, hn, a, mask3)
        ctx.alpha, ctx.nh = float(alpha), int(nh)
        fwd = _gat_scores_fwd_cuda if _on_cuda(ha) else gat_scores_stats_reference
        out = fwd(ha, hn, a, mask3, alpha, nh)
        ctx.mark_non_differentiable(out[1], out[2])
        return out

    @staticmethod
    def backward(ctx, ge, _grmax, _gcmax, gsal, gsbl):
        ha, hn, a, mask3 = ctx.saved_tensors
        nh = ctx.nh
        P, na, nt = mask3.shape
        ge = _zeros_if_none(ge, (nh, P, na, nt), ha.device)
        gsal = _zeros_if_none(gsal, (nh, P, na), ha.device)
        gsbl = _zeros_if_none(gsbl, (nh, P, nt), ha.device)
        bwd = _gat_scores_bwd_cuda if _on_cuda(ha) else gat_scores_stats_backward_reference
        dha, dhn, da = bwd(ha, hn, a, mask3, ctx.alpha, nh, ge, gsal, gsbl)
        return dha, dhn, da, None, None, None


class GatAggregate(torch.autograd.Function):
    """(rs, cs) = gat_aggregate_reference(...), with the hand-derived
    backward; the masks take no gradient."""

    @staticmethod
    def forward(ctx, e, m_row, m_col, z_row, z_col, h_e, mask3, ka, kn, keep):
        ctx.save_for_backward(e, m_row, m_col, z_row, z_col, h_e, mask3, ka, kn)
        ctx.keep = float(keep)
        fwd = _gat_aggregate_fwd_cuda if _on_cuda(e) else gat_aggregate_reference
        return fwd(e, m_row, m_col, z_row, z_col, h_e, mask3, ka, kn, keep)

    @staticmethod
    def backward(ctx, g_rs, g_cs):
        args = ctx.saved_tensors
        P, na, nt, H = args[5].shape
        g_rs = _zeros_if_none(g_rs, (P, na, H), args[0].device)
        g_cs = _zeros_if_none(g_cs, (P, nt, H), args[0].device)
        bwd = _gat_aggregate_bwd_cuda if _on_cuda(args[0]) else gat_aggregate_backward_reference
        return (*bwd(*args, ctx.keep, g_rs, g_cs), None, None, None, None)


class GatScoresStats1h(torch.autograd.Function):
    """(e, rmax, cmax, sa_l, sb_l) = gat_scores_stats_1h_reference(...),
    with the hand-derived backward; rmax and cmax are not differentiable."""

    @staticmethod
    def forward(ctx, ha, hn, a, mask3, alpha):
        ctx.save_for_backward(ha, hn, a, mask3)
        ctx.alpha = float(alpha)
        fwd = _gat1_scores_fwd_cuda if _on_cuda(ha) else gat_scores_stats_1h_reference
        out = fwd(ha, hn, a, mask3, alpha)
        ctx.mark_non_differentiable(out[1], out[2])
        return out

    @staticmethod
    def backward(ctx, ge, _grmax, _gcmax, gsal, gsbl):
        ha, hn, a, mask3 = ctx.saved_tensors
        P, na, nt = mask3.shape
        ge = _zeros_if_none(ge, (P, na, nt), ha.device)
        gsal = _zeros_if_none(gsal, (P, na), ha.device)
        gsbl = _zeros_if_none(gsbl, (P, nt), ha.device)
        bwd = _gat1_scores_bwd_cuda if _on_cuda(ha) else gat_scores_stats_1h_backward_reference
        dha, dhn, da = bwd(ha, hn, a, mask3, ctx.alpha, ge, gsal, gsbl)
        return dha, dhn, da, None, None


class GatScores(torch.autograd.Function):
    """e = gat_scores_reference(...), with the hand-derived backward; the
    mask takes no gradient."""

    @staticmethod
    def forward(ctx, ha, hn, a, mask3, alpha):
        ctx.save_for_backward(ha, hn, a, mask3)
        ctx.alpha = float(alpha)
        fwd = _gat0_scores_fwd_cuda if _on_cuda(ha) else gat_scores_reference
        return fwd(ha, hn, a, mask3, alpha)

    @staticmethod
    def backward(ctx, ge):
        ha, hn, a, mask3 = ctx.saved_tensors
        ge = _zeros_if_none(ge, tuple(mask3.shape), ha.device)
        bwd = _gat0_scores_bwd_cuda if _on_cuda(ha) else gat_scores_backward_reference
        dha, dhn, da = bwd(ha, hn, a, mask3, ctx.alpha, ge)
        return dha, dhn, da, None, None


class GatAggregate1h(torch.autograd.Function):
    """(rs, cs) = gat_aggregate_1h_reference(...), with the hand-derived
    backward; the masks take no gradient."""

    @staticmethod
    def forward(ctx, e, m_row, m_col, z_row, z_col, h_e, mask3, ka, kn, keep):
        ctx.save_for_backward(e, m_row, m_col, z_row, z_col, h_e, mask3, ka, kn)
        ctx.keep = float(keep)
        fwd = _gat1_aggregate_fwd_cuda if _on_cuda(e) else gat_aggregate_1h_reference
        return fwd(e, m_row, m_col, z_row, z_col, h_e, mask3, ka, kn, keep)

    @staticmethod
    def backward(ctx, g_rs, g_cs):
        args = ctx.saved_tensors
        P, na, nt, H = args[5].shape
        g_rs = _zeros_if_none(g_rs, (P, na, H), args[0].device)
        g_cs = _zeros_if_none(g_cs, (P, nt, H), args[0].device)
        bwd = (_gat1_aggregate_bwd_cuda if _on_cuda(args[0])
               else gat_aggregate_1h_backward_reference)
        return (*bwd(*args, ctx.keep, g_rs, g_cs), None, None, None, None)


def gat_scores_stats(ha, hn, a, mask3, alpha, nh):
    return GatScoresStats.apply(ha, hn, a, mask3, alpha, nh)


def gat_aggregate(e, m_row, m_col, z_row, z_col, h_e, mask3, ka, kn, keep):
    return GatAggregate.apply(e, m_row, m_col, z_row, z_col, h_e, mask3, ka, kn, keep)


def gat_scores_stats_1h(ha, hn, a, mask3, alpha):
    """One head's (e, rmax, cmax, sa_l, sb_l) (gat_scores_stats,
    pallas_gat.py:224), differentiable in ha, hn, a: ha [P, na, H], hn [P,
    nt, H], a [H, 1], mask3 [P, na, nt] f32 0/1.  rmax / cmax take no
    gradient (the caller stops the softmax shift)."""
    return GatScoresStats1h.apply(ha, hn, a, mask3, alpha)


def gat_scores(ha, hn, a, mask3, alpha):
    """The masked leaky-relu L1 scores (gat_scores, pallas_gat.py:78),
    differentiable in ha, hn, a: ha [P, na, H], hn [P, nt, H], a [H, 1],
    mask3 [P, na, nt] f32 0/1; e [P, na, nt], 0 where masked."""
    return GatScores.apply(ha, hn, a, mask3, alpha)


def gat_aggregate_1h(e, m_row, m_col, z_row, z_col, h_e, mask3, ka, kn, keep):
    """One head's (rs, cs) (gat_aggregate, pallas_gat.py:350), differentiable
    in e, the statistics and h_e: e, ka, kn [P, na, nt]; m_row, z_row [P,
    na]; m_col, z_col [P, nt]; h_e [P, na, nt, H]; the keep masks are read
    only when keep < 1."""
    return GatAggregate1h.apply(e, m_row, m_col, z_row, z_col, h_e, mask3, ka, kn, keep)
