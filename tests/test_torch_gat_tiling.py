"""The summation order and the width rule of the port's attention kernels
(trackmpnn_tpu_torch/csrc/gat_kernels.cu: #11 gat_scores_*, #12
gat_aggregate_*, and #8-#10, which share their bodies), on the CPU.

The kernels tile each na x nt rectangle, so they take widths the first
design refused (its shared memory grew with na, nt and nh).  Here their
order of summation is emulated in PyTorch f32:

  * scores: bands of 32 rows, column tiles of 32; a tile's row and column
    (max, exp-sum) pairs, the rows' merged over the band's tiles in order,
    the columns' over the bands in order; d ha summed over the column tiles
    in order, d hn over the bands, d a over the tiles and then the blocks'
    and bands' partial rows, eight interleaved runs of rows summed in order;
  * aggregate: row tiles of 8, chunks of 32 columns; rs summed by each of a
    tile's 8 warps over its columns (c = w mod 8), then over the warps in
    order; cs over a tile's even and odd rows, then over the tiles in order;
    the backward's row sums over the chunks, its column sums over a tile's
    rows and then the tiles, d h_e from the head-summed weights.

and held against the JAX package's gat_scores_stats_mh and gat_aggregate_mh
in interpret mode (as tests/test_pallas_gat.py runs them), forward and VJP,
at widths the first design refused, with tests/test_torch_gat_ops.py's
tolerances: forwards atol 1e-5, gradients rtol 1e-4 and atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import gat_inputs
from trackmpnn_tpu.ops import pallas_gat
from trackmpnn_tpu_torch.ops import _build, gat

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


ALPHA = 0.2
FWD = dict(rtol=0, atol=1e-5)
BWD = dict(rtol=1e-4, atol=1e-5)
BAND = TILE = 32    # the score kernels' band of rows and column tile
ROWS, COLS = 8, 32  # the aggregate kernels' row tile and column chunk
NEG = gat.NEG_SCORE


def merge(M, S, m, s):
    """The kernels' merge of two (max, exp-sum) pairs."""
    M2 = torch.maximum(M, m)
    return M2, S * torch.exp(M - M2) + s * torch.exp(m - M2)


def line_stats(e_m, m, dim):
    """(max, exp-sum) of a tile's rows (dim -1) or columns (dim -2)."""
    mt = e_m.amax(dim, keepdim=True)
    return mt.squeeze(dim), (m * torch.exp(e_m - mt)).sum(dim)


def partial_rows_sum(part):
    """The d a partial rows [Q, W] summed as the kernel does: warp w the rows
    w, w + 8, ... in order, then the 8 warps in order."""
    acc = [torch.zeros(part.shape[1]) for _ in range(8)]
    for q in range(part.shape[0]):
        acc[q % 8] = acc[q % 8] + part[q]
    out = acc[0]
    for w in range(1, 8):
        out = out + acc[w]
    return out


def tiled_scores(ha, hn, a, m3, nh, cot=None):
    """gat_scores_stats_mh's (e, rmax, cmax, sa_l, sb_l) in the kernels'
    order; with cot = (ge, gsal, gsbl) also (d ha, d hn, d a)."""
    P, na, HH = ha.shape
    nt, H = hn.shape[1], HH // nh
    d, pm, e, e_m = gat._scores(ha, hn, a, m3, ALPHA, nh)  # [nh, P, na, nt(, H)]
    m = m3[None].expand_as(e)
    bands = range(0, na, BAND)
    tiles = range(0, nt, TILE)
    rmax, sal = torch.empty(nh, P, na), torch.empty(nh, P, na)
    cparts = []
    for i0 in bands:
        rows = slice(i0, i0 + BAND)
        M = torch.full((nh, P, min(BAND, na - i0)), NEG)
        S = torch.zeros_like(M)
        cm, cs = [], []
        for j0 in tiles:
            cols = slice(j0, j0 + TILE)
            mt, st = line_stats(e_m[:, :, rows, cols], m[:, :, rows, cols], -1)
            M, S = merge(M, S, mt, st)
            mt, st = line_stats(e_m[:, :, rows, cols], m[:, :, rows, cols], -2)
            cm.append(mt)
            cs.append(st)
        rmax[:, :, rows], sal[:, :, rows] = M, S
        cparts.append((torch.cat(cm, -1), torch.cat(cs, -1)))
    cmax, sbl = cparts[0]
    if len(cparts) > 1:  # merge_col_stats_kernel: from (NEG, 0), in band order
        cmax, sbl = torch.full_like(cmax, NEG), torch.zeros_like(sbl)
        for cm, cs in cparts:
            cmax, sbl = merge(cmax, sbl, cm, cs)
    fwd = (e, rmax, cmax, sal, sbl)
    if cot is None:
        return fwd
    ge, gsal, gsbl = cot
    de = (ge + gsal[..., None] * m * torch.exp(e_m - rmax[..., None])
          + gsbl[:, :, None, :] * m * torch.exp(e_m - cmax[:, :, None, :]))
    dpre = torch.where(m != 0, de * torch.where(pm >= 0, 1.0, ALPHA) * m, 0.0)
    t = dpre[..., None] * torch.sign(d)                   # [nh, P, na, nt, H]
    w = a.reshape(nh, 1, 1, H)
    dha = torch.zeros(nh, P, na, H)
    dhn_bands, da_rows = [], torch.zeros(P, len(bands), nh, H)
    for b, i0 in enumerate(bands):
        rows = slice(i0, i0 + BAND)
        for j0 in tiles:  # d ha and d a over the band's tiles in order
            cols = slice(j0, j0 + TILE)
            dha[:, :, rows] = dha[:, :, rows] + w * t[:, :, rows, cols].sum(3)
            da_rows[:, b] += (d[:, :, rows, cols].abs() * dpre[:, :, rows, cols, None]
                              ).sum((2, 3)).permute(1, 0, 2)
        dhn_bands.append(w * t[:, :, rows].sum(2))
    dhn = torch.zeros(nh, P, nt, H)
    for part in dhn_bands:  # sum_tiles_kernel, in band order
        dhn = dhn + part
    da = partial_rows_sum(da_rows.reshape(P * len(bands), nh * H))
    return fwd, (gat._unheads(dha), gat._unheads(-dhn), da.reshape(-1, 1))


def tiled_aggregate(e, m_row, m_col, z_row, z_col, h_e, m3, ka, kn, keep, cot=None):
    """gat_aggregate_mh's (rs, cs) in the kernels' order; with cot = (g_rs,
    g_cs) also (d e, d m_row, d m_col, d z_row, d z_col, d h_e)."""
    P, na, nt, H = h_e.shape
    att_a, att_n = gat._attention(e, m_row, m_col, z_row, z_col, m3, ka, kn, keep)
    wa, wn = att_a.sum(0), att_n.sum(0)  # the head sums, heads in order
    tiles = range(0, na, ROWS)
    chunks = range(0, nt, COLS)
    rs = torch.zeros(P, na, H)
    cs_tiles = []
    for i0 in tiles:
        rows = slice(i0, i0 + ROWS)
        warp_rs = [torch.zeros(P, min(ROWS, na - i0), H) for _ in range(8)]
        cs_t = torch.zeros(P, nt, H)
        for j0 in chunks:
            for c in range(j0, min(j0 + COLS, nt)):
                v = h_e[:, rows, c]                                       # [P, rows, H]
                w = (c - j0) % 8
                warp_rs[w] = warp_rs[w] + wa[:, rows, c, None] * v
                part = wn[:, rows, c, None] * v
                cs_t[:, c] = part[:, 0::2].sum(1) + part[:, 1::2].sum(1)
        acc = warp_rs[0]
        for w in range(1, 8):
            acc = acc + warp_rs[w]
        rs[:, rows] = acc
        cs_tiles.append(cs_t)
    cs = cs_tiles[0]
    if len(cs_tiles) > 1:  # sum_tiles_kernel, in tile order
        cs = torch.zeros_like(cs)
        for part in cs_tiles:
            cs = cs + part
    if cot is None:
        return rs, cs
    g_rs, g_cs = cot
    datt_a = (h_e * g_rs[:, :, None, :]).sum(-1)
    datt_n = (h_e * g_cs[:, None, :, :]).sum(-1)
    pa, pn = datt_a * att_a, datt_n * att_n
    de = pa + pn
    s_a = torch.zeros(pa.shape[:3])
    for j0 in chunks:  # the row sums of each chunk, accumulated over the chunks
        s_a = s_a + pa[..., j0:j0 + COLS].sum(-1)
    col_tiles = [pn[:, :, i0:i0 + ROWS].sum(2) for i0 in tiles]
    s_n = col_tiles[0]
    if len(col_tiles) > 1:  # agg_col_finish_kernel, in tile order
        s_n = torch.zeros_like(s_n)
        for part in col_tiles:
            s_n = s_n + part
    dhe = wa[..., None] * g_rs[:, :, None, :] + wn[..., None] * g_cs[:, None, :, :]
    dhe = torch.where(m3[..., None] != 0, dhe, 0.0)
    return (rs, cs), (de, -s_a, -s_n, -s_a / torch.clamp(z_row, min=gat.Z_FLOOR),
                      -s_n / torch.clamp(z_col, min=gat.Z_FLOOR), dhe)


def close(got, want, tol, names):
    for a, b, name in zip(got, want, names):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), err_msg=name, **tol)


# P 2 na = nt = 80: both backwards of the first design refused it at 3 heads
# and H 64 (three bands' worth of score tiles at 32, ten aggregate row tiles);
# na 16, nt 120: four column tiles a band, one band, two row tiles
WIDE = [(2, 80, 80, 3, 16), (2, 16, 120, 3, 16)]


@pytest.mark.parametrize("P,na,nt,nh,H", WIDE, ids=["80x80", "16x120"])
def test_tiled_scores_match_pallas_interpret(P, na, nt, nh, H):
    x = gat_inputs(na + nt, nh, P=P, na=na, nt=nt, H=H)
    (ha, hn, a, m), cot = x["scores"], x["scores_cot"]
    f = lambda p, q, w: pallas_gat.gat_scores_stats_mh(p, q, w, jnp.asarray(m), ALPHA, nh, 4, True)
    want, pull = jax.vjp(f, jnp.asarray(ha), jnp.asarray(hn), jnp.asarray(a))
    zeros = [jnp.zeros_like(want[1]), jnp.zeros_like(want[2])]
    want_b = pull((jnp.asarray(cot[0]), *zeros, jnp.asarray(cot[1]), jnp.asarray(cot[2])))
    got, got_b = tiled_scores(*map(torch.from_numpy, (ha, hn, a, m)), nh,
                              [torch.from_numpy(c) for c in cot])
    close(got, want, FWD, ["e", "rmax", "cmax", "sa_l", "sb_l"])
    close(got_b, want_b, BWD, ["dha", "dhn", "da"])


@pytest.mark.parametrize("P,na,nt,nh,H", WIDE, ids=["80x80", "16x120"])
def test_tiled_aggregate_matches_pallas_interpret(P, na, nt, nh, H):
    keep = 0.5
    x = gat_inputs(na * nt, nh, keep, P=P, na=na, nt=nt, H=H)
    args, cot = x["agg"], x["agg_cot"]
    m, ka, kn = (jnp.asarray(t) for t in args[6:])
    f = lambda *d: pallas_gat.gat_aggregate_mh(*d, m, ka, kn, keep, nh, 4, True)
    want, pull = jax.vjp(f, *(jnp.asarray(t) for t in args[:6]))
    want_b = pull(tuple(jnp.asarray(c) for c in cot))
    t = [torch.from_numpy(v) for v in args]
    got, got_b = tiled_aggregate(*t, keep, [torch.from_numpy(c) for c in cot])
    close(got, want, FWD, ["rs", "cs"])
    close(got_b, want_b, BWD, ["de", "dm_row", "dm_col", "dz_row", "dz_col", "dhe"])


SMEM_OPTIN = 232448  # the H100's shared memory a block can opt in to


def first_design_smem(kind, na, nt, nh, H, backward):
    """Bytes of shared memory a CTA of the first design needed (its
    tm_gat_smem_bytes): the scores (kind 0) held the block's ha / hn rows,
    mask and scores, the aggregate (kind 1) every head's weights."""
    ncell = na * nt
    if kind == 0:
        f = (na + nt) * (H + 1) + H + 2 * ncell
        if backward:
            f += (na + nt) + ncell + na * H
    else:
        f = ncell if not backward else (na + nt) * H + 2 * ncell + 2 * nh * ncell
    return 4 * f


# (kernel, kind, na = nt, nh, H): the widths the first design refused
REFUSED = [("gat_aggregate_bwd", 1, 80, 3, 64), ("gat_aggregate_bwd", 1, 72, 3, 128),
           ("gat_aggregate_bwd", 1, 56, 8, 64), ("gat_scores_bwd", 0, 112, 1, 64),
           ("gat_scores_bwd", 0, 96, 3, 128), ("gat1_scores_bwd", 0, 112, 1, 64)]


@pytest.mark.parametrize("name,kind,n,nh,H", REFUSED)
def test_width_rule_takes_what_the_first_design_refused(monkeypatch, name, kind, n, nh, H):
    assert first_design_smem(kind, n, n, nh, H, True) > SMEM_OPTIN
    gat.attention_widths.cache_clear()
    monkeypatch.setattr(_build, "load", lambda lib: f"lib{lib}")
    assert gat.attention_widths(H) == H
    assert gat._gat_library(name, H) == "libgat"  # checked, then the library loaded


@pytest.mark.parametrize("H", [-1, gat.C_INT_MAX + 1])
def test_width_rule_refuses_other_widths_by_name(H):
    with pytest.raises(ValueError, match=f"H={H}"):
        gat.attention_widths(H)
    # the wrappers' check names the kernel too, before any library is built
    with pytest.raises(ValueError, match=f"gat_aggregate_bwd: .*H={H}"):
        gat._gat_library("gat_aggregate_bwd", H)


def test_width_rule_is_evaluated_once_per_width():
    gat.attention_widths.cache_clear()
    for _ in range(3):
        gat.attention_widths(64)
        gat.attention_widths(128)
    info = gat.attention_widths.cache_info()
    assert (info.misses, info.hits) == (2, 4)
