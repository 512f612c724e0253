"""The decomposition of the port's fused edge-loss kernels
(trackmpnn_tpu_torch/csrc/loss_kernels.cu), on the CPU.

The kernels spread a block of P over many CTAs and sum in orders fixed by
the shapes:
  * edge_loss_l1: tiles of ROWS full rows; a cell's dot over L lanes (the
    power of two >= its K / 4 float4s, or K floats where K % 4 != 0, at
    most 32): lane l adds the elements l, l + L, ... (fmaf, x y z w), then
    an xor tree over the L lanes; the row statistics a warp a row, lanes
    over the columns, s_r per lane in column order, then an xor tree;
  * edge_loss_l2: a warp a column, lanes over the rows: the column's
    exp-sum per lane in row order and an xor tree, the per-cell terms in f64
    the same way, the columns of a CTA (L2_COLS of them) in column order,
    the CTAs of a block in tile order, rounded to f32 once;
  * edge_loss_bwd: the column statistics as L2 forms them (a launch of
    their own); tiles of ROWS rows: d logit a cell, the cells whose d logit
    is not 0 listed in order, thread (g, k) of G = 256 / n groups summing
    h_eo * d logit over the listed cells g, g + G, ... (fmaf), the groups
    added in order into the tile's partials row; d b_e per
    thread (cells t, t + 256, ...), an xor tree, the warps in order; the
    rows [P x tiles, K + 1] added by warp w of 32 over the rows w, w + 32,
    ..., then the warps in order.
Here that tiling and summation order are emulated in PyTorch (f32, fmaf in
f64 rounded once) and held against the JAX package's edge_losses in
interpret mode and its VJP with tests/test_torch_edge_losses.py's
tolerances (rtol 1e-4 / atol 1e-5, the counts exact), at a shape whose na
is not a multiple of ROWS and whose K % 4 != 0, and at K > 256 with nt >
L2_COLS (two column tiles).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import EDGE_LOSS_COUNTS, EDGE_LOSS_KEYS, edge_loss_inputs
from trackmpnn_tpu.ops.pallas_loss import edge_losses as jax_edge_losses
from trackmpnn_tpu_torch.losses.losses import EPS
from trackmpnn_tpu_torch.ops import loss

torch.set_num_threads(1)

ROWS, THREADS, L2_COLS, WARP = 8, 256, 32, 32
NEG, BIG = -1e30, float(1 << 30)


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


def fma(a, b, c):
    """fmaf(a, b, c): the product exact in f64, one rounding to f32."""
    return (a.double() * b.double() + c.double()).float()


def xor_tree(x):
    """The lanes' values [..., L] after an xor-shuffle tree (every lane ends
    with the same sum; lane 0's returned)."""
    L = x.shape[-1]
    off = L // 2
    while off:
        x = x + x[..., torch.arange(L) ^ off]
        off //= 2
    return x[..., 0]


def lane_sums(x, lanes=WARP):
    """Sums over the last axis as lanes over it: lane l adds elements l, l +
    lanes, ... in order from 0, then an xor tree (x's dtype throughout)."""
    n = x.shape[-1]
    pad = -n % lanes
    x = torch.cat([x, torch.zeros(*x.shape[:-1], pad, dtype=x.dtype)], -1)
    x = x.reshape(*x.shape[:-1], -1, lanes)
    acc = torch.zeros(*x.shape[:-2], lanes, dtype=x.dtype)
    for c in range(x.shape[-2]):
        acc = acc + x[..., c, :]
    return xor_tree(acc)


def lanes_for(n):
    L = 1
    while L < n and L < WARP:
        L *= 2
    return L


def rowid(ebnt, na, nt):
    ii = torch.arange(na, dtype=torch.float32)[None, :, None]
    jj = torch.arange(nt, dtype=torch.float32)[None, None, :]
    return (ebnt[:, 0, None, None] + ii * ebnt[:, 1, None, None]) + jj


def l1_emulated(h_eo, w_e, b_e, lbl, m3, ebnt):
    P, na, nt, K = h_eo.shape
    W = 4 if K % 4 == 0 else 1
    n = K // W
    L = lanes_for(n)
    h, w = h_eo.reshape(-1, n, W), w_e.reshape(n, W)
    acc = torch.zeros(h.shape[0], L)
    for k0 in range(0, n, L):
        ks = torch.arange(k0, min(n, k0 + L))
        lanes = ks - k0
        part = acc[:, lanes]
        for comp in range(W):
            part = fma(h[:, ks, comp], w[ks, comp], part)
        acc[:, lanes] = part
    m = m3.reshape(-1)
    logits = torch.where(m != 0, (xor_tree(acc) + b_e.reshape(())) * m, 0.0).reshape(P, na, nt)
    mb, pos = m3 > 0.5, lbl * m3 > 0.5
    r_min = torch.where(pos, rowid(ebnt, na, nt), BIG).amin(2)
    m_r = torch.where(mb, logits, NEG).amax(2)
    safe = torch.where(m_r > NEG / 2, m_r, 0.0)
    s_r = lane_sums(torch.where(mb, torch.exp(logits - safe[..., None]), 0.0))
    return logits, r_min, m_r, s_r


def column_stats(logits, lbl, m3, ebnt, sel1g):
    """column_stats: (max_i, sel_i, safe, s_col [P, nt]) and the per-cell
    part_b, tpos as the kernels form them, lanes over the rows."""
    P, na, nt = logits.shape
    ii = torch.arange(na)[None, :, None]
    mb, pos = m3 > 0.5, lbl * m3 > 0.5
    max_i = torch.where(pos, ii, -1).amax(1)
    mx = torch.where(mb, logits, NEG).amax(1)
    safe = torch.where(mx > NEG / 2, mx, 0.0)
    part_b = pos & (rowid(ebnt, na, nt) == sel1g[:, :, None])
    tpos = pos & ((ii == max_i[:, None, :]) | part_b)
    sel_i = torch.where(tpos, ii, -1).amax(1)
    e = torch.where(mb, torch.exp(logits - safe[:, None, :]), 0.0)
    s_col = lane_sums(e.transpose(1, 2))
    return max_i, sel_i, safe, s_col, part_b, tpos


def l2_emulated(logits, lbl, m3, ebnt, bna, sel1g, lsedg, sizedg):
    P, na, nt = logits.shape
    _, sel_i, safe, s_col, part_b, tpos = column_stats(logits, lbl, m3, ebnt, sel1g)
    mb = m3 > 0.5
    sg = torch.sigmoid(logits)
    ce_fut = torch.where(part_b, (lsedg[:, :, None] - logits)
                         / torch.clamp(sizedg[:, :, None], min=1.0), 0.0).double()
    bce = torch.where(mb, torch.log(torch.where(tpos, sg, 1.0 - sg) + EPS), 0.0).double()
    pred = (sg >= 0.5) & mb
    counts = [m3.double()] + [c.double() for c in (pred & tpos, pred & ~tpos, mb & ~pred & tpos)]
    cols = [lane_sums(t.transpose(1, 2)) for t in [ce_fut, bce] + counts]  # [P, nt] each
    has = sel_i >= 0
    sel_logit = torch.gather(logits, 1, sel_i.clamp(min=0)[:, None, :])[:, 0]
    lse = safe + torch.log(torch.clamp(s_col, min=1e-30))
    ce_past = torch.where(has, (lse - sel_logit) / torch.clamp(bna, min=1.0), 0.0).double()
    out = torch.zeros(P, 8, dtype=torch.float64)
    for t0 in range(0, nt, L2_COLS):  # a CTA's columns in order, the tiles in order
        tile = torch.zeros(P, 7, dtype=torch.float64)
        for j in range(t0, min(nt, t0 + L2_COLS)):
            tile = tile + torch.stack([ce_past[:, j]] + [c[:, j] for c in cols], 1)
        out[:, :7] = out[:, :7] + tile
    return out.float()


def bwd_emulated(h_eo, w_e, logits, lbl, m3, ebnt, bna, sel1g, lsedg, sizedg, wg, d_part):
    P, na, nt, K = h_eo.shape
    max_i, sel_i, safe, s_col, part_b, tpos = column_stats(logits, lbl, m3, ebnt, sel1g)
    ii = torch.arange(na)[None, :, None]
    mb = m3 > 0.5
    sel = tpos & (ii == sel_i[:, None, :])
    wcol = (sel_i >= 0).float() / torch.clamp(bna, min=1.0)
    d_cep, d_cef, d_bce = (d_part[:, c, None, None] for c in range(3))
    e_col = torch.where(mb, torch.exp(logits - safe[:, None, :]), 0.0)
    dl = d_cep * wcol[:, None, :] * (e_col / torch.clamp(s_col, min=1e-30)[:, None, :]
                                     - sel.float())
    soft_d = torch.where(mb, torch.exp(logits - lsedg[:, :, None]), 0.0)
    dl = dl + (wg[:, :, None] * soft_d
               - d_cef * part_b.float() / torch.clamp(sizedg[:, :, None], min=1.0))
    sg = torch.sigmoid(logits)
    pt = torch.where(tpos, sg, 1.0 - sg)
    dbce = torch.where(mb, torch.where(tpos, 1.0, -1.0) * sg * (1.0 - sg) / (pt + EPS), 0.0)
    dl = (dl + d_bce * dbce) * m3
    dheo = torch.where(dl[..., None] != 0, dl[..., None] * w_e.reshape(K), 0.0)
    # the tiles' partials rows: (block, tile of ROWS rows)
    W = 4 if K % 4 == 0 else 1
    n = K // W
    G = THREADS // n if n < THREADS else 1
    tiles = -(-na // ROWS)
    pad = tiles * ROWS - na
    hp = torch.cat([h_eo, torch.zeros(P, pad, nt, K)], 1).reshape(P * tiles, ROWS * nt, K)
    dlp = torch.cat([dl, torch.zeros(P, pad, nt)], 1).reshape(P * tiles, ROWS * nt)
    cells = ROWS * nt
    acc = torch.zeros(P * tiles, G, K)
    for t in range(P * tiles):  # group g's listed cells (d logit != 0) g, g + G, ... in order
        listed = (dlp[t] != 0).nonzero()[:, 0]
        for s in range(0, len(listed), G):
            c = listed[s:s + G]
            acc[t, :len(c)] = fma(hp[t, c], dlp[t, c, None], acc[t, :len(c)])
    rows = torch.zeros(P * tiles, K + 1)
    for g in range(G):
        rows[:, :K] = rows[:, :K] + acc[:, g]
    thread = torch.zeros(P * tiles, THREADS)  # d b_e: thread t's cells t, t + 256, ...
    for c0 in range(0, cells, THREADS):
        c = torch.arange(c0, min(cells, c0 + THREADS))
        thread[:, c - c0] = thread[:, c - c0] + dlp[:, c]
    warps = xor_tree(thread.reshape(P * tiles, THREADS // WARP, WARP))
    for w in range(THREADS // WARP):
        rows[:, K] = rows[:, K] + warps[:, w]
    nrows = P * tiles
    per_warp = torch.zeros(WARP, K + 1)
    for r in range(nrows):
        per_warp[r % WARP] = per_warp[r % WARP] + rows[r]
    dw = torch.zeros(K + 1)
    for w in range(WARP):
        dw = dw + per_warp[w]
    return dheo, dw[:K].reshape(K, 1), dw[K:].reshape(1, 1)


SHAPES = [dict(P=5, na=37, nt=29, K=50, nD=256), dict(P=3, na=9, nt=40, K=300, nD=64)]


@pytest.mark.parametrize("shape", SHAPES, ids=["ragged_rows_k50", "k300_two_column_tiles"])
def test_emulated_tiling_matches_interpret_mode_pallas(shape):
    """The emulated L1, glue, L2 against jax edge_losses' partials (counts
    exact); the emulated backward against its VJP; and each emulated kernel
    against the port's plain version."""
    x, d_part = edge_loss_inputs(3, **shape)
    rest = [jnp.asarray(x[k]) for k in EDGE_LOSS_KEYS[3:9]]
    want, vjp = jax.vjp(lambda h, w, b: jax_edge_losses(h, w, b, *rest, x["nD"], 4, True),
                        *(jnp.asarray(x[k]) for k in EDGE_LOSS_KEYS[:3]))
    h_eo, w_e, b_e, lbl, m3, ebnt, bna, act, act_m, nD = [
        torch.from_numpy(np.asarray(x[k])) if k != "nD" else x[k] for k in EDGE_LOSS_KEYS]
    l1 = l1_emulated(h_eo, w_e, b_e, lbl, m3, ebnt)
    for a, b in zip(l1, loss.edge_loss_l1_reference(h_eo, w_e, b_e, lbl, m3, ebnt)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    logits, r_min, m_r, s_r = l1
    glue = loss.edge_loss_glue(r_min, m_r, s_r, m3, ebnt, act, act_m, nD)
    got = l2_emulated(logits, lbl, m3, ebnt, bna, *glue)
    assert got[:, 3].sum() > 0 and got[:, 4:7].sum() > 0  # live cells and counts
    plain = loss.edge_loss_l2_reference(logits, lbl, m3, ebnt, bna, *glue)
    assert torch.equal(got[:, EDGE_LOSS_COUNTS], plain[:, EDGE_LOSS_COUNTS])
    torch.testing.assert_close(got, plain, rtol=0, atol=1e-5)
    got, want = got.numpy(), np.asarray(want)
    assert np.array_equal(got[:, EDGE_LOSS_COUNTS], want[:, EDGE_LOSS_COUNTS])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    dp = torch.from_numpy(d_part)
    wg = loss.edge_loss_spread(r_min, glue[0], glue[2], dp, act, act_m, nD)
    bargs = (h_eo, w_e, logits, lbl, m3, ebnt, bna, *glue, wg, dp)
    grads = bwd_emulated(*bargs)
    for name, a, b in zip(("h_eo", "w_e", "b_e"), grads, vjp(jnp.asarray(d_part))):
        b = np.asarray(b)
        assert np.abs(b).max() > 0, name
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-5, err_msg=name)
    for a, b in zip(grads, loss.edge_loss_bwd_reference(*bargs)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_lane_sums_and_tiles_cover_every_element_once():
    """The emulation's own bookkeeping: lane_sums adds every element once
    (exact on integers), and the backward's tiles pad na to a multiple of
    ROWS with cells whose d logit is 0."""
    x = torch.arange(1.0, 71.0).reshape(2, 35)
    assert torch.equal(lane_sums(x), x.sum(1))
    assert torch.equal(xor_tree(torch.ones(3, 16)), torch.full((3,), 16.0))
    assert lanes_for(12) == 16 and lanes_for(48) == 32 and lanes_for(1) == 1
