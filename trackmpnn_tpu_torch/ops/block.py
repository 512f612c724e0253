"""Ops of the block train step (the counterpart of
trackmpnn_tpu/ops/pallas_block.py's fused_block_round, fused_block_round_es,
window_scatter and window_gather2).

Each op has
  * a plain PyTorch version (`*_reference`), the semantics the tests hold
    against the JAX package and the version a CPU tensor gets;
  * an autograd Function whose forward and backward, for a CUDA tensor,
    check their inputs and launch the hand-written kernels in
    csrc/block_kernels.cu, or raise.  They never fall back to the plain
    version on the card;
  * a launch counter, LAUNCHES[name], raised by one where a kernel is
    launched and nowhere else.

Layout (step-major blocks, as in train/block.py): block p belongs to window
p % B, and a detection's row in the [B*capD, F] detection layout is
(p % B) * capD + its window-local id.  Window-local ids are int32 here; the
JAX package carries them as f32 only so that its custom VJP has float
cotangent slots.

The es round (fused_block_round_es) finds a detection's incident rows and
columns in the batch's detection incidence (block_incidence), built once per
batch on the host: for detection d, the slots q*(na + nt) + i of the rows i
of blocks q where d is active and q*(na + nt) + na + j of the columns j of
blocks q where d is new, in increasing order, so that a round over the first
P blocks reads each list up to its first slot >= P*(na + nt).

The window_scatter kernel is a pull over the same incidence: the es sum
(window_scatter(..., inc=)) and the backward of window_gather2 (both
cotangents in one launch) read each detection's rows and columns in list
order.  The incidence lists only rows and columns of blocks with cells;
every caller's values are exactly 0 at the other positions (masked round
sums, their cotangents, attention at padded cells).  Without an incidence
the CUDA wrapper builds the full one of the ids on the device for the call
(window_incidence).  BUILDS[name] counts the incidence builds.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from trackmpnn_tpu_torch.ops import _build

LAUNCHES = {"block_round_fwd": 0, "block_round_bwd": 0, "window_scatter": 0,
            "block_round_es_fwd": 0, "block_round_es_bwd": 0,
            "block_round_fwd_bf16": 0, "block_round_bwd_bf16": 0}
BUILDS = {"block_incidence": 0, "window_incidence": 0}


# -------------------------------------------------------------- references ----
def _up(x):
    """x in f32 where it is bf16, else x itself (f32, or f64 in the tests)."""
    return x.float() if x.dtype == torch.bfloat16 else x


def _mm(x, w, lp):
    """x @ w; with lp (the bf16 round) both operands rounded to bf16 and
    the products summed in f32 (pallas_block.py:94, nn.matmul_lp)."""
    if lp:
        return x.bfloat16().float() @ w.bfloat16().float()
    return x @ w


def _gates(he_m, ga, gb, w_hh, b_hh, sign, lp=False):
    """GRU gates of the edge rectangle, torch order r | z | n
    (pallas_block.py:104-120); he_m is the masked f32 h_e [P, na, nt, H],
    ga / gb f32 (upcast where the round streams them in bf16)."""
    P, na, nt, H = he_m.shape
    gh = _mm(he_m.reshape(-1, H), w_hh, lp).reshape(P, na, nt, 3 * H) + b_hh
    gi = ga[:, :, None, :] + sign * gb[:, None, :, :]
    r = torch.sigmoid(gi[..., :H] + gh[..., :H])
    z = torch.sigmoid(gi[..., H:2 * H] + gh[..., H:2 * H])
    ghn = gh[..., 2 * H:]
    n = torch.tanh(gi[..., 2 * H:] + r * ghn)
    return r, z, n, ghn


def block_round_reference(h_e, ga, gb, w_hh, b_hh, w_eb, mask3, sign):
    """(edge_out, rs, cs, lg) of one round (reference_block_round,
    pallas_block.py:710):

        he_m     = mask * h_e
        gh       = he_m @ w_hh + b_hh
        gi[i, j] = ga[i] + sign * gb[j]
        edge_out = mask * ((1 - z) * n + z * he_m)
        rs, cs   = row / column sums of he_m
        lg       = edge_out @ w_eb

    h_e [P,na,nt,H]; ga [P,na,3H]; gb [P,nt,3H]; w_hh [H,3H]; b_hh [3H];
    w_eb [H,1]; mask3 [P,na,nt] f32 0/1; sign +-1 ('diff' = -1).

    The bf16 round (h_e, ga and gb bf16; the JAX round with mm_dtype
    bf16): he_m = f32(h_e) * mask, gh's product with both operands rounded
    to bf16 and summed in f32, the gates in f32 from the upcast ga / gb,
    edge_out stored in bf16, lg from the f32 edge_out before that rounding,
    rs / cs f32 sums of he_m.  The rest f32."""
    lp = h_e.dtype == torch.bfloat16
    m = mask3[..., None]
    he_m = _up(h_e) * m
    r, z, n, _ = _gates(he_m, _up(ga), _up(gb), w_hh, b_hh, sign, lp)
    eo = ((1.0 - z) * n + z * he_m) * m
    lg = (eo @ w_eb)[..., 0]
    return eo.to(h_e.dtype), he_m.sum(2), he_m.sum(1), lg


def block_round_backward_reference(h_e, ga, gb, w_hh, b_hh, w_eb, mask3, sign,
                                   g_eo, g_rs, g_cs, g_lg):
    """The hand-derived backward of the round (_bwd_kernel,
    pallas_block.py:140-188): recomputes the gates from the inputs and
    returns (d h_e, d ga, d gb, d w_hh, d b_hh, d w_eb).  The bf16 round
    also rounds both operands of d gh @ w_hh^T and he_m^T @ d gh to bf16
    (f32 sums) and writes d h_e, d ga and d gb in bf16 (:159-166); d w_hh,
    d b_hh and d w_eb stay f32."""
    P, na, nt, H = h_e.shape
    lp = h_e.dtype == torch.bfloat16
    m = mask3[..., None]
    he_m = _up(h_e) * m
    r, z, n, ghn = _gates(he_m, _up(ga), _up(gb), w_hh, b_hh, sign, lp)
    # d(masked edge_out): the direct cotangent + the head's g_lg (x) w_eb
    go = (_up(g_eo) + g_lg[..., None] * w_eb.reshape(1, 1, 1, H)) * m
    eo = ((1.0 - z) * n + z * he_m) * m
    dweb = (eo * g_lg[..., None]).reshape(-1, H).sum(0)[:, None]
    dz = go * (he_m - n)
    dpre_n = go * (1.0 - z) * (1.0 - n * n)
    dpre_r = dpre_n * ghn * r * (1.0 - r)
    dpre_z = dz * z * (1.0 - z)
    dgh = torch.cat([dpre_r, dpre_z, dpre_n * r], dim=-1)
    dgi = torch.cat([dpre_r, dpre_z, dpre_n], dim=-1)
    dhe_m = (go * z + _mm(dgh.reshape(-1, 3 * H), w_hh.t(), lp).reshape(P, na, nt, H)
             + g_rs[:, :, None, :] + g_cs[:, None, :, :])
    dhe = (dhe_m * m).to(h_e.dtype)
    dga = dgi.sum(2).to(ga.dtype)
    dgb = (sign * dgi.sum(1)).to(gb.dtype)
    dwhh = _mm(he_m.reshape(-1, H).t(), dgh.reshape(-1, 3 * H), lp)
    dbhh = dgh.reshape(-1, 3 * H).sum(0)
    return dhe, dga, dgb, dwhh, dbhh, dweb


def global_idx(idx_l, B, capD):
    """Detection-layout row of window-local id idx_l[p, i]: (p % B)*capD + id
    (_global_idx, pallas_block.py:632)."""
    P = idx_l.shape[0]
    w = torch.arange(P, device=idx_l.device) % B
    return w[:, None] * capD + idx_l.long()


def window_scatter_reference(vals, idx_l, B, capD):
    """Sum vals[p, i] into row (p % B)*capD + idx_l[p, i] of a [B*capD, F]
    f32 output.  No mask: the callers' padded positions carry zeros.  Sums
    run in f64 and round to f32 once, so the result does not depend on the
    order the rows are added in."""
    F = vals.shape[-1]
    acc = torch.zeros(B * capD, F, dtype=torch.float64, device=vals.device)
    acc.index_add_(0, global_idx(idx_l, B, capD).reshape(-1), vals.reshape(-1, F).double())
    return acc.to(torch.float32)


def window_gather2_reference(ga_d, gb_d, act_l, new_l, B, capD):
    """(ga_d[act], gb_d[new]) per block (_wgather2_fwd, pallas_block.py:688)."""
    return ga_d[global_idx(act_l, B, capD)], gb_d[global_idx(new_l, B, capD)]


def block_incidence(act, new, blk_na, blk_nt, n_rows):
    """The detection incidence of a batch's blocks, numpy (see the module
    note).  act int[P, na] / new int[P, nt] global detection ids of each
    block's rows and columns, in the order the rounds see the blocks;
    blk_na / blk_nt int[P].  Only rows and columns of blocks with at least
    one cell are listed; the rest carry no edge.  Returns (inc_ptr
    int32[n_rows + 1], inc_slot int32[n]): detection d's slots are
    inc_slot[inc_ptr[d]:inc_ptr[d+1]], increasing."""
    act, new = np.asarray(act), np.asarray(new)
    blk_na, blk_nt = np.asarray(blk_na), np.asarray(blk_nt)
    na, nt = act.shape[1], new.shape[1]
    width = na + nt
    cells = (blk_na > 0) & (blk_nt > 0)
    qa, ia = np.nonzero((np.arange(na)[None, :] < blk_na[:, None]) & cells[:, None])
    qc, jc = np.nonzero((np.arange(nt)[None, :] < blk_nt[:, None]) & cells[:, None])
    dets = np.concatenate([act[qa, ia], new[qc, jc]]).astype(np.int64)
    slots = np.concatenate([qa * width + ia, qc * width + na + jc]).astype(np.int64)
    if np.any((dets < 0) | (dets >= n_rows)):
        raise ValueError("a block names a detection outside the batch")
    order = np.lexsort((slots, dets))
    ptr = np.zeros(n_rows + 1, np.int64)
    ptr[1:] = np.cumsum(np.bincount(dets, minlength=n_rows))
    BUILDS["block_incidence"] += 1
    return ptr.astype(np.int32), slots[order].astype(np.int32)


def window_incidence(idx_l, B, capD):
    """The full incidence of window-local ids idx_l [P, n] on their device:
    for row d = (p % B)*capD + idx_l[p, i], the slots p*n + i of every
    position, increasing; a fixed sequence of tensor ops (a stable sort and
    a search; no host synchronisation).  An id outside [0, capD) is not
    listed (the kernel traps on it).  Returns (ptr int32[B*capD + 1], slot
    int32[P*n])."""
    P, n = idx_l.shape
    if P * n >= 2 ** 31 or B * capD >= 2 ** 31 - 1:
        raise ValueError(f"window_incidence: P * n = {P * n} overflows the int32 slots")
    dev = idx_l.device
    ok = (idx_l >= 0) & (idx_l < capD)
    dest = (torch.arange(P, device=dev, dtype=torch.int32) % B * capD)[:, None] + idx_l
    key = torch.where(ok, dest, B * capD).reshape(-1).to(torch.int32)
    skey, slot = torch.sort(key, stable=True)
    ptr = torch.searchsorted(skey, torch.arange(B * capD + 1, device=dev, dtype=torch.int32),
                             out_int32=True)
    BUILDS["window_incidence"] += 1
    return ptr, slot.to(torch.int32)


def incidence_sum_reference(src_a, src_b, inc_ptr, inc_slot, n_rows):
    """Per detection row d, the f64 sums of its incidence entries of the
    first P = src_a.shape[0] blocks: (rows, columns) = (sum of src_a[q, i],
    sum of src_b[q, j]), as two f64 [n_rows, F] tensors.  src_a [P, na, F],
    src_b [P, nt, F] (na or nt may be 0).  With the window_scatter kernel's
    incidences this is its plain version: vals [P, n, F] as src_a and an
    empty src_b for the es sum, d ga and d gb for window_gather2's
    backward."""
    P, na, F = src_a.shape
    nt = src_b.shape[1]
    dev = src_a.device
    slot = inc_slot.long()
    owner = torch.repeat_interleave(torch.arange(n_rows, device=dev),
                                    (inc_ptr[1:] - inc_ptr[:-1]).long(),
                                    output_size=slot.numel())
    q, r = slot // (na + nt), slot % (na + nt)
    live = q < P
    is_row = r < na
    qc = torch.where(live, q, 0)
    side = lambda src, i, w: (src[qc, i].double() if w else
                              torch.zeros(slot.numel(), F, dtype=torch.float64, device=dev))
    va = side(src_a, torch.where(is_row, r, 0), na)
    vb = side(src_b, torch.where(is_row, 0, r - na), nt)
    zero = va.new_zeros(())
    va = torch.where((live & is_row)[:, None], va, zero)
    vb = torch.where((live & ~is_row)[:, None], vb, zero)
    out = torch.zeros(2, n_rows, F, dtype=torch.float64, device=dev)
    return out[0].index_add_(0, owner, va), out[1].index_add_(0, owner, vb)


def block_round_es_reference(h_e, act_l, new_l, ga_d, gb_d, b_ih, w_hh, b_hh, w_eb, mask3,
                             sign, B, capD, inc_ptr, inc_slot):
    """(edge_out, lg, es) of the es round (fused_block_round_es,
    pallas_block.py:485): the round of block_round_reference on the gathered
    gates ga = ga_d[act] + b_ih, gb = gb_d[new], and es [B*capD, H] = the
    row sums of each detection's active rows minus the column sums of its
    new columns, summed over the incidence in f64 and rounded once."""
    ga, gb = window_gather2_reference(ga_d, gb_d, act_l, new_l, B, capD)
    eo, rs, cs, lg = block_round_reference(h_e, ga + b_ih, gb, w_hh, b_hh, w_eb, mask3, sign)
    rows, cols = incidence_sum_reference(rs, cs, inc_ptr, inc_slot, B * capD)
    return eo, lg, (rows - cols).to(torch.float32)


def block_round_es_backward_reference(h_e, act_l, new_l, ga_d, gb_d, b_ih, w_hh, b_hh, w_eb,
                                      mask3, sign, B, capD, inc_ptr, inc_slot, g_eo, g_lg,
                                      g_es):
    """The hand-derived backward of the es round (_es_bwd_kernel,
    pallas_block.py:382-481): the round's backward with the cotangents of
    the row and column sums d es[act_i] and -d es[new_j], then the per-block
    gate cotangents summed into the detection layout over the incidence.
    Returns (d h_e, d ga_d, d gb_d, d b_ih, d w_hh, d b_hh, d w_eb)."""
    ga, gb = window_gather2_reference(ga_d, gb_d, act_l, new_l, B, capD)
    des_act, des_new = window_gather2_reference(g_es, g_es, act_l, new_l, B, capD)
    dhe, dga, dgb, dwhh, dbhh, dweb = block_round_backward_reference(
        h_e, ga + b_ih, gb, w_hh, b_hh, w_eb, mask3, sign, g_eo, des_act, -des_new, g_lg)
    dga_d, dgb_d = incidence_sum_reference(dga, dgb, inc_ptr, inc_slot, B * capD)
    return (dhe, dga_d.to(torch.float32), dgb_d.to(torch.float32), dga.sum((0, 1)), dwhh, dbhh,
            dweb)


# ---------------------------------------------------------------- wrappers ----
def _on_cuda(t):
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return True


def _check(name, device, **tensors):
    """Every tensor: on `device`, its dtype, its shape, contiguous."""
    for label, (t, dtype, shape) in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {label} is on {t.device}, expected {device}")
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise TypeError(f"{name}: {label} must be {dtype}{list(shape)}, "
                            f"got {t.dtype}{list(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} is not contiguous")


def _stream():
    return torch.cuda.current_stream().cuda_stream


ROUND_WIDTHS = range(8, 257, 8)  # the hidden widths the round kernels take


@functools.lru_cache(maxsize=None)
def round_widths(na, nt, H):
    """The round kernels' width rule, checked once for each (na, nt, H):
    H a multiple of 8 from 8 to 256 and any na, nt >= 0 (the kernels'
    shared memory depends on H alone).  Raises ValueError naming the width
    it refuses; JAX's Pallas kernel keeps w_hh in VMEM and takes any H."""
    if H not in ROUND_WIDTHS:
        raise ValueError(f"the block round kernels take a hidden width H that is a multiple "
                         f"of 8 from 8 to 256, not H={H}")
    if na < 0 or nt < 0:
        raise ValueError(f"the block round kernels take na, nt >= 0, not na={na}, nt={nt}")
    return na, nt, H


def _round_library(name, na, nt, H):
    """The block library, once these widths pass round_widths."""
    try:
        round_widths(na, nt, H)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    return _build.load("block")


def _round_scratch(P, na, nt, H, rsum_width, device):
    """The backward's scratch: d gh of each cell (5H floats), d w_hh's
    partials (one row a block and split of its cells, at most 3 tiles of 64
    cells a split) and the sums of every 4 rows for the biases' gradients."""
    tiles = -(-na * nt // 64)
    ksplit = -(-tiles // 3)
    f32 = torch.float32
    return (torch.empty(P * na * nt * 5 * H, dtype=f32, device=device),
            torch.empty(P * ksplit, 3 * H * H, dtype=f32, device=device),
            torch.empty(P * -(-na // 4), rsum_width, dtype=f32, device=device), ksplit)


def _round_inputs(name, h_e, ga, gb, w_hh, b_hh, w_eb, mask3):
    """The library, P, na, nt, H and the entry points' suffix: "" for the
    f32 round, "_bf16" for the bf16 one (h_e, ga and gb bf16)."""
    if h_e.dim() != 4:
        raise TypeError(f"{name}: h_e must be [P, na, nt, H], got {list(h_e.shape)}")
    P, na, nt, H = h_e.shape
    f32, dt = torch.float32, h_e.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: h_e must be f32 or bf16, got {dt}")
    _check(name, h_e.device, h_e=(h_e, dt, (P, na, nt, H)), ga=(ga, dt, (P, na, 3 * H)),
           gb=(gb, dt, (P, nt, 3 * H)), w_hh=(w_hh, f32, (H, 3 * H)),
           b_hh=(b_hh, f32, (3 * H,)), w_eb=(w_eb, f32, (H, 1)),
           mask3=(mask3, f32, (P, na, nt)))
    suffix = "_bf16" if dt == torch.bfloat16 else ""
    return _round_library(name + suffix, na, nt, H), P, na, nt, H, suffix


def _block_round_fwd_cuda(h_e, ga, gb, w_hh, b_hh, w_eb, mask3, sign):
    lib, P, na, nt, H, sfx = _round_inputs("block_round_fwd", h_e, ga, gb, w_hh, b_hh, w_eb,
                                           mask3)
    eo = torch.empty_like(h_e)
    rs = torch.empty(P, na, H, dtype=torch.float32, device=h_e.device)
    cs = torch.empty(P, nt, H, dtype=torch.float32, device=h_e.device)
    lg = torch.empty(P, na, nt, dtype=torch.float32, device=h_e.device)
    if P == 0 or na == 0 or nt == 0:
        return eo.zero_(), rs.zero_(), cs.zero_(), lg.zero_()
    with torch.cuda.device(h_e.device):
        rc = getattr(lib, "tm_block_round_fwd" + sfx)(
            h_e.data_ptr(), ga.data_ptr(), gb.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
            w_eb.data_ptr(), mask3.data_ptr(), eo.data_ptr(), rs.data_ptr(), cs.data_ptr(),
            lg.data_ptr(), P, na, nt, H, float(sign), _stream())
    if rc != 0:
        raise RuntimeError(f"block_round_fwd{sfx} kernel launch failed: CUDA error {rc}")
    LAUNCHES["block_round_fwd" + sfx] += 1
    return eo, rs, cs, lg


def _block_round_bwd_cuda(h_e, ga, gb, w_hh, b_hh, w_eb, mask3, sign, g_eo, g_rs, g_cs, g_lg):
    lib, P, na, nt, H, sfx = _round_inputs("block_round_bwd", h_e, ga, gb, w_hh, b_hh, w_eb,
                                           mask3)
    f32 = torch.float32
    _check("block_round_bwd" + sfx, h_e.device, g_eo=(g_eo, h_e.dtype, h_e.shape),
           g_rs=(g_rs, f32, (P, na, H)), g_cs=(g_cs, f32, (P, nt, H)),
           g_lg=(g_lg, f32, (P, na, nt)))
    dev = h_e.device
    dhe = torch.empty_like(h_e)
    dga = torch.empty(P, na, 3 * H, dtype=h_e.dtype, device=dev)
    dgb = torch.empty(P, nt, 3 * H, dtype=h_e.dtype, device=dev)
    dw = torch.empty(H * 3 * H + 4 * H, dtype=f32, device=dev)  # d w_hh | d b_hh | d w_eb
    if P == 0 or na == 0 or nt == 0:
        dw.zero_()
        dhe.zero_(), dga.zero_(), dgb.zero_()
    else:
        dgs, wpart, rsum, ksplit = _round_scratch(P, na, nt, H, 4 * H, dev)
        with torch.cuda.device(dev):
            rc = getattr(lib, "tm_block_round_bwd" + sfx)(
                h_e.data_ptr(), ga.data_ptr(), gb.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
                w_eb.data_ptr(), mask3.data_ptr(), g_eo.data_ptr(), g_rs.data_ptr(),
                g_cs.data_ptr(), g_lg.data_ptr(), dhe.data_ptr(), dga.data_ptr(),
                dgb.data_ptr(), dgs.data_ptr(), wpart.data_ptr(), rsum.data_ptr(), dw.data_ptr(),
                ksplit, P, na, nt, H, float(sign), _stream())
        if rc != 0:
            raise RuntimeError(f"block_round_bwd{sfx} kernel launch failed: CUDA error {rc}")
        LAUNCHES["block_round_bwd" + sfx] += 1
    dwhh = dw[:3 * H * H].view(H, 3 * H)
    dbhh = dw[3 * H * H:3 * H * H + 3 * H]
    dweb = dw[3 * H * H + 3 * H:].view(H, 1)
    return dhe, dga, dgb, dwhh, dbhh, dweb


def _es_inputs(name, h_e, act_l, new_l, ga_d, gb_d, b_ih, w_hh, b_hh, w_eb, mask3, B, capD,
               inc_ptr, inc_slot):
    if h_e.dim() != 4:
        raise TypeError(f"{name}: h_e must be [P, na, nt, H], got {list(h_e.shape)}")
    P, na, nt, H = h_e.shape
    f32, i32 = torch.float32, torch.int32
    if inc_slot.dim() != 1:
        raise TypeError(f"{name}: inc_slot must be int32[n], got {list(inc_slot.shape)}")
    _check(name, h_e.device, h_e=(h_e, f32, (P, na, nt, H)), act_l=(act_l, i32, (P, na)),
           new_l=(new_l, i32, (P, nt)), ga_d=(ga_d, f32, (B * capD, 3 * H)),
           gb_d=(gb_d, f32, (B * capD, 3 * H)), b_ih=(b_ih, f32, (3 * H,)),
           w_hh=(w_hh, f32, (H, 3 * H)), b_hh=(b_hh, f32, (3 * H,)), w_eb=(w_eb, f32, (H, 1)),
           mask3=(mask3, f32, (P, na, nt)), inc_ptr=(inc_ptr, i32, (B * capD + 1,)),
           inc_slot=(inc_slot, i32, tuple(inc_slot.shape)))
    if P * (na + nt) >= 2 ** 31:
        raise ValueError(f"{name}: P * (na + nt) = {P * (na + nt)} overflows the int32 slots")
    return _round_library(name, na, nt, H), P, na, nt, H


def _block_round_es_fwd_cuda(h_e, act_l, new_l, ga_d, gb_d, b_ih, w_hh, b_hh, w_eb, mask3,
                             sign, B, capD, inc_ptr, inc_slot):
    lib, P, na, nt, H = _es_inputs("block_round_es_fwd", h_e, act_l, new_l, ga_d, gb_d, b_ih,
                                   w_hh, b_hh, w_eb, mask3, B, capD, inc_ptr, inc_slot)
    dev, f32 = h_e.device, torch.float32
    eo = torch.empty_like(h_e)
    lg = torch.empty(P, na, nt, dtype=f32, device=dev)
    es = torch.empty(B * capD, H, dtype=f32, device=dev)
    if P == 0 or na == 0 or nt == 0 or B * capD == 0:
        return eo.zero_(), lg.zero_(), es.zero_()
    rs = torch.empty(P, na, H, dtype=f32, device=dev)
    cs = torch.empty(P, nt, H, dtype=f32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.tm_block_round_es_fwd(
            h_e.data_ptr(), act_l.data_ptr(), new_l.data_ptr(), ga_d.data_ptr(),
            gb_d.data_ptr(), b_ih.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), w_eb.data_ptr(),
            mask3.data_ptr(), inc_ptr.data_ptr(), inc_slot.data_ptr(), eo.data_ptr(),
            rs.data_ptr(), cs.data_ptr(), lg.data_ptr(), es.data_ptr(), P, na, nt, H, B, capD,
            float(sign), _stream())
    if rc != 0:
        raise RuntimeError(f"block_round_es_fwd kernel launch failed: CUDA error {rc}")
    LAUNCHES["block_round_es_fwd"] += 1
    return eo, lg, es


def _block_round_es_bwd_cuda(h_e, act_l, new_l, ga_d, gb_d, b_ih, w_hh, b_hh, w_eb, mask3,
                             sign, B, capD, inc_ptr, inc_slot, g_eo, g_lg, g_es):
    lib, P, na, nt, H = _es_inputs("block_round_es_bwd", h_e, act_l, new_l, ga_d, gb_d, b_ih,
                                   w_hh, b_hh, w_eb, mask3, B, capD, inc_ptr, inc_slot)
    dev, f32 = h_e.device, torch.float32
    _check("block_round_es_bwd", dev, g_eo=(g_eo, f32, h_e.shape),
           g_lg=(g_lg, f32, (P, na, nt)), g_es=(g_es, f32, (B * capD, H)))
    dhe = torch.empty_like(h_e)
    dgad = torch.empty(B * capD, 3 * H, dtype=f32, device=dev)
    dgbd = torch.empty(B * capD, 3 * H, dtype=f32, device=dev)
    dw = torch.empty(H * 3 * H + 7 * H, dtype=f32, device=dev)  # d w_hh | d b_hh | d w_eb | d b_ih
    if P == 0 or na == 0 or nt == 0 or B * capD == 0:
        for t in (dhe, dgad, dgbd, dw):
            t.zero_()
    else:
        dga = torch.empty(P, na, 3 * H, dtype=f32, device=dev)
        dgb = torch.empty(P, nt, 3 * H, dtype=f32, device=dev)
        dgs, wpart, rsum, ksplit = _round_scratch(P, na, nt, H, 7 * H, dev)
        with torch.cuda.device(dev):
            rc = lib.tm_block_round_es_bwd(
                h_e.data_ptr(), act_l.data_ptr(), new_l.data_ptr(), ga_d.data_ptr(),
                gb_d.data_ptr(), b_ih.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
                w_eb.data_ptr(), mask3.data_ptr(), inc_ptr.data_ptr(), inc_slot.data_ptr(),
                g_eo.data_ptr(), g_lg.data_ptr(), g_es.data_ptr(), dhe.data_ptr(),
                dga.data_ptr(), dgb.data_ptr(), dgs.data_ptr(), wpart.data_ptr(), rsum.data_ptr(),
                dw.data_ptr(), dgad.data_ptr(), dgbd.data_ptr(), ksplit, P, na, nt, H, B, capD,
                float(sign), _stream())
        if rc != 0:
            raise RuntimeError(f"block_round_es_bwd kernel launch failed: CUDA error {rc}")
        LAUNCHES["block_round_es_bwd"] += 1
    n = 3 * H * H
    return (dhe, dgad, dgbd, dw[n + 4 * H:], dw[:n].view(H, 3 * H), dw[n:n + 3 * H],
            dw[n + 3 * H:n + 4 * H].view(H, 1))


def _window_pull_cuda(name, src_a, src_b, idx_a, idx_b, B, capD, inc, two):
    """One launch of the window_scatter kernel: out_a = the rows (src_a
    [P, na, Fa], ids idx_a [P, na]) of each detection's incidence and, with
    `two`, out_b = its columns (src_b [P, nt, Fb], ids idx_b); else out_a
    sums both (Fb = Fa).  inc: the batch's detection incidence over slots
    q*(na + nt) + r, or None to build the full incidence of the ids here."""
    P, na, Fa = src_a.shape
    nt, Fb = (0, Fa) if src_b is None else src_b.shape[1:]
    f32, i32 = torch.float32, torch.int32
    dev = src_a.device
    tensors = {"vals": (src_a, f32, (P, na, Fa)), "idx": (idx_a, i32, (P, na))}
    if src_b is not None:
        tensors.update(cols=(src_b, f32, (P, nt, Fb)), col_idx=(idx_b, i32, (P, nt)))
    _check(name, dev, **tensors)
    if not two and Fb != Fa:
        raise ValueError(f"{name}: rows of width {Fa} and columns of width {Fb} in one output")
    if Fa % 4 or Fb % 4 or any(t.data_ptr() % 16 for t in (src_a, src_b) if t is not None):
        raise ValueError(f"{name}: widths {Fa}, {Fb} must be multiples of 4 and the values "
                         "16-byte aligned")
    if P * (na + nt) >= 2 ** 31:
        raise ValueError(f"{name}: P * (na + nt) = {P * (na + nt)} overflows the int32 slots")
    if inc is None:
        ids = idx_a if src_b is None else torch.cat([idx_a, idx_b], 1)
        inc = window_incidence(ids, B, capD)
        longest = -(-P // B) * (na + nt)
    else:
        longest = -(-P // B) + 1  # one entry a block, and the first beyond P
    ptr, slot = inc
    if slot.dim() != 1:
        raise TypeError(f"{name}: inc slots must be int32[n], got {list(slot.shape)}")
    _check(name, dev, inc_ptr=(ptr, i32, (B * capD + 1,)), inc_slot=(slot, i32, tuple(slot.shape)))
    outs = [torch.empty(B * capD, F, dtype=f32, device=dev) for F in ((Fa, Fb) if two else (Fa,))]
    if B * capD == 0:
        return outs
    with torch.cuda.device(dev):
        rc = _build.load("block").tm_window_scatter(
            src_a.data_ptr(), 0 if src_b is None else src_b.data_ptr(), idx_a.data_ptr(),
            0 if idx_b is None else idx_b.data_ptr(), ptr.data_ptr(), slot.data_ptr(),
            outs[0].data_ptr(), outs[1].data_ptr() if two else 0, slot.numel(), P, na, nt, Fa,
            Fb, B * capD, capD, longest, _stream())
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES["window_scatter"] += 1
    return outs


def _window_scatter_cuda(vals, idx_l, B, capD, inc=None):
    if vals.dim() != 3:
        raise TypeError(f"window_scatter: vals must be [P, n, F], got {list(vals.shape)}")
    return _window_pull_cuda("window_scatter", vals, None, idx_l, None, B, capD, inc, False)[0]


def _window_gather2_bwd_cuda(dga, dgb, act_l, new_l, B, capD, inc=None):
    """Both cotangents of window_gather2 in one launch, of any two widths."""
    if dga.dim() != 3 or dgb.dim() != 3:
        raise TypeError("window_gather2 backward: cotangents must be [P, n, F], got "
                        f"{list(dga.shape)} and {list(dgb.shape)}")
    return tuple(_window_pull_cuda("window_scatter", dga, dgb, act_l, new_l, B, capD, inc, True))


def window_scatter_raw(vals, idx_l, B, capD, inc=None):
    """window_scatter without autograd: the kernel on a CUDA tensor, the
    plain version on a CPU tensor.  inc: the batch's detection incidence
    (block_incidence) over slots p*n + i of vals [P, n, F], where vals is 0
    at every position it does not list; or None to build the full incidence
    of idx_l on the card for the call.  idx_l must lie in [0, capD); on the
    card an id outside traps the kernel, and the next synchronisation
    raises."""
    if _on_cuda(vals):
        return _window_scatter_cuda(vals, idx_l, B, capD, inc)
    return window_scatter_reference(vals, idx_l, B, capD)


def window_gather2_backward_raw(dga, dgb, act_l, new_l, B, capD, inc=None):
    """The backward of window_gather2 without autograd: (d ga_d, d gb_d) =
    the window scatters of dga [P, na, F] by act_l and dgb [P, nt, F] by
    new_l; one kernel launch for both on a CUDA tensor, the plain versions
    on a CPU tensor.  inc as window_scatter_raw's, over slots q*(na + nt)
    + r."""
    if _on_cuda(dga):
        return _window_gather2_bwd_cuda(dga, dgb, act_l, new_l, B, capD, inc)
    return (window_scatter_reference(dga, act_l, B, capD),
            window_scatter_reference(dgb, new_l, B, capD))


def _zeros_if_none(g, shape, device, dtype=torch.float32):
    """A cotangent autograd passed as None (output unused) made zeros of
    `dtype`; the kernels take contiguous tensors only."""
    if g is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    return g.contiguous()


class FusedBlockRound(torch.autograd.Function):
    """(edge_out, rs, cs, lg) = block_round_reference(...), with the
    hand-derived backward.  The forward saves only its inputs; the backward
    recomputes the gates (as the JAX custom VJP does, pallas_block.py:241).
    A bf16 h_e (with bf16 ga, gb) selects the bf16 round and its kernels
    (block_round_fwd_bf16 / _bwd_bf16)."""

    @staticmethod
    def forward(ctx, h_e, ga, gb, w_hh, b_hh, w_eb, mask3, sign):
        ctx.save_for_backward(h_e, ga, gb, w_hh, b_hh, w_eb, mask3)
        ctx.sign = float(sign)
        if _on_cuda(h_e):
            return _block_round_fwd_cuda(h_e, ga, gb, w_hh, b_hh, w_eb, mask3, sign)
        return block_round_reference(h_e, ga, gb, w_hh, b_hh, w_eb, mask3, sign)

    @staticmethod
    def backward(ctx, g_eo, g_rs, g_cs, g_lg):
        h_e, ga, gb, w_hh, b_hh, w_eb, mask3 = ctx.saved_tensors
        P, na, nt, H = h_e.shape
        g_eo = _zeros_if_none(g_eo, h_e.shape, h_e.device, h_e.dtype)
        g_rs = _zeros_if_none(g_rs, (P, na, H), h_e.device)
        g_cs = _zeros_if_none(g_cs, (P, nt, H), h_e.device)
        g_lg = _zeros_if_none(g_lg, (P, na, nt), h_e.device)
        bwd = _block_round_bwd_cuda if _on_cuda(h_e) else block_round_backward_reference
        grads = bwd(h_e, ga, gb, w_hh, b_hh, w_eb, mask3, ctx.sign, g_eo, g_rs, g_cs, g_lg)
        return (*grads, None, None)


class WindowScatter(torch.autograd.Function):
    """window_scatter_raw with its VJP, a plain gather (pallas_block.py:667)."""

    @staticmethod
    def forward(ctx, vals, idx_l, B, capD, inc_ptr, inc_slot):
        ctx.save_for_backward(idx_l)
        ctx.B, ctx.capD = B, capD
        inc = None if inc_ptr is None else (inc_ptr, inc_slot)
        return window_scatter_raw(vals, idx_l, B, capD, inc)

    @staticmethod
    def backward(ctx, dout):
        (idx_l,) = ctx.saved_tensors
        return dout[global_idx(idx_l, ctx.B, ctx.capD)], None, None, None, None, None


class WindowGather2(torch.autograd.Function):
    """(ga_d[act], gb_d[new]): a plain gather forward; the backward scatters
    both cotangents back to the detection layout in one launch of the
    window_scatter kernel (pallas_block.py:696-704).  With msg 'diff' the
    caller passes one tensor as both ga_d and gb_d, and autograd sums the
    two cotangents."""

    @staticmethod
    def forward(ctx, ga_d, gb_d, act_l, new_l, B, capD, inc_ptr, inc_slot):
        ctx.save_for_backward(act_l, new_l, inc_ptr, inc_slot)
        ctx.B, ctx.capD = B, capD
        ctx.widths = (ga_d.shape[1], gb_d.shape[1])
        return window_gather2_reference(ga_d, gb_d, act_l, new_l, B, capD)

    @staticmethod
    def backward(ctx, dga, dgb):
        act_l, new_l, inc_ptr, inc_slot = ctx.saved_tensors
        dga = _zeros_if_none(dga, (*act_l.shape, ctx.widths[0]), act_l.device)
        dgb = _zeros_if_none(dgb, (*new_l.shape, ctx.widths[1]), new_l.device)
        inc = None if inc_ptr is None else (inc_ptr, inc_slot)
        return (*window_gather2_backward_raw(dga, dgb, act_l, new_l, ctx.B, ctx.capD, inc),
                None, None, None, None, None, None)


class FusedBlockRoundEs(torch.autograd.Function):
    """(edge_out, lg, es) = block_round_es_reference(...), with the
    hand-derived backward; the forward saves only its inputs and the
    backward recomputes the gates.  With msg 'diff' the caller passes one
    tensor as ga_d and gb_d, and autograd sums the two cotangents."""

    @staticmethod
    def forward(ctx, h_e, ga_d, gb_d, b_ih, w_hh, b_hh, w_eb, act_l, new_l, mask3, inc_ptr,
                inc_slot, sign, B, capD):
        ctx.save_for_backward(h_e, act_l, new_l, ga_d, gb_d, b_ih, w_hh, b_hh, w_eb, mask3,
                              inc_ptr, inc_slot)
        ctx.rest = (float(sign), B, capD)
        args = (h_e, act_l, new_l, ga_d, gb_d, b_ih, w_hh, b_hh, w_eb, mask3, sign, B, capD,
                inc_ptr, inc_slot)
        if _on_cuda(h_e):
            return _block_round_es_fwd_cuda(*args)
        return block_round_es_reference(*args)

    @staticmethod
    def backward(ctx, g_eo, g_lg, g_es):
        h_e, act_l, new_l, ga_d, gb_d, b_ih, w_hh, b_hh, w_eb, mask3, inc_ptr, inc_slot = \
            ctx.saved_tensors
        sign, B, capD = ctx.rest
        P, na, nt, H = h_e.shape
        g_eo = _zeros_if_none(g_eo, h_e.shape, h_e.device)
        g_lg = _zeros_if_none(g_lg, (P, na, nt), h_e.device)
        g_es = _zeros_if_none(g_es, (B * capD, H), h_e.device)
        bwd = (_block_round_es_bwd_cuda if _on_cuda(h_e)
               else block_round_es_backward_reference)
        dhe, dga_d, dgb_d, dbih, dwhh, dbhh, dweb = bwd(
            h_e, act_l, new_l, ga_d, gb_d, b_ih, w_hh, b_hh, w_eb, mask3, sign, B, capD,
            inc_ptr, inc_slot, g_eo, g_lg, g_es)
        return (dhe, dga_d, dgb_d, dbih, dwhh, dbhh, dweb) + (None,) * 8


def fused_block_round(h_e, ga, gb, w_hh, b_hh, w_eb, mask3, sign):
    return FusedBlockRound.apply(h_e, ga, gb, w_hh, b_hh, w_eb, mask3, sign)


def window_scatter(vals, idx_l, B, capD, inc=None):
    """Sum vals[p, i] into row (p % B)*capD + idx_l[p, i] of a [B*capD, F]
    output (window_scatter, pallas_block.py:639), differentiable in vals.
    inc: the batch's detection incidence (BlockBatch.det_inc_ptr,
    det_inc_slot) over slots p*n + i of vals [P, n, F], which must be 0 at
    every position it does not list; without it the card builds the full
    incidence of idx_l for the call."""
    return WindowScatter.apply(vals, idx_l, B, capD, *(inc or (None, None)))


def window_gather2(ga_d, gb_d, act_l, new_l, B, capD, inc=None):
    """(ga_d[act], gb_d[new]) per block (window_gather2,
    pallas_block.py:677); the backward scatters both cotangents in one
    launch.  inc: as window_scatter's, over slots q*(na + nt) + r (the
    batch's incidence with act_l [P, na] and new_l [P, nt])."""
    return WindowGather2.apply(ga_d, gb_d, act_l, new_l, B, capD, *(inc or (None, None)))


def fused_block_round_es(h_e, act_l, new_l, ga_d, gb_d, b_ih, w_hh, b_hh, w_eb, mask3, sign, B,
                         capD, inc):
    """(edge_out, lg, es) of one round with the input-gate gather and the
    edge-support reduction inside (fused_block_round_es,
    pallas_block.py:485), differentiable in h_e, ga_d, gb_d and the weights.

    h_e [P, na, nt, H] (step-major blocks, block q of window q % B); act_l /
    new_l int32 [P, na] / [P, nt] window-local detection ids; ga_d / gb_d
    [B*capD, 3H] the detection-layout input-gate products (one tensor twice
    for msg 'diff'); mask3 [P, na, nt] f32 0/1; sign +-1 ('diff' = -1);
    inc = (inc_ptr, inc_slot), the batch's block_incidence on the device of
    h_e.  es [B*capD, H] f32."""
    return FusedBlockRoundEs.apply(h_e, ga_d, gb_d, b_ih, w_hh, b_hh, w_eb, act_l, new_l, mask3,
                                   inc[0], inc[1], sign, B, capD)
