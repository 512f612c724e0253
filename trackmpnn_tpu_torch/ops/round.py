"""The fused 'diff' FactorGraphGRU round of the packed row layout (the
counterpart of trackmpnn_tpu/ops/pallas_round.py's fused_round).

One round over B windows of `cap` rows, h f32[B, cap, H], with idxw
int32[B, cap, 4] = (past, fut, is_live_edge, is_live_det), indices local to
the window.  A row flagged is_live_det is a detection; a row flagged
is_live_edge and not is_live_det is an edge; any other row is dead.

    edge row k:  ns[k] = h[past k] - h[fut k];   out[k] = GRU_e(ns[k], h[k])
    det row d:   es[d] = sum over edge rows k of ((past k == d) - (fut k == d)) h[k]
                 out[d] = GRU_n(es[d], h[d])
    dead row:    out = 0

Each stage has
  * a plain PyTorch version (`*_reference`), the semantics the tests hold
    against the JAX package and the version a CPU tensor gets;
  * for a CUDA tensor a wrapper that checks its inputs and launches the
    hand-written kernel in csrc/round_kernels.cu, or raises.  It never
    falls back to the plain version on the card;
  * a launch counter, LAUNCHES[name], raised by one where a kernel is
    launched and nowhere else.

The stages: round_fwd (out and the GRU input xin = ns or es of each row,
the one residual saved for the backward), and the backward in three:
round_bwd_gru (both GRU backwards per row: the gate gradients d4 = [d r |
d z | d n | r d n], d xin and the direct part of d h), round_bwd_dw (the
eight weight and bias gradients, summed over rows) and round_bwd_dh (d h:
the direct part, d es through each edge's endpoints and d ns through each
detection's incident edges).  FusedRound is the autograd Function over
them.  The kernels find a detection's incident edges in a CSR incidence
(round_incidence), built once per batch on the host.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from trackmpnn_tpu_torch.ops import _build
from trackmpnn_tpu_torch.ops.block import _check, _on_cuda, _stream

LAUNCHES = {"round_fwd": 0, "round_bwd_gru": 0, "round_bwd_dw": 0, "round_bwd_dh": 0}
ROUND_WIDTHS = range(8, 257, 8)  # the hidden widths the kernels take
_WEIGHTS = ("w_ih", "w_hh", "b_ih", "b_hh")


# ------------------------------------------------------------------ layout ----
def round_incidence(idxw):
    """The CSR incidence of a batch, numpy: for every row d of every window
    (flat row b*cap + d), the window-local ids of the edge rows k (flagged
    is_live_edge, not is_live_det) with past k == d or fut k == d, in
    increasing order, once each.

    idxw: int [B, cap, 4] (numpy).  Returns (inc_ptr int32[B*cap + 1],
    inc_idx int32[n]): row r's edges are inc_idx[inc_ptr[r]:inc_ptr[r+1]].
    Built from the batch's static past/fut with every row that is an edge
    at any step flagged, it serves every step of the batch: the kernels
    skip the edges a step's idxw does not flag."""
    idxw = np.asarray(idxw)
    B, cap, _ = idxw.shape
    b, k = np.nonzero((idxw[..., 2] != 0) & (idxw[..., 3] == 0))
    p, f = idxw[b, k, 0].astype(np.int64), idxw[b, k, 1].astype(np.int64)
    if np.any((p < 0) | (p >= cap) | (f < 0) | (f >= cap)):
        raise ValueError("an edge endpoint lies outside its window")
    keep = np.concatenate([np.ones(len(k), bool), p != f])  # a self-loop once
    rows = np.concatenate([b * cap + p, b * cap + f])[keep]
    ks = np.concatenate([k, k])[keep]
    order = np.lexsort((ks, rows))
    ptr = np.zeros(B * cap + 1, np.int64)
    ptr[1:] = np.cumsum(np.bincount(rows, minlength=B * cap))
    return ptr.astype(np.int32), ks[order].astype(np.int32)


def _kinds(idxw):
    det = idxw[..., 3] != 0
    return (idxw[..., 2] != 0) & ~det, det


def _flat_endpoints(idxw, edge):
    """Flat rows of each edge row's endpoints; a non-edge row points at
    itself, so its (unused) indices never leave the batch."""
    B, cap, _ = idxw.shape
    rows = torch.arange(B * cap, device=idxw.device).reshape(B, cap)
    base = rows - torch.arange(cap, device=idxw.device)
    p = torch.where(edge, idxw[..., 0].long() + base, rows).reshape(-1)
    f = torch.where(edge, idxw[..., 1].long() + base, rows).reshape(-1)
    return p, f


def _gates(x, h, w):
    """GRU gates (torch order r | z | n) and gh_n = (h w_hh + b_hh)[2H:]."""
    H = h.shape[-1]
    gi = x @ w["w_ih"] + w["b_ih"]
    gh = h @ w["w_hh"] + w["b_hh"]
    r = torch.sigmoid(gi[..., :H] + gh[..., :H])
    z = torch.sigmoid(gi[..., H:2 * H] + gh[..., H:2 * H])
    n = torch.tanh(gi[..., 2 * H:] + r * gh[..., 2 * H:])
    return r, z, n, gh[..., 2 * H:]


# -------------------------------------------------------------- references ----
def round_reference(h, past, fut, is_det, live, we, wn):
    """One 'diff' round (round_reference, pallas_round.py:56-75): h [B, cap,
    H]; past/fut [B, cap] window-local; is_det/live bool [B, cap]; we/wn
    {w_ih, w_hh [H, 3H], b_ih, b_hh [3H]}.  Returns h_out [B, cap, H]."""
    idxw = torch.stack([past.to(torch.int32), fut.to(torch.int32),
                        (live & ~is_det).to(torch.int32), (live & is_det).to(torch.int32)], -1)
    return round_fwd_reference(h, idxw, we, wn)[0]


def round_fwd_reference(h, idxw, we, wn):
    """(out, xin) of the round: xin holds ns at edge rows, es at detection
    rows, 0 at dead rows.  The incident sums run in f64 and round to f32
    once, as the kernel's do."""
    B, cap, H = h.shape
    edge, det = _kinds(idxw)
    p, f = _flat_endpoints(idxw, edge)
    hf = h.reshape(-1, H)
    em = edge.reshape(-1)
    ns = torch.where(em[:, None], hf[p] - hf[f], 0.0)
    he = torch.where(em[:, None], hf, 0.0).double()
    es = (torch.zeros(B * cap, H, dtype=torch.float64, device=h.device)
          .index_add(0, p, he).index_add(0, f, -he)).to(h.dtype)
    dm = det.reshape(-1)[:, None]
    xin = torch.where(dm, es, ns)
    r, z, n, _ = _gates(xin, hf, we)
    eo = (1.0 - z) * n + z * hf
    r, z, n, _ = _gates(xin, hf, wn)
    no = (1.0 - z) * n + z * hf
    out = torch.where(dm, no, torch.where(em[:, None], eo, 0.0))
    return out.reshape(B, cap, H), xin.reshape(B, cap, H)


def _gru_backward(x, h, w, g):
    """GRU backward from recomputed gates (_gru_bwd_tile,
    pallas_round.py:205-222): (d4 = [d r | d z | d n | r d n], dx, dh)."""
    r, z, n, ghn = _gates(x, h, w)
    dz = (h - n) * g
    dn = (1.0 - z) * g
    da_n = (1.0 - n * n) * dn
    dgh_n = r * da_n
    da_z = z * (1.0 - z) * dz
    da_r = r * (1.0 - r) * (da_n * ghn)
    dgi = torch.cat([da_r, da_z, da_n], -1)
    dgh = torch.cat([da_r, da_z, dgh_n], -1)
    dx = dgi @ w["w_ih"].t()
    dh = z * g + dgh @ w["w_hh"].t()
    return torch.cat([da_r, da_z, da_n, dgh_n], -1), dx, dh


def round_bwd_gru_reference(h, idxw, xin, g, we, wn):
    """Both GRU backwards (the GRU half of _bwd_b_kernel,
    pallas_round.py:225-256): g masked to each row's kind.  Returns (d4
    [B, cap, 4H], dxin [B, cap, H] = d ns at edge rows and d es at
    detection rows, ddir [B, cap, H] the part of d h not through ns or es);
    all 0 at dead rows."""
    edge, det = _kinds(idxw)
    em, dm = edge[..., None], det[..., None]
    d4e, dxe, dhe = _gru_backward(xin, h, we, torch.where(em, g, 0.0))
    d4n, dxn, dhn = _gru_backward(xin, h, wn, torch.where(dm, g, 0.0))
    pick = lambda a, b: torch.where(dm, b, torch.where(em, a, 0.0))
    return pick(d4e, d4n), pick(dxe, dxn), pick(dhe, dhn)


def round_bwd_dw_reference(h, idxw, xin, d4):
    """The weight and bias gradients of both GRUs (the accumulators of
    _bwd_b_kernel, pallas_round.py:258-265): (d we, d wn), each summed over
    the rows of its kind (the other rows masked to 0, so that nothing
    waits for the card to count them)."""
    H = h.shape[-1]
    edge, det = _kinds(idxw)
    out = []
    for m in (edge.reshape(-1, 1), det.reshape(-1, 1)):
        d = torch.where(m, d4.reshape(-1, 4 * H), 0.0)
        dgi = d[:, :3 * H]
        dgh = torch.cat([d[:, :2 * H], d[:, 3 * H:]], -1)
        out.append({"w_ih": xin.reshape(-1, H).t() @ dgi, "w_hh": h.reshape(-1, H).t() @ dgh,
                    "b_ih": dgi.sum(0), "b_hh": dgh.sum(0)})
    return tuple(out)


def round_bwd_dh_reference(idxw, dxin, ddir):
    """d h (_bwd_a_kernel, pallas_round.py:268-299): ddir, plus at an edge
    row d es[past] - d es[fut] (d es = dxin at detection rows, 0 elsewhere),
    plus at every row d the signed sum of d ns (dxin at edge rows) over the
    edges incident to d.  Sums in f64, rounded to f32 once, as the kernel's."""
    B, cap, H = dxin.shape
    edge, det = _kinds(idxw)
    p, f = _flat_endpoints(idxw, edge)
    em = edge.reshape(-1)[:, None]
    dx = dxin.reshape(-1, H).double()
    des = torch.where(det.reshape(-1)[:, None], dx, 0.0)
    dns = torch.where(em, dx, 0.0)
    dh = ddir.reshape(-1, H).double() + torch.where(em, des[p] - des[f], 0.0)
    dh = dh.index_add(0, p, dns).index_add(0, f, -dns)
    return dh.to(dxin.dtype).reshape(B, cap, H)


# ---------------------------------------------------------------- wrappers ----
@functools.lru_cache(maxsize=None)
def round_widths(H):
    """The round kernels' width rule, checked once for each H: a multiple of
    8 from 8 to 256 (the product kernels stage a slab of U units of each
    gate, U * H <= 2048, and read the rows in k steps of 8).  Raises
    ValueError naming the width it refuses; JAX's Pallas kernels keep both
    GRUs in VMEM and take any H."""
    if H not in ROUND_WIDTHS:
        raise ValueError(f"the fused round kernels take a hidden width H that is a multiple of 8 "
                         f"from 8 to 256, not H={H}")
    return H


def _dims(name, x, label="h"):
    """(B, cap, H) of an f32[B, cap, H] input, H a width the kernels take."""
    if x.dim() != 3:
        raise TypeError(f"{name}: {label} must be f32[B, cap, H], got {list(x.shape)}")
    B, cap, H = x.shape
    try:
        round_widths(H)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    if B * cap >= 2**31:
        raise ValueError(f"{name}: {B} x {cap} rows; the kernels take fewer than 2^31")
    return B, cap, H


def _aligned(name, **tensors):
    """The kernels read and write rows as 8- and 16-byte vectors."""
    for label, t in tensors.items():
        if t.data_ptr() % 16 != 0:
            raise ValueError(f"{name}: {label} must be 16-byte aligned")


def _rows_scratch(lib, nrows, device):
    """The per-kind row lists and chunk counts a launch builds."""
    return torch.empty(lib.tm_round_rows_ints(nrows), dtype=torch.int32, device=device)


def _check_index(name, device, idxw, B, cap, inc=None):
    """idxw int32[B, cap, 4], 16-byte aligned (the kernels read a row as one
    int4), and the incidence int32[B*cap + 1], int32[n]."""
    _check(name, device, idxw=(idxw, torch.int32, (B, cap, 4)))
    if idxw.data_ptr() % 16 != 0:
        raise ValueError(f"{name}: idxw must be 16-byte aligned")
    if inc is not None:
        inc_ptr, inc_idx = inc
        if inc_idx.dim() != 1:
            raise TypeError(f"{name}: inc_idx must be int32[n], got {list(inc_idx.shape)}")
        _check(name, device, inc_ptr=(inc_ptr, torch.int32, (B * cap + 1,)),
               inc_idx=(inc_idx, torch.int32, tuple(inc_idx.shape)))


def _check_weights(name, device, H, we, wn):
    shapes = {"w_ih": (H, 3 * H), "w_hh": (H, 3 * H), "b_ih": (3 * H,), "b_hh": (3 * H,)}
    _check(name, device, **{f"{kind}.{k}": (w[k], torch.float32, shapes[k])
                            for kind, w in (("we", we), ("wn", wn)) for k in shapes})


def _ptrs(w):
    return [w[k].data_ptr() for k in _WEIGHTS]


def _round_fwd_cuda(h, idxw, inc_ptr, inc_idx, we, wn):
    B, cap, H = _dims("round_fwd", h)
    _check("round_fwd", h.device, h=(h, torch.float32, (B, cap, H)))
    _check_index("round_fwd", h.device, idxw, B, cap, (inc_ptr, inc_idx))
    _check_weights("round_fwd", h.device, H, we, wn)
    out, xin = torch.empty_like(h), torch.empty_like(h)
    if h.numel() == 0:
        return out, xin
    _aligned("round_fwd", h=h)
    with torch.cuda.device(h.device):
        lib = _build.load("round")
        rows = _rows_scratch(lib, B * cap, h.device)
        rc = lib.tm_round_fwd(
            h.data_ptr(), idxw.data_ptr(), inc_ptr.data_ptr(), inc_idx.data_ptr(),
            inc_idx.numel(), *_ptrs(we), *_ptrs(wn), out.data_ptr(), xin.data_ptr(),
            rows.data_ptr(), B, cap, H, _stream())
    if rc != 0:
        raise RuntimeError(f"round_fwd kernel launch failed: CUDA error {rc}")
    LAUNCHES["round_fwd"] += 1
    return out, xin


def _round_bwd_gru_cuda(h, idxw, xin, g, we, wn):
    B, cap, H = _dims("round_bwd_gru", h)
    f32 = torch.float32
    _check("round_bwd_gru", h.device, h=(h, f32, (B, cap, H)), xin=(xin, f32, (B, cap, H)),
           g=(g, f32, (B, cap, H)))
    _check_index("round_bwd_gru", h.device, idxw, B, cap)
    _check_weights("round_bwd_gru", h.device, H, we, wn)
    d4 = torch.empty(B, cap, 4 * H, dtype=torch.float32, device=h.device)
    dxin, ddir = torch.empty_like(h), torch.empty_like(h)
    if h.numel() == 0:
        return d4, dxin, ddir
    _aligned("round_bwd_gru", h=h, xin=xin, g=g)
    with torch.cuda.device(h.device):
        lib = _build.load("round")
        rows = _rows_scratch(lib, B * cap, h.device)
        rc = lib.tm_round_bwd_gru(
            h.data_ptr(), idxw.data_ptr(), xin.data_ptr(), g.data_ptr(), *_ptrs(we),
            *_ptrs(wn), d4.data_ptr(), dxin.data_ptr(), ddir.data_ptr(), rows.data_ptr(),
            B, cap, H, _stream())
    if rc != 0:
        raise RuntimeError(f"round_bwd_gru kernel launch failed: CUDA error {rc}")
    LAUNCHES["round_bwd_gru"] += 1
    return d4, dxin, ddir


def _round_bwd_dw_cuda(h, idxw, xin, d4):
    B, cap, H = _dims("round_bwd_dw", h)
    f32 = torch.float32
    _check("round_bwd_dw", h.device, h=(h, f32, (B, cap, H)), xin=(xin, f32, (B, cap, H)),
           d4=(d4, f32, (B, cap, 4 * H)))
    _check_index("round_bwd_dw", h.device, idxw, B, cap)
    width = 2 * H * 3 * H + 2 * 3 * H  # d w_ih | d w_hh | d b_ih | d b_hh
    dw = torch.zeros(2, width, dtype=f32, device=h.device)
    if h.numel() > 0:
        _aligned("round_bwd_dw", h=h, xin=xin, d4=d4)
        with torch.cuda.device(h.device):
            lib = _build.load("round")
            slices = lib.tm_round_dw_slices(B * cap, H)
            if slices < 1:
                raise RuntimeError(f"round_bwd_dw slice query failed: CUDA error {-slices}")
            rows = _rows_scratch(lib, B * cap, h.device)
            partials = torch.empty(slices * width + 1, dtype=f32, device=h.device)
            rc = lib.tm_round_bwd_dw(h.data_ptr(), idxw.data_ptr(), xin.data_ptr(),
                                     d4.data_ptr(), rows.data_ptr(), partials.data_ptr(),
                                     dw.data_ptr(), B * cap, H, slices, _stream())
        if rc != 0:
            raise RuntimeError(f"round_bwd_dw kernel launch failed: CUDA error {rc}")
        LAUNCHES["round_bwd_dw"] += 1
    n = H * 3 * H
    split = lambda row: {"w_ih": row[:n].view(H, 3 * H), "w_hh": row[n:2 * n].view(H, 3 * H),
                         "b_ih": row[2 * n:2 * n + 3 * H], "b_hh": row[2 * n + 3 * H:]}
    return split(dw[0]), split(dw[1])


def _round_bwd_dh_cuda(idxw, inc_ptr, inc_idx, dxin, ddir):
    B, cap, H = _dims("round_bwd_dh", dxin, "dxin")
    _check("round_bwd_dh", dxin.device, dxin=(dxin, torch.float32, (B, cap, H)),
           ddir=(ddir, torch.float32, (B, cap, H)))
    _check_index("round_bwd_dh", dxin.device, idxw, B, cap, (inc_ptr, inc_idx))
    _aligned("round_bwd_dh", dxin=dxin, ddir=ddir)
    dh = torch.empty_like(dxin)
    if dh.numel() == 0:
        return dh
    with torch.cuda.device(dxin.device):
        rc = _build.load("round").tm_round_bwd_dh(
            idxw.data_ptr(), inc_ptr.data_ptr(), inc_idx.data_ptr(), inc_idx.numel(),
            dxin.data_ptr(), ddir.data_ptr(), dh.data_ptr(), B, cap, H, _stream())
    if rc != 0:
        raise RuntimeError(f"round_bwd_dh kernel launch failed: CUDA error {rc}")
    LAUNCHES["round_bwd_dh"] += 1
    return dh


def round_fwd(h, idxw, inc_ptr, inc_idx, we, wn):
    """(out, xin): the kernel on a CUDA tensor, the plain version on a CPU
    tensor (which does not need the incidence)."""
    if _on_cuda(h):
        return _round_fwd_cuda(h, idxw, inc_ptr, inc_idx, we, wn)
    return round_fwd_reference(h, idxw, we, wn)


def round_backward(h, idxw, inc_ptr, inc_idx, xin, we, wn, g):
    """(d h, d we, d wn) of the round for the cotangent g of out: the three
    backward kernels on a CUDA tensor, their plain versions on a CPU tensor."""
    if _on_cuda(h):
        d4, dxin, ddir = _round_bwd_gru_cuda(h, idxw, xin, g, we, wn)
        dwe, dwn = _round_bwd_dw_cuda(h, idxw, xin, d4)
        return _round_bwd_dh_cuda(idxw, inc_ptr, inc_idx, dxin, ddir), dwe, dwn
    d4, dxin, ddir = round_bwd_gru_reference(h, idxw, xin, g, we, wn)
    dwe, dwn = round_bwd_dw_reference(h, idxw, xin, d4)
    return round_bwd_dh_reference(idxw, dxin, ddir), dwe, dwn


class FusedRound(torch.autograd.Function):
    """out = the round, differentiable in h and the eight GRU tensors, with
    the hand-derived backward (the custom VJP of fused_round,
    pallas_round.py:372-393).  The forward saves its inputs and xin (one
    [B, cap, H] residual where the JAX package saves eight); the backward
    recomputes the gates."""

    @staticmethod
    def forward(ctx, h, idxw, inc_ptr, inc_idx, *weights):
        we, wn = dict(zip(_WEIGHTS, weights[:4])), dict(zip(_WEIGHTS, weights[4:]))
        out, xin = round_fwd(h, idxw, inc_ptr, inc_idx, we, wn)
        ctx.save_for_backward(h, idxw, inc_ptr, inc_idx, xin, *weights)
        return out

    @staticmethod
    def backward(ctx, g):
        h, idxw, inc_ptr, inc_idx, xin, *weights = ctx.saved_tensors
        we, wn = dict(zip(_WEIGHTS, weights[:4])), dict(zip(_WEIGHTS, weights[4:]))
        dh, dwe, dwn = round_backward(h, idxw, inc_ptr, inc_idx, xin, we, wn, g.contiguous())
        return (dh, None, None, None, *(dwe[k] for k in _WEIGHTS), *(dwn[k] for k in _WEIGHTS))


def fused_round(h, idxw, we, wn, inc):
    """One fused 'diff' FactorGraphGRU round over [B, cap, H] windows
    (fused_round, pallas_round.py:373), differentiable in h and both GRU
    weight dicts.

    idxw int32[B, cap, 4]: (past, fut, is_live_edge, is_live_det),
    window-local.  inc: the batch's (inc_ptr, inc_idx) from round_incidence
    on the device of h, built once per batch on the host (train/packed.py
    does)."""
    return FusedRound.apply(h, idxw, inc[0], inc[1], *(we[k] for k in _WEIGHTS),
                            *(wn[k] for k in _WEIGHTS))
