"""Ops of the block train step (the counterpart of
trackmpnn_tpu/ops/pallas_block.py's fused_block_round, window_scatter and
window_gather2).

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
"""

from __future__ import annotations

import torch

from trackmpnn_tpu_torch.ops import _build

LAUNCHES = {"block_round_fwd": 0, "block_round_bwd": 0, "window_scatter": 0}


# -------------------------------------------------------------- references ----
def _gates(he_m, ga, gb, w_hh, b_hh, sign):
    """GRU gates of the edge rectangle, torch order r | z | n
    (pallas_block.py:104-120); he_m is the masked h_e [P, na, nt, H]."""
    P, na, nt, H = he_m.shape
    gh = (he_m.reshape(-1, H) @ w_hh).reshape(P, na, nt, 3 * H) + b_hh
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
    w_eb [H,1]; mask3 [P,na,nt] f32 0/1; sign +-1 ('diff' = -1)."""
    m = mask3[..., None]
    he_m = h_e * m
    r, z, n, _ = _gates(he_m, ga, gb, w_hh, b_hh, sign)
    eo = ((1.0 - z) * n + z * he_m) * m
    lg = (eo @ w_eb)[..., 0]
    return eo, he_m.sum(2), he_m.sum(1), lg


def block_round_backward_reference(h_e, ga, gb, w_hh, b_hh, w_eb, mask3, sign,
                                   g_eo, g_rs, g_cs, g_lg):
    """The hand-derived backward of the round (_bwd_kernel,
    pallas_block.py:140-188): recomputes the gates from the inputs and
    returns (d h_e, d ga, d gb, d w_hh, d b_hh, d w_eb)."""
    P, na, nt, H = h_e.shape
    m = mask3[..., None]
    he_m = h_e * m
    r, z, n, ghn = _gates(he_m, ga, gb, w_hh, b_hh, sign)
    # d(masked edge_out): the direct cotangent + the head's g_lg (x) w_eb
    go = (g_eo + g_lg[..., None] * w_eb.reshape(1, 1, 1, H)) * m
    eo = ((1.0 - z) * n + z * he_m) * m
    dweb = (eo * g_lg[..., None]).reshape(-1, H).sum(0)[:, None]
    dz = go * (he_m - n)
    dpre_n = go * (1.0 - z) * (1.0 - n * n)
    dpre_r = dpre_n * ghn * r * (1.0 - r)
    dpre_z = dz * z * (1.0 - z)
    dgh = torch.cat([dpre_r, dpre_z, dpre_n * r], dim=-1)
    dgi = torch.cat([dpre_r, dpre_z, dpre_n], dim=-1)
    dhe_m = (go * z + (dgh.reshape(-1, 3 * H) @ w_hh.t()).reshape(P, na, nt, H)
             + g_rs[:, :, None, :] + g_cs[:, None, :, :])
    dhe = dhe_m * m
    dga = dgi.sum(2)
    dgb = sign * dgi.sum(1)
    dwhh = he_m.reshape(-1, H).t() @ dgh.reshape(-1, 3 * H)
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


def _round_inputs(name, h_e, ga, gb, w_hh, b_hh, w_eb, mask3):
    if h_e.dim() != 4:
        raise TypeError(f"{name}: h_e must be [P, na, nt, H], got {list(h_e.shape)}")
    P, na, nt, H = h_e.shape
    f32 = torch.float32
    _check(name, h_e.device, h_e=(h_e, f32, (P, na, nt, H)), ga=(ga, f32, (P, na, 3 * H)),
           gb=(gb, f32, (P, nt, 3 * H)), w_hh=(w_hh, f32, (H, 3 * H)),
           b_hh=(b_hh, f32, (3 * H,)), w_eb=(w_eb, f32, (H, 1)),
           mask3=(mask3, f32, (P, na, nt)))
    lib = _build.load("block")
    for backward in (False, True):
        need = lib.tm_block_round_smem_bytes(na, nt, H, int(backward))
        have = torch.cuda.get_device_properties(h_e.device).shared_memory_per_block_optin
        if need < 0 or need > have:
            raise ValueError(f"{name}: na={na}, nt={nt}, H={H} needs {need} B of shared "
                             f"memory a block, the card has {have}")
    return lib, P, na, nt, H


def _block_round_fwd_cuda(h_e, ga, gb, w_hh, b_hh, w_eb, mask3, sign):
    lib, P, na, nt, H = _round_inputs("block_round_fwd", h_e, ga, gb, w_hh, b_hh, w_eb, mask3)
    eo = torch.empty_like(h_e)
    rs = torch.empty(P, na, H, dtype=torch.float32, device=h_e.device)
    cs = torch.empty(P, nt, H, dtype=torch.float32, device=h_e.device)
    lg = torch.empty(P, na, nt, dtype=torch.float32, device=h_e.device)
    if P == 0 or na == 0 or nt == 0:
        return eo.zero_(), rs.zero_(), cs.zero_(), lg.zero_()
    with torch.cuda.device(h_e.device):
        rc = lib.tm_block_round_fwd(
            h_e.data_ptr(), ga.data_ptr(), gb.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
            w_eb.data_ptr(), mask3.data_ptr(), eo.data_ptr(), rs.data_ptr(), cs.data_ptr(),
            lg.data_ptr(), P, na, nt, H, float(sign), _stream())
    if rc != 0:
        raise RuntimeError(f"block_round_fwd kernel launch failed: CUDA error {rc}")
    LAUNCHES["block_round_fwd"] += 1
    return eo, rs, cs, lg


def _block_round_bwd_cuda(h_e, ga, gb, w_hh, b_hh, w_eb, mask3, sign, g_eo, g_rs, g_cs, g_lg):
    lib, P, na, nt, H = _round_inputs("block_round_bwd", h_e, ga, gb, w_hh, b_hh, w_eb, mask3)
    f32 = torch.float32
    _check("block_round_bwd", h_e.device, g_eo=(g_eo, f32, h_e.shape),
           g_rs=(g_rs, f32, (P, na, H)), g_cs=(g_cs, f32, (P, nt, H)),
           g_lg=(g_lg, f32, (P, na, nt)))
    dev = h_e.device
    dhe = torch.empty_like(h_e)
    dga = torch.empty(P, na, 3 * H, dtype=f32, device=dev)
    dgb = torch.empty(P, nt, 3 * H, dtype=f32, device=dev)
    width = H * 3 * H + 4 * H  # per-block partials: d w_hh | d b_hh | d w_eb
    dw = torch.empty(width, dtype=f32, device=dev)
    if P == 0 or na == 0 or nt == 0:
        dw.zero_()
        dhe.zero_(), dga.zero_(), dgb.zero_()
    else:
        partials = torch.empty(P, width, dtype=f32, device=dev)
        with torch.cuda.device(dev):
            rc = lib.tm_block_round_bwd(
                h_e.data_ptr(), ga.data_ptr(), gb.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
                w_eb.data_ptr(), mask3.data_ptr(), g_eo.data_ptr(), g_rs.data_ptr(),
                g_cs.data_ptr(), g_lg.data_ptr(), dhe.data_ptr(), dga.data_ptr(),
                dgb.data_ptr(), partials.data_ptr(), dw.data_ptr(), P, na, nt, H,
                float(sign), _stream())
        if rc != 0:
            raise RuntimeError(f"block_round_bwd kernel launch failed: CUDA error {rc}")
        LAUNCHES["block_round_bwd"] += 1
    dwhh = dw[:3 * H * H].view(H, 3 * H)
    dbhh = dw[3 * H * H:3 * H * H + 3 * H]
    dweb = dw[3 * H * H + 3 * H:].view(H, 1)
    return dhe, dga, dgb, dwhh, dbhh, dweb


def _window_scatter_cuda(vals, idx_l, B, capD):
    if vals.dim() != 3:
        raise TypeError(f"window_scatter: vals must be [P, n, F], got {list(vals.shape)}")
    P, n, F = vals.shape
    _check("window_scatter", vals.device, vals=(vals, torch.float32, (P, n, F)),
           idx_l=(idx_l, torch.int32, (P, n)))
    if F % 4 != 0 or vals.data_ptr() % 16 != 0:
        raise ValueError(f"window_scatter: F={F} must be a multiple of 4 and vals 16-byte aligned")
    lib = _build.load("block")
    need = lib.tm_window_scatter_smem_bytes(n, capD)
    have = torch.cuda.get_device_properties(vals.device).shared_memory_per_block_optin
    if need > have:
        raise ValueError(f"window_scatter: capD={capD} needs {need} B of shared memory a "
                         f"block, the card has {have}")
    out = torch.empty(B * capD, F, dtype=torch.float32, device=vals.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(vals.device):
        rc = lib.tm_window_scatter(vals.data_ptr(), idx_l.data_ptr(), out.data_ptr(),
                                   P, n, F, B, capD, _stream())
    if rc != 0:
        raise RuntimeError(f"window_scatter kernel launch failed: CUDA error {rc}")
    LAUNCHES["window_scatter"] += 1
    return out


def window_scatter_raw(vals, idx_l, B, capD):
    """window_scatter without autograd: the kernel on a CUDA tensor, the
    plain version on a CPU tensor.  idx_l must lie in [0, capD); on the card
    an id outside traps the kernel, and the next synchronisation raises."""
    if _on_cuda(vals):
        return _window_scatter_cuda(vals, idx_l, B, capD)
    return window_scatter_reference(vals, idx_l, B, capD)


def _zeros_if_none(g, shape, device):
    """An f32 cotangent autograd passed as None (output unused) made zeros;
    the kernels take contiguous tensors only."""
    if g is None:
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return g.contiguous()


class FusedBlockRound(torch.autograd.Function):
    """(edge_out, rs, cs, lg) = block_round_reference(...), with the
    hand-derived backward.  The forward saves only its inputs; the backward
    recomputes the gates (as the JAX custom VJP does, pallas_block.py:241)."""

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
        g_eo = _zeros_if_none(g_eo, h_e.shape, h_e.device)
        g_rs = _zeros_if_none(g_rs, (P, na, H), h_e.device)
        g_cs = _zeros_if_none(g_cs, (P, nt, H), h_e.device)
        g_lg = _zeros_if_none(g_lg, (P, na, nt), h_e.device)
        bwd = _block_round_bwd_cuda if _on_cuda(h_e) else block_round_backward_reference
        grads = bwd(h_e, ga, gb, w_hh, b_hh, w_eb, mask3, ctx.sign, g_eo, g_rs, g_cs, g_lg)
        return (*grads, None, None)


class WindowScatter(torch.autograd.Function):
    """window_scatter_raw with its VJP, a plain gather (pallas_block.py:667)."""

    @staticmethod
    def forward(ctx, vals, idx_l, B, capD):
        ctx.save_for_backward(idx_l)
        ctx.B, ctx.capD = B, capD
        return window_scatter_raw(vals, idx_l, B, capD)

    @staticmethod
    def backward(ctx, dout):
        (idx_l,) = ctx.saved_tensors
        return dout[global_idx(idx_l, ctx.B, ctx.capD)], None, None, None


class WindowGather2(torch.autograd.Function):
    """(ga_d[act], gb_d[new]): a plain gather forward; the backward scatters
    both cotangents back to the detection layout through the window_scatter
    kernel (pallas_block.py:696-704).  With msg 'diff' the caller passes one
    tensor as both ga_d and gb_d, and autograd sums the two cotangents."""

    @staticmethod
    def forward(ctx, ga_d, gb_d, act_l, new_l, B, capD):
        ctx.save_for_backward(act_l, new_l)
        ctx.B, ctx.capD = B, capD
        ctx.widths = (ga_d.shape[1], gb_d.shape[1])
        return window_gather2_reference(ga_d, gb_d, act_l, new_l, B, capD)

    @staticmethod
    def backward(ctx, dga, dgb):
        act_l, new_l = ctx.saved_tensors
        dga = _zeros_if_none(dga, (*act_l.shape, ctx.widths[0]), act_l.device)
        dgb = _zeros_if_none(dgb, (*new_l.shape, ctx.widths[1]), new_l.device)
        return (window_scatter_raw(dga, act_l, ctx.B, ctx.capD),
                window_scatter_raw(dgb, new_l, ctx.B, ctx.capD), None, None, None, None)


def fused_block_round(h_e, ga, gb, w_hh, b_hh, w_eb, mask3, sign):
    return FusedBlockRound.apply(h_e, ga, gb, w_hh, b_hh, w_eb, mask3, sign)


def window_scatter(vals, idx_l, B, capD):
    return WindowScatter.apply(vals, idx_l, B, capD)


def window_gather2(ga_d, gb_d, act_l, new_l, B, capD):
    return WindowGather2.apply(ga_d, gb_d, act_l, new_l, B, capD)
