"""Message-passing ops of the serving path (the counterpart of
trackmpnn_tpu/ops/pallas_mp.py's gather_diff, signed_segment_sum and
fused_edge_gru), and msg concat's node support (gather_concat) with its
VJP (segment_sum_halves).

Each op has
  * a plain PyTorch version (`*_reference`), the semantics the tests hold
    against the JAX package and the version a CPU tensor gets;
  * a wrapper that, for a CUDA tensor, checks its inputs and launches the
    hand-written kernel in csrc/mp_kernels.cu, or raises.  It never falls
    back to the plain version on the card;
  * a launch counter, LAUNCHES[name], raised by one where the kernel is
    launched and nowhere else.

The two ops are each other's backward (pallas_mp.py:233-284):
gather_diff and signed_segment_sum are autograd Functions (GatherDiff,
SignedSegmentSum) whose backward calls the other op's kernel on a CUDA
tensor and its plain version on a CPU tensor.  Indices and masks get no
gradient.  A forward launches its kernel once, a backward the other one
once.

The signed_segment_sum kernel pulls each destination row's terms through
a destination-sorted incidence (segment_incidence): every edge row, at
past(e) with sign +1 and at fut(e) with sign -1.  The
kernel reads the mask itself, so a graph view (graph/view.py) or a step
batch builds one incidence on the device and hands it to every round and
branch (`inc=`); without one the CUDA wrapper builds it for the call.
On the card one call of the build kernels makes it; a CPU view or batch
builds none (kernel_incidence).  BUILDS[name] counts the incidence builds.

gather_concat is msg concat's node support, [h[past] | h[fut]] on edge
rows (trackmpnn_tpu/models/mpnn.py:123-125), an autograd Function whose
backward is segment_sum_halves: the same pull over the same incidence,
every entry with sign +1, entry k < N taking the cotangent's columns :H
and entry k >= N its columns H: (the halves mode of the pull kernel).

fused_edge_gru (pallas_mp.py:84) is gather_diff and the edge GRU in one
launch, forward only as on the TPU: it refuses to run where autograd would
need its gradient.  The served forward (no gradient recorded) takes it in
place of gather_diff + models/nn.gru_cell, so a served forward launches
fused_edge_gru and signed_segment_sum once a feature branch each.
"""

from __future__ import annotations

import ctypes

import torch

from trackmpnn_tpu_torch.ops import _build

LAUNCHES = {"gather_diff": 0, "signed_segment_sum": 0, "fused_edge_gru": 0,
            "gather_concat": 0, "segment_sum_halves": 0}
BUILDS = {"segment_incidence": 0}
_EDGE_GRU_CTAS: dict = {}  # (device index, H) -> the kernel's grid cap, set up once


# -------------------------------------------------------------- references ----
def gather_diff_reference(h, past, fut, edge_mask):
    """node_support: per edge row, h[past] - h[fut]; zero elsewhere."""
    diff = h.index_select(0, past) - h.index_select(0, fut)
    return torch.where(edge_mask.bool()[:, None], diff, 0.0)


def gather_concat_reference(h, past, fut, edge_mask):
    """msg concat's node support: per edge row [h[past] | h[fut]] (f32[N,
    2H]); zero elsewhere (trackmpnn_tpu/models/mpnn.py:123-125)."""
    cat = torch.cat([h.index_select(0, past), h.index_select(0, fut)], 1)
    return torch.where(edge_mask.bool()[:, None], cat, 0.0)


def segment_sum_halves_reference(g, past, fut, edge_mask, n):
    """gather_concat's VJP: row d accumulates g[e, :H] over edge rows with
    past(e)=d and g[e, H:] over edge rows with fut(e)=d (g f32[N, 2H], out
    f32[n, H]).  Sums in f64, rounded to f32 once, as the kernel's."""
    H = g.shape[1] // 2
    m = edge_mask.bool()
    gm = torch.where(m[:, None], g, 0.0).double()
    acc = gm.new_zeros(n + 1, H)
    acc.index_add_(0, torch.where(m, past, n), gm[:, :H])
    acc.index_add_(0, torch.where(m, fut, n), gm[:, H:])
    return acc[:n].to(g.dtype)


def signed_segment_sum_reference(h, past, fut, edge_mask, n):
    """edge_support: row d accumulates +h[e] over edges with past(e)=d and
    -h[e] over edges with fut(e)=d.  Masked rows go to a scratch bucket n,
    so their indices never matter.  Sums run in f64 and round to f32 once,
    as the kernel's do, so the result does not depend on summation order."""
    m = edge_mask.bool()
    hm = torch.where(m[:, None], h, 0.0).double()
    acc = hm.new_zeros(n + 1, h.shape[1])
    acc.index_add_(0, torch.where(m, past, n), hm)
    acc.index_add_(0, torch.where(m, fut, n), -hm)
    return acc[:n].to(h.dtype)


def signed_segment_sum_pull_reference(h, edge_mask, inc, n):
    """signed_segment_sum as its kernel computes it: per destination row d,
    the f64 sum of sign * h[e] over d's incidence entries (segment_incidence)
    whose row is masked in, rounded to f32 once."""
    ptr, ent = inc
    N = h.shape[0]
    ent = ent[:int(ptr[-1])].long()
    neg = ent >= N
    rows = torch.where(neg, ent - N, ent)
    owner = torch.repeat_interleave(torch.arange(n, device=h.device), (ptr[1:] - ptr[:-1]).long(),
                                    output_size=ent.numel())
    vals = torch.where(edge_mask.bool()[rows, None], h[rows].double(), 0.0)
    vals = torch.where(neg[:, None], -vals, vals)
    return vals.new_zeros(n, h.shape[1]).index_add_(0, owner, vals).to(h.dtype)


def segment_incidence_reference(past, fut, n):
    """The destination-sorted incidence of signed_segment_sum on the device
    of past, in plain tensor ops (a stable sort and a search; no host
    synchronisation): the build kernel's plain version.

    Entry k < N is row k at destination past[k] with sign +1, entry k >= N
    row k - N at fut[k - N] with sign -1 (the doubled incidence [past;
    fut]).  Rows that point at themselves at both ends are left out: the
    detection and padding rows graph/view.py::pack_slots writes, which are
    never masked in (and would add +h - h to themselves if they were).  An
    endpoint outside [0, n) is not listed (the kernel traps on it where the
    row is masked in).  Inside a destination, the +1 entries come first,
    then the -1 entries, each in row order.  Returns (ptr int32[n + 1], ent
    int32[2N]): destination d's entries are ent[ptr[d]:ptr[d + 1]]; ent
    beyond ptr[n] is unused."""
    N = past.shape[0]
    dev = past.device
    rows = torch.arange(N, device=dev, dtype=torch.int32)
    listed = (past != rows) | (fut != rows)
    ends = torch.cat([past, fut])
    key = torch.where(listed.repeat(2) & (ends >= 0) & (ends < n), ends, n)
    skey, order = torch.sort(key, stable=True)
    ptr = torch.searchsorted(skey, torch.arange(n + 1, device=dev, dtype=torch.int32),
                             out_int32=True)
    return ptr, order.to(torch.int32)


def segment_incidence(past, fut, n):
    """segment_incidence_reference's incidence of int32 past/fut [N] over n
    destination rows: on a CUDA tensor one call of the build kernels (a
    memset and four launches from C; bitwise the same; no host
    synchronisation), on a CPU tensor the plain version.  Counted in
    BUILDS."""
    N = past.shape[0]
    if 2 * N >= 2 ** 31 or n >= 2 ** 31 - 1:
        raise ValueError(f"segment_incidence: {N} rows overflow the int32 entries")
    if not _dispatch(past):
        BUILDS["segment_incidence"] += 1
        return segment_incidence_reference(past, fut, n)
    for label, t in (("past", past), ("fut", fut)):
        if t.device != past.device or t.dtype != torch.int32 or tuple(t.shape) != (N,):
            raise TypeError(f"segment_incidence: {label} must be int32[{N}] on {past.device}, "
                            f"got {t.dtype}{list(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"segment_incidence: {label} is not contiguous")
    # ptr, ent and the kernel's scratch (cursors, unsorted lists) in one buffer
    buf = torch.empty(2 * (n + 1 + 2 * N), dtype=torch.int32, device=past.device)
    ptr, ent = buf[:n + 1], buf[n + 1:n + 1 + 2 * N]
    at = buf.data_ptr()
    with torch.cuda.device(past.device):
        rc = _build.load().tm_segment_incidence(
            past.data_ptr(), fut.data_ptr(), at, at + 4 * (n + 1), at + 4 * (n + 1 + 2 * N), N,
            n, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segment_incidence kernel launch failed: CUDA error {rc}")
    BUILDS["segment_incidence"] += 1
    return ptr, ent


def kernel_incidence(past, fut, n):
    """segment_incidence where the signed_segment_sum kernel will read it
    (past on a CUDA device), else None: the plain version reads none."""
    return segment_incidence(past, fut, n) if past.device.type == "cuda" else None


def edge_gru_reference(h, past, fut, edge_mask, w_ih, w_hh, b_ih, b_hh):
    """ns = h[past] - h[fut] on edge rows (0 elsewhere), then the
    torch-order GRU cell on every row (pallas_mp.py:41-51): weights [H, 3H]
    with column blocks [r | z | n]."""
    ns = gather_diff_reference(h, past, fut, edge_mask)
    H = h.shape[1]
    gi = ns @ w_ih + b_ih
    gh = h @ w_hh + b_hh
    r = torch.sigmoid(gi[:, :H] + gh[:, :H])
    z = torch.sigmoid(gi[:, H:2 * H] + gh[:, H:2 * H])
    n = torch.tanh(gi[:, 2 * H:] + r * gh[:, 2 * H:])
    return (1.0 - z) * n + z * h


# ---------------------------------------------------------------- wrappers ----
def _check_cuda_inputs(name, h, past, fut, edge_mask):
    if h.dim() != 2 or h.dtype != torch.float32:
        raise TypeError(f"{name}: h must be f32[N, H], got {h.dtype}{list(h.shape)}")
    N, H = h.shape
    if H % 4 != 0:
        raise ValueError(f"{name}: hidden width {H} is not a multiple of 4")
    for label, t, dtypes in (("past", past, (torch.int32,)), ("fut", fut, (torch.int32,)),
                             ("edge_mask", edge_mask, (torch.bool, torch.uint8))):
        if t.device != h.device:
            raise ValueError(f"{name}: {label} is on {t.device}, h on {h.device}")
        if t.dtype not in dtypes or tuple(t.shape) != (N,):
            raise TypeError(f"{name}: {label} must be {dtypes}[{N}], got {t.dtype}{list(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} is not contiguous")
    if not h.is_contiguous() or h.data_ptr() % 16 != 0:
        raise ValueError(f"{name}: h must be contiguous and 16-byte aligned")


def _dispatch(h):
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor."""
    if h.device.type == "cpu":
        return False
    if h.device.type != "cuda":
        raise ValueError(f"no kernel for device {h.device}")
    return True


def _gather_rows(name, h, past, fut, edge_mask, width):
    """The gather kernel (`name`: gather_diff or gather_concat) into a fresh
    f32[N, width]; h checked."""
    _check_cuda_inputs(name, h, past, fut, edge_mask)
    N, H = h.shape
    out = torch.empty(N, width, dtype=torch.float32, device=h.device)
    if N == 0:
        return out
    with torch.cuda.device(h.device):
        rc = getattr(_build.load(), f"tm_{name}")(
            h.data_ptr(), past.data_ptr(), fut.data_ptr(), edge_mask.data_ptr(),
            out.data_ptr(), N, H, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    return out


def gather_diff_raw(h, past, fut, edge_mask):
    """out[k] = edge_mask[k] ? h[past[k]] - h[fut[k]] : 0, without autograd:
    the kernel on a CUDA tensor, the plain version on a CPU tensor.

    past/fut of every edge row must lie in [0, N); on the card an index
    outside traps the kernel, and the next synchronisation raises."""
    if not _dispatch(h):
        return gather_diff_reference(h, past, fut, edge_mask)
    return _gather_rows("gather_diff", h, past, fut, edge_mask, h.shape[1])


def gather_concat_raw(h, past, fut, edge_mask):
    """out[k] = edge_mask[k] ? [h[past[k]] | h[fut[k]]] : 0 (f32[N, 2H]),
    without autograd: the kernel's concat mode on a CUDA tensor, the plain
    version on a CPU tensor.  Indices as gather_diff_raw."""
    if not _dispatch(h):
        return gather_concat_reference(h, past, fut, edge_mask)
    return _gather_rows("gather_concat", h, past, fut, edge_mask, 2 * h.shape[1])


def _check_incidence(name, h, inc, n):
    ptr, ent = inc
    for label, t in (("inc ptr", ptr), ("inc entries", ent)):
        if t.device != h.device or t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{name}: {label} must be int32[...] on {h.device}, got "
                            f"{t.dtype}{list(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} is not contiguous")
    if ptr.shape[0] != n + 1:
        raise ValueError(f"{name}: inc ptr has {ptr.shape[0]} offsets, expected {n + 1}")


def _pull(name, h, past, fut, edge_mask, n, inc, H):
    """The pull kernel (`name`: signed_segment_sum, or segment_sum_halves
    over h [N, 2H]) into a fresh f32[n, H] through `inc` (built here for the
    call when None)."""
    _check_cuda_inputs(name, h, past, fut, edge_mask)
    N = h.shape[0]
    if inc is None:
        inc = segment_incidence(past, fut, n)
    _check_incidence(name, h, inc, n)
    ptr, ent = inc
    out = torch.empty(n, H, dtype=torch.float32, device=h.device)
    if n == 0:
        return out
    with torch.cuda.device(h.device):
        rc = getattr(_build.load(), f"tm_{name}")(
            h.data_ptr(), past.data_ptr(), fut.data_ptr(), edge_mask.data_ptr(), ptr.data_ptr(),
            ent.data_ptr(), ent.numel(), out.data_ptr(), N, n, H,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    return out


def signed_segment_sum_raw(h, past, fut, edge_mask, n, inc=None):
    """out[d] = sum over edges e with past(e)=d of h[e] minus the sum over
    edges with fut(e)=d; out is f32[n, H].  Without autograd: the kernel on
    a CUDA tensor, the plain version on a CPU tensor.  On the card the
    kernel pulls each row's terms through `inc`, the segment_incidence of
    past/fut (one launch; built here for the call when None) and sums them
    in f64, rounded to f32 once.  past/fut of every edge row must lie in
    [0, n); on the card an index outside traps the kernel, and the next
    synchronisation raises."""
    if not _dispatch(h):
        return signed_segment_sum_reference(h, past, fut, edge_mask, n)
    return _pull("signed_segment_sum", h, past, fut, edge_mask, n, inc, h.shape[1])


def segment_sum_halves_raw(g, past, fut, edge_mask, n, inc=None):
    """out[d] = sum over edges e with past(e)=d of g[e, :H] plus the sum over
    edges with fut(e)=d of g[e, H:]; g f32[N, 2H], out f32[n, H].  Without
    autograd: the pull kernel's halves mode on a CUDA tensor (through `inc`
    as signed_segment_sum_raw, one launch, f64 sums rounded once), the plain
    version on a CPU tensor."""
    if not _dispatch(g):
        return segment_sum_halves_reference(g, past, fut, edge_mask, n)
    if g.dim() != 2 or g.shape[1] % 8 != 0:
        raise ValueError(f"segment_sum_halves: g must be f32[N, 2H] with H a multiple of 4, "
                         f"got {list(g.shape)}")
    return _pull("segment_sum_halves", g, past, fut, edge_mask, n, inc, g.shape[1] // 2)


class GatherDiff(torch.autograd.Function):
    """gather_diff_raw; its VJP is the signed scatter of the cotangent back
    to the endpoints (pallas_mp.py:247-253), through `inc` where given."""

    @staticmethod
    def forward(ctx, h, past, fut, edge_mask, inc_ptr, inc_ent):
        ctx.save_for_backward(past, fut, edge_mask, inc_ptr, inc_ent)
        ctx.n = h.shape[0]
        return gather_diff_raw(h, past, fut, edge_mask)

    @staticmethod
    def backward(ctx, g):
        past, fut, edge_mask, inc_ptr, inc_ent = ctx.saved_tensors
        inc = None if inc_ptr is None else (inc_ptr, inc_ent)
        return (signed_segment_sum_raw(g.contiguous(), past, fut, edge_mask, ctx.n, inc),
                None, None, None, None, None)


class SignedSegmentSum(torch.autograd.Function):
    """signed_segment_sum_raw; its VJP is the gather-diff of the cotangent
    (pallas_mp.py:275-281).  That backward needs n == N, as the row layout
    has it (the kernel indexes the cotangent by edge row), so
    signed_segment_sum refuses a gradient for any other n on every
    device."""

    @staticmethod
    def forward(ctx, h, past, fut, edge_mask, n, inc_ptr, inc_ent):
        ctx.save_for_backward(past, fut, edge_mask)
        inc = None if inc_ptr is None else (inc_ptr, inc_ent)
        return signed_segment_sum_raw(h, past, fut, edge_mask, n, inc)

    @staticmethod
    def backward(ctx, g):
        past, fut, edge_mask = ctx.saved_tensors
        return (gather_diff_raw(g.contiguous(), past, fut, edge_mask),
                None, None, None, None, None, None)


class GatherConcat(torch.autograd.Function):
    """gather_concat_raw; its VJP is segment_sum_halves_raw of the cotangent
    back to the endpoints, through `inc` where given."""

    @staticmethod
    def forward(ctx, h, past, fut, edge_mask, inc_ptr, inc_ent):
        ctx.save_for_backward(past, fut, edge_mask, inc_ptr, inc_ent)
        ctx.n = h.shape[0]
        return gather_concat_raw(h, past, fut, edge_mask)

    @staticmethod
    def backward(ctx, g):
        past, fut, edge_mask, inc_ptr, inc_ent = ctx.saved_tensors
        inc = None if inc_ptr is None else (inc_ptr, inc_ent)
        return (segment_sum_halves_raw(g.contiguous(), past, fut, edge_mask, ctx.n, inc),
                None, None, None, None, None)


def gather_concat(h, past, fut, edge_mask, inc=None):
    """msg concat's node support, differentiable in h (GatherConcat).  inc:
    the segment_incidence of past/fut, for the backward's halves pull."""
    return GatherConcat.apply(h, past, fut, edge_mask, *(inc or (None, None)))


def gather_diff(h, past, fut, edge_mask, inc=None):
    """node_support, differentiable in h (GatherDiff).  inc: the
    segment_incidence of past/fut, for the backward's signed_segment_sum."""
    return GatherDiff.apply(h, past, fut, edge_mask, *(inc or (None, None)))


def signed_segment_sum(h, past, fut, edge_mask, n, inc=None):
    """edge_support, differentiable in h (SignedSegmentSum) where n equals
    h's row count; for another n it raises if a gradient is wanted.  inc:
    the segment_incidence of past/fut over n rows (built for the call on the
    card when None)."""
    if torch.is_grad_enabled() and h.requires_grad and n != h.shape[0]:
        raise ValueError(f"signed_segment_sum: a gradient needs n == N, got n {n}, "
                         f"N {h.shape[0]}")
    return SignedSegmentSum.apply(h, past, fut, edge_mask, n, *(inc or (None, None)))


def _check_gru_weights(h, w_ih, w_hh, b_ih, b_hh):
    H = h.shape[1]
    for label, t, shape in (("w_ih", w_ih, (H, 3 * H)), ("w_hh", w_hh, (H, 3 * H)),
                            ("b_ih", b_ih, (3 * H,)), ("b_hh", b_hh, (3 * H,))):
        if t.device != h.device:
            raise ValueError(f"fused_edge_gru: {label} is on {t.device}, h on {h.device}")
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise TypeError(f"fused_edge_gru: {label} must be f32{list(shape)}, got "
                            f"{t.dtype}{list(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16 != 0:
            raise ValueError(f"fused_edge_gru: {label} must be contiguous and 16-byte aligned")


def fused_edge_gru(h, past, fut, edge_mask, w_ih, w_hh, b_ih, b_hh):
    """edge_gru_reference's function in one launch of the kernel on a CUDA
    tensor, the plain version on a CPU tensor.  Forward only, as the TPU
    kernel: it raises where autograd would need a gradient (grad enabled and
    an input requiring grad) on every device.  h f32[N, H] with H a
    multiple of 4 on the card; any N.  past/fut of every edge row must lie
    in [0, N); on the card an index outside traps the kernel, and the next
    synchronisation raises."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (h, w_ih, w_hh, b_ih, b_hh)):
        raise RuntimeError("fused_edge_gru has no backward (as pallas_mp.fused_edge_gru); "
                           "run it under torch.no_grad() / inference_mode, or take "
                           "gather_diff + models.nn.gru_cell where a gradient is needed")
    if not _dispatch(h):
        return edge_gru_reference(h, past, fut, edge_mask, w_ih, w_hh, b_ih, b_hh)
    _check_cuda_inputs("fused_edge_gru", h, past, fut, edge_mask)
    _check_gru_weights(h, w_ih, w_hh, b_ih, b_hh)
    N, H = h.shape
    out = torch.empty_like(h)
    if N == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(h.device):
        key = (h.device.index, H)
        if key not in _EDGE_GRU_CTAS:
            cap = ctypes.c_int(0)
            rc = lib.tm_fused_edge_gru_setup(H, ctypes.addressof(cap))
            if rc != 0:
                raise RuntimeError(f"fused_edge_gru kernel setup failed: CUDA error {rc}")
            _EDGE_GRU_CTAS[key] = cap.value
        rc = lib.tm_fused_edge_gru(
            h.data_ptr(), past.data_ptr(), fut.data_ptr(), edge_mask.data_ptr(),
            w_ih.data_ptr(), w_hh.data_ptr(), b_ih.data_ptr(), b_hh.data_ptr(),
            out.data_ptr(), N, H, _EDGE_GRU_CTAS[key], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_edge_gru kernel launch failed: CUDA error {rc}")
    LAUNCHES["fused_edge_gru"] += 1
    return out
