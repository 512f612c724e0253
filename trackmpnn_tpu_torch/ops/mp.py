"""Message-passing ops of the serving path (the counterpart of
trackmpnn_tpu/ops/pallas_mp.py's gather_diff, signed_segment_sum and
fused_edge_gru).

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

LAUNCHES = {"gather_diff": 0, "signed_segment_sum": 0, "fused_edge_gru": 0}
_EDGE_GRU_CTAS: dict = {}  # (device index, H) -> the kernel's grid cap, set up once


# -------------------------------------------------------------- references ----
def gather_diff_reference(h, past, fut, edge_mask):
    """node_support: per edge row, h[past] - h[fut]; zero elsewhere."""
    diff = h.index_select(0, past) - h.index_select(0, fut)
    return torch.where(edge_mask.bool()[:, None], diff, 0.0)


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


def gather_diff_raw(h, past, fut, edge_mask):
    """out[k] = edge_mask[k] ? h[past[k]] - h[fut[k]] : 0, without autograd:
    the kernel on a CUDA tensor, the plain version on a CPU tensor.

    past/fut of every edge row must lie in [0, N); on the card an index
    outside traps the kernel, and the next synchronisation raises."""
    if not _dispatch(h):
        return gather_diff_reference(h, past, fut, edge_mask)
    _check_cuda_inputs("gather_diff", h, past, fut, edge_mask)
    N, H = h.shape
    out = torch.empty_like(h)
    if N == 0:
        return out
    with torch.cuda.device(h.device):
        rc = _build.load().tm_gather_diff(
            h.data_ptr(), past.data_ptr(), fut.data_ptr(), edge_mask.data_ptr(),
            out.data_ptr(), N, H, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gather_diff kernel launch failed: CUDA error {rc}")
    LAUNCHES["gather_diff"] += 1
    return out


def signed_segment_sum_raw(h, past, fut, edge_mask, n):
    """out[d] = sum over edges e with past(e)=d of h[e] minus the sum over
    edges with fut(e)=d; out is f32[n, H].  Without autograd: the kernel on
    a CUDA tensor, the plain version on a CPU tensor.  On the card the sums
    run in f64 atomics into a scratch this wrapper allocates, rounded to f32
    once.  past/fut of every edge row must lie in [0, n); on the card an
    index outside traps the kernel, and the next synchronisation raises."""
    if not _dispatch(h):
        return signed_segment_sum_reference(h, past, fut, edge_mask, n)
    _check_cuda_inputs("signed_segment_sum", h, past, fut, edge_mask)
    N, H = h.shape
    out = torch.empty(n, H, dtype=torch.float32, device=h.device)
    if n == 0:
        return out
    scratch = torch.empty(n, H, dtype=torch.float64, device=h.device)
    with torch.cuda.device(h.device):
        rc = _build.load().tm_signed_segment_sum(
            h.data_ptr(), past.data_ptr(), fut.data_ptr(), edge_mask.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), N, n, H,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"signed_segment_sum kernel launch failed: CUDA error {rc}")
    LAUNCHES["signed_segment_sum"] += 1
    return out


class GatherDiff(torch.autograd.Function):
    """gather_diff_raw; its VJP is the signed scatter of the cotangent back
    to the endpoints (pallas_mp.py:247-253)."""

    @staticmethod
    def forward(ctx, h, past, fut, edge_mask):
        ctx.save_for_backward(past, fut, edge_mask)
        ctx.n = h.shape[0]
        return gather_diff_raw(h, past, fut, edge_mask)

    @staticmethod
    def backward(ctx, g):
        past, fut, edge_mask = ctx.saved_tensors
        return signed_segment_sum_raw(g.contiguous(), past, fut, edge_mask, ctx.n), None, None, None


class SignedSegmentSum(torch.autograd.Function):
    """signed_segment_sum_raw; its VJP is the gather-diff of the cotangent
    (pallas_mp.py:275-281).  That backward needs n == N, as the row layout
    has it (the kernel indexes the cotangent by edge row), so
    signed_segment_sum refuses a gradient for any other n on every
    device."""

    @staticmethod
    def forward(ctx, h, past, fut, edge_mask, n):
        ctx.save_for_backward(past, fut, edge_mask)
        return signed_segment_sum_raw(h, past, fut, edge_mask, n)

    @staticmethod
    def backward(ctx, g):
        past, fut, edge_mask = ctx.saved_tensors
        return gather_diff_raw(g.contiguous(), past, fut, edge_mask), None, None, None, None


def gather_diff(h, past, fut, edge_mask):
    """node_support, differentiable in h (GatherDiff)."""
    return GatherDiff.apply(h, past, fut, edge_mask)


def signed_segment_sum(h, past, fut, edge_mask, n):
    """edge_support, differentiable in h (SignedSegmentSum) where n equals
    h's row count; for another n it raises if a gradient is wanted."""
    if torch.is_grad_enabled() and h.requires_grad and n != h.shape[0]:
        raise ValueError(f"signed_segment_sum: a gradient needs n == N, got n {n}, "
                         f"N {h.shape[0]}")
    return SignedSegmentSum.apply(h, past, fut, edge_mask, n)


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
