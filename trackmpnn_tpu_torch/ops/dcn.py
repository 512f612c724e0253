"""The bounded modulated deformable convolution (the counterpart of
trackmpnn_tpu/ops/pallas_dcn.py's deform_conv2d_shift_pallas and of the
custom VJP of backbones/deform_conv.py's deform_conv2d_shift).

DCNv2 with 3x3 taps, stride 1, padding 1 and dilation 1, the JAX package's
layouts: x [N, H, W, C]; weight [9*C, O], row k*C + c for tap k = kh*3 + kw;
offset [N, H, W, 18] as (dy, dx) per tap; mask [N, H, W, 9], already
sigmoided.  Each offset is clamped to [-max_offset, max_offset]; tap k of
pixel (y, x) samples x bilinearly at (y - 1 + kh + dy, x - 1 + kw + dx),
zeros outside the image, times the mask, and the columns [N, H, W, 9*C]
are contracted with the weight.

Three kernels (csrc/dcn_kernels.cu):
  dcn_fwd         sample, mask and contract in one pass, plus the bias;
  dcn_bwd_sample  d weight = columns^T g with the columns built on chip, and
                  d offset and d mask from the columns' cotangent
                  g @ weight.T;
  dcn_bwd_dx      d x, gathered for each block of input pixels over lists of
                  the output pixels whose samples reach it (no atomics).
d bias and the columns' cotangent are torch.matmul / sum, as XLA's products
are in the JAX package.

Each kernel has
  * a plain PyTorch version (`*_reference`): the shift-sum formula of the
    JAX function (deform_conv.py:110-150 and its VJP :159-252), the
    semantics the tests hold against the JAX package and the version a CPU
    tensor gets;
  * for a CUDA tensor a wrapper that checks its inputs and launches the
    hand-written kernel, or raises.  It never falls back to the plain
    version on the card;
  * a launch counter, LAUNCHES[name], raised by one where a kernel is
    launched and nowhere else.
DeformConvShift is the autograd Function over them.  Its offset gradient is
the JAX VJP's: the hat derivative -sign(dy - u) where relu(1 - |dy - u|) > 0,
so it is exactly 0 at an integer offset (not the floor-based derivative of
the exact gather).
"""

from __future__ import annotations

import ctypes
import math

import torch

from trackmpnn_tpu_torch.ops import _build
from trackmpnn_tpu_torch.ops.block import _check, _on_cuda, _stream

LAUNCHES = {"dcn_fwd": 0, "dcn_bwd_sample": 0, "dcn_bwd_dx": 0}
TAPS = 9
MAX_REACH = 8  # R = ceil(max_offset) the kernels take: (2R+2)^2 = 324 shifts


def reach(max_offset) -> int:
    """R = ceil(max_offset), the integer shifts a clamped offset can reach."""
    m = float(max_offset)
    if not (math.isfinite(m) and m >= 0.0):
        raise ValueError(f"max_offset must be finite and >= 0, got {max_offset!r}")
    R = math.ceil(m)
    if R > MAX_REACH:
        raise ValueError(f"max_offset {m} reaches {R} pixels; the kernels take at most "
                         f"{MAX_REACH}")
    return R


# -------------------------------------------------------------- references ----
def _hat(d, R):
    """(relu(1 - |d - u|), its derivative in d) for the shifts u = -R .. R+1,
    on a new last axis.  The derivative is -sign(d - u) where 1 - |d - u| > 0,
    else 0 (the JAX VJP's, deform_conv.py:240-241)."""
    u = torch.arange(-R, R + 2, device=d.device, dtype=d.dtype)
    t = d[..., None] - u
    a = 1.0 - t.abs()
    return torch.relu(a), torch.where(a > 0, -torch.sign(t), 0.0)


def _clip_grad(o, m):
    """d clip(o, -m, m) / d o as jnp.clip has it: 1 inside, 1/2 at the bound."""
    a = o.abs()
    return torch.where(a < m, 1.0, torch.where(a == m, 0.5, 0.0))


def _padded(x, R):
    """x [N, H, W, C] zero-padded by R+1 before and R+2 after each image
    dimension: window (a, b) of tap (kh, kw) at pixel (y, x) is then padded
    pixel (y + kh + a, x + kw + b), i.e. shift u = a - R from the tap's base."""
    return torch.nn.functional.pad(x, (0, 0, R + 1, R + 2, R + 1, R + 2))


def _windows(xp, H, W, S, kh, kw):
    """The (S, S) windows of tap (kh, kw) over a padded image, as a view
    [N, H, W, S, S, C] (no copy)."""
    N, _, _, C = xp.shape
    sN, sH, sW, sC = xp.stride()
    return xp.as_strided((N, H, W, S, S, C), (sN, sH, sW, sH, sW, sC),
                         xp.storage_offset() + kh * sH + kw * sW)


def _clamped(offset, max_offset):
    N, H, W, _ = offset.shape
    off = offset.reshape(N, H, W, TAPS, 2)
    m = float(max_offset)
    return off[..., 0].clamp(-m, m), off[..., 1].clamp(-m, m)


def dcn_forward_reference(x, weight, bias, offset, mask, max_offset):
    """out [N, H, W, O]: sum over taps of (mask * shift-sum sample) @ the
    tap's weight rows, plus bias (deform_conv2d_shift, deform_conv.py:110)."""
    N, H, W, C = x.shape
    R = reach(max_offset)
    S = 2 * R + 2
    dy, dx = _clamped(offset, max_offset)
    wy, _ = _hat(dy, R)  # [N, H, W, 9, S]
    wx, _ = _hat(dx, R)
    xp = _padded(x, R)
    w3 = weight.reshape(TAPS, C, -1)
    out = None
    for k in range(TAPS):
        w2 = wy[..., k, :, None] * wx[..., k, None, :]
        sample = (w2[..., None] * _windows(xp, H, W, S, k // 3, k % 3)).sum((3, 4))
        term = (sample * mask[..., k, None]) @ w3[k]
        out = term if out is None else out + term
    return out if bias is None else out + bias


def dcn_sample_backward_reference(x, offset, mask, dcols, g, max_offset):
    """(d weight [9*C, O], d offset [N, H, W, 18], d mask [N, H, W, 9]) for
    the columns' cotangent dcols [N, H, W, 9*C] and the output's g [N, H, W,
    O]: the columns as the forward samples them, then columns^T g."""
    cols, doff, dmask = _sample_transpose(x, offset, mask, dcols, max_offset)
    C9, O = cols.shape[-1], g.shape[-1]
    return cols.reshape(-1, C9).t() @ g.reshape(-1, O), doff, dmask


def _sample_transpose(x, offset, mask, dcols, max_offset):
    """(cols [N, H, W, 9*C], d offset, d mask) of the shift-sum formula."""
    N, H, W, C = x.shape
    R = reach(max_offset)
    S = 2 * R + 2
    m = float(max_offset)
    dy, dx = _clamped(offset, max_offset)
    wy, dwy = _hat(dy, R)
    wx, dwx = _hat(dx, R)
    xp = _padded(x, R)
    g = dcols.reshape(N, H, W, TAPS, C)
    cols, ddy, ddx, dmask = [], [], [], []
    for k in range(TAPS):
        win = _windows(xp, H, W, S, k // 3, k % 3)
        wyk, wxk, mk = wy[..., k, :], wx[..., k, :], mask[..., k]
        sample = ((wyk[..., :, None] * wxk[..., None, :])[..., None] * win).sum((3, 4))
        cols.append(sample * mk[..., None])
        dmask.append((sample * g[..., k, :]).sum(-1))
        r = (win * g[..., k, None, None, :]).sum(-1)  # [N, H, W, S, S]
        ddy.append(mk * (dwy[..., k, :, None] * wxk[..., None, :] * r).sum((3, 4)))
        ddx.append(mk * (wyk[..., :, None] * dwx[..., k, None, :] * r).sum((3, 4)))
    doff = torch.stack([torch.stack(ddy, -1), torch.stack(ddx, -1)], -1)
    doff = doff * _clip_grad(offset.reshape(N, H, W, TAPS, 2), m)
    return (torch.stack(cols, 3).reshape(N, H, W, TAPS * C), doff.reshape(N, H, W, 2 * TAPS),
            torch.stack(dmask, -1))


def dcn_dx_reference(offset, mask, dcols, max_offset):
    """d x [N, H, W, C]: every shifted window's weighted cotangent added
    back at its shift (the transpose of a shift is the opposite shift)."""
    N, H, W, C9 = dcols.shape
    C = C9 // TAPS
    R = reach(max_offset)
    S = 2 * R + 2
    dy, dx = _clamped(offset, max_offset)
    wy, _ = _hat(dy, R)
    wx, _ = _hat(dx, R)
    g = dcols.reshape(N, H, W, TAPS, C)
    dxp = dcols.new_zeros(N, H + 2 * R + 3, W + 2 * R + 3, C)
    for k in range(TAPS):
        kh, kw = k // 3, k % 3
        gk = g[..., k, :] * mask[..., k, None]
        for a in range(S):
            for b in range(S):
                w2 = wy[..., k, a] * wx[..., k, b]
                dxp[:, kh + a:kh + a + H, kw + b:kw + b + W] += w2[..., None] * gk
    return dxp[:, R + 1:R + 1 + H, R + 1:R + 1 + W]


# ---------------------------------------------------------------- wrappers ----
def _dims(name, x, offset, mask):
    if x.dim() != 4:
        raise TypeError(f"{name}: x must be f32[N, H, W, C], got {list(x.shape)}")
    N, H, W, C = x.shape
    f32 = torch.float32
    _check(name, x.device, x=(x, f32, (N, H, W, C)), offset=(offset, f32, (N, H, W, 2 * TAPS)),
           mask=(mask, f32, (N, H, W, TAPS)))
    return N, H, W, C


def _pixels(N, H, W):
    """The kernels index pixels with 32-bit integers (an offset array of 2^31
    pixels would alone take 154 GB)."""
    if N * H * W >= 2**31:
        raise ValueError(f"dcn: {N} x {H} x {W} pixels; the kernels take fewer than 2^31")


def _scratch(query, device, *dims):
    """The scratch a kernel asks for on this device (at least one float)."""
    n = ctypes.c_int64(0)
    rc = query(*dims, ctypes.addressof(n))
    if rc != 0:
        raise RuntimeError(f"dcn scratch query failed: CUDA error {rc}")
    return torch.empty(max(n.value, 1), dtype=torch.float32, device=device)


def _launch(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _fwd_cuda(x, weight, bias, offset, mask, max_offset):
    N, H, W, C = _dims("dcn_fwd", x, offset, mask)
    if weight.dim() != 2:
        raise TypeError(f"dcn_fwd: weight must be f32[9*C, O], got {list(weight.shape)}")
    O = weight.shape[1]
    _check("dcn_fwd", x.device, weight=(weight, torch.float32, (TAPS * C, O)))
    if bias is not None:
        _check("dcn_fwd", x.device, bias=(bias, torch.float32, (O,)))
    reach(max_offset)
    out = torch.empty(N, H, W, O, dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    _pixels(N, H, W)
    with torch.cuda.device(x.device):
        lib = _build.load("dcn")
        scratch = _scratch(lib.tm_dcn_fwd_scratch_floats, x.device, N, H, W, C, O)
        rc = lib.tm_dcn_fwd(
            x.data_ptr(), weight.data_ptr(), None if bias is None else bias.data_ptr(),
            offset.data_ptr(), mask.data_ptr(), out.data_ptr(), scratch.data_ptr(), N, H, W, C,
            O, float(max_offset), _stream())
    _launch("dcn_fwd", rc)
    return out


def _sample_cuda(x, offset, mask, dcols, g, max_offset):
    N, H, W, C = _dims("dcn_bwd_sample", x, offset, mask)
    if g.dim() != 4:
        raise TypeError(f"dcn_bwd_sample: g must be f32[N, H, W, O], got {list(g.shape)}")
    O = g.shape[3]
    _check("dcn_bwd_sample", x.device, dcols=(dcols, torch.float32, (N, H, W, TAPS * C)),
           g=(g, torch.float32, (N, H, W, O)))
    reach(max_offset)
    dweight = torch.empty(TAPS * C, O, dtype=torch.float32, device=x.device)
    doff = torch.empty_like(offset)
    dmask = torch.empty_like(mask)
    if x.numel() == 0 or O == 0:  # no sample, or no cotangent: every gradient is 0
        return dweight.zero_(), doff.zero_(), dmask.zero_()
    _pixels(N, H, W)
    with torch.cuda.device(x.device):
        lib = _build.load("dcn")
        scratch = _scratch(lib.tm_dcn_bwd_sample_scratch_floats, x.device, N, H, W, C, O)
        rc = lib.tm_dcn_bwd_sample(
            x.data_ptr(), offset.data_ptr(), mask.data_ptr(), dcols.data_ptr(), g.data_ptr(),
            dweight.data_ptr(), doff.data_ptr(), dmask.data_ptr(), scratch.data_ptr(), N, H, W,
            C, O, float(max_offset), _stream())
    _launch("dcn_bwd_sample", rc)
    return dweight, doff, dmask


def _dx_cuda(offset, mask, dcols, max_offset):
    if dcols.dim() != 4 or dcols.shape[3] % TAPS != 0:
        raise TypeError(f"dcn_bwd_dx: dcols must be f32[N, H, W, 9*C], got "
                        f"{list(dcols.shape)}")
    N, H, W, C9 = dcols.shape
    C = C9 // TAPS
    f32 = torch.float32
    _check("dcn_bwd_dx", dcols.device, dcols=(dcols, f32, (N, H, W, C9)),
           offset=(offset, f32, (N, H, W, 2 * TAPS)), mask=(mask, f32, (N, H, W, TAPS)))
    R = reach(max_offset)
    dx = torch.empty(N, H, W, C, dtype=f32, device=dcols.device)
    if dx.numel() == 0:
        return dx
    with torch.cuda.device(dcols.device):
        rc = _build.load("dcn").tm_dcn_bwd_dx(
            offset.data_ptr(), mask.data_ptr(), dcols.data_ptr(), dx.data_ptr(), N, H, W, C, R,
            float(max_offset), _stream())
    _launch("dcn_bwd_dx", rc)
    return dx


def dcn_forward(x, weight, bias, offset, mask, max_offset):
    """The forward: the kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    fn = _fwd_cuda if _on_cuda(x) else dcn_forward_reference
    return fn(x, weight, bias, offset, mask, max_offset)


def dcn_sample_backward(x, offset, mask, dcols, g, max_offset):
    """(d weight, d offset, d mask): the kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    fn = _sample_cuda if _on_cuda(x) else dcn_sample_backward_reference
    return fn(x, offset, mask, dcols, g, max_offset)


def dcn_dx(offset, mask, dcols, max_offset):
    """d x: the kernel on a CUDA tensor, the plain version on a CPU tensor."""
    fn = _dx_cuda if _on_cuda(dcols) else dcn_dx_reference
    return fn(offset, mask, dcols, max_offset)


class DeformConvShift(torch.autograd.Function):
    """deform_conv_shift(...), differentiable in x, weight, bias, offset and
    mask with the hand-written sampling transpose."""

    @staticmethod
    def forward(ctx, x, weight, bias, offset, mask, max_offset):
        ctx.max_offset = max_offset
        ctx.has_bias = bias is not None
        ctx.save_for_backward(x, weight, offset, mask)
        return dcn_forward(x, weight, bias, offset, mask, max_offset)

    @staticmethod
    def backward(ctx, g):
        x, weight, offset, mask = ctx.saved_tensors
        N, H, W, C = x.shape
        O = weight.shape[1]
        g = g.contiguous()
        g2 = g.reshape(-1, O)
        dcols = (g2 @ weight.t()).reshape(N, H, W, TAPS * C)
        dweight, doff, dmask = dcn_sample_backward(x, offset, mask, dcols, g, ctx.max_offset)
        dx = dcn_dx(offset, mask, dcols, ctx.max_offset)
        dbias = g2.sum(0) if ctx.has_bias else None
        return dx, dweight, dbias, doff, dmask, None


def deform_conv_shift(x, weight, bias, offset, mask, max_offset):
    """Bounded modulated deformable convolution (deform_conv2d_shift_pallas,
    pallas_dcn.py:96, batched): x f32[N, H, W, C], weight [9*C, O], bias
    [O] or None, offset [N, H, W, 18], mask [N, H, W, 9] -> [N, H, W, O],
    differentiable in every tensor."""
    return DeformConvShift.apply(x.contiguous(), weight.contiguous(), bias,
                                 offset.contiguous(), mask.contiguous(), max_offset)
