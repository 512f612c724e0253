"""The arithmetic and the width rule of the port's fused round kernels
(trackmpnn_tpu_torch/csrc/round_kernels.cu), on the CPU.

The kernels run the round's GRU products on the tensor cores in split TF32
(3xTF32: x = big + small, a b ~ a.small b.big + a.big b.small + a.big b.big),
each k step of 8 into a fresh accumulator added in f32:
  * round_gru_kernel: r and z take x w_ih, then h w_hh, each k step; gi_n
    and gh_n their own sums;
  * round_dgx_kernel: d xin = d gi w_ih^T and d gh w_hh^T over K = 3H, the
    products of kDgxSteps k steps into one fresh accumulator;
  * round_dw_kernel: per kind the split-K products xin^T d gi and h^T d gh
    over the kind's rows in increasing order, in stages of 64 rows cut into
    S slices, k steps of 8 rows, the slices' partials added in slice order;
    the bias gradients summed in row order the same way.
Here that arithmetic and tiling are emulated in PyTorch f32 (TF32 rounding on
the int32 view, as the kernels do) and held against the JAX package's
fused_round in interpret mode and its VJP, at the widths the first design
refused (H 48 and 128) and at H 64, with tests/test_torch_round_ops.py's
tolerances: the forward within atol 1e-5, the gradients within rtol 1e-4
and atol 1e-5 x each gradient's largest entry.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import ROUND_KEYS as KEYS
from torch_port_util import hub_round_inputs, mm_3xtf32, round_inputs
from trackmpnn_tpu.ops import pallas_round as PR
from trackmpnn_tpu_torch.ops import round as rnd

torch.set_num_threads(1)

K_STEP = 8       # the mma / wgmma depth
DGX_STEPS = 4    # round_dgx_kernel: k steps into one fresh accumulator
DW_STAGE = 64    # round_dw_kernel: rows a stage
FWD_ATOL, BWD_RTOL, BWD_ATOL_SCALE = 1e-5, 1e-4, 1e-5


@pytest.fixture
def interpret_mode():
    PR._INTERPRET[0] = True
    yield
    PR._INTERPRET[0] = False


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


def gate_sums(x, h, w):
    """round_gru_kernel's products for rows x, h [n, H]: (r, z, gi_n, gh_n)
    pre-activation sums without biases, k step by k step."""
    H = h.shape[1]
    cols = [slice(g * H, (g + 1) * H) for g in range(3)]
    acc = [torch.zeros(x.shape[0], H) for _ in range(4)]
    for k in range(0, H, K_STEP):
        ks = slice(k, k + K_STEP)
        for g in range(2):  # r, z: x w_ih, then h w_hh
            acc[g] = (acc[g] + mm_3xtf32(x[:, ks], w["w_ih"][ks, cols[g]])) + mm_3xtf32(
                h[:, ks], w["w_hh"][ks, cols[g]])
        acc[2] = acc[2] + mm_3xtf32(x[:, ks], w["w_ih"][ks, cols[2]])
        acc[3] = acc[3] + mm_3xtf32(h[:, ks], w["w_hh"][ks, cols[2]])
    return acc


def gates(x, h, w):
    """r, z, n and gh_n as the kernels' epilogue forms them."""
    H = h.shape[1]
    b_rz = w["b_ih"][:2 * H] + w["b_hh"][:2 * H]
    sr, sz, sin, shn = gate_sums(x, h, w)
    r = torch.sigmoid(sr + b_rz[:H])
    z = torch.sigmoid(sz + b_rz[H:])
    ghn = shn + w["b_hh"][2 * H:]
    n = torch.tanh((sin + w["b_ih"][2 * H:]) + r * ghn)
    return r, z, n, ghn


def transposed(d4, w):
    """round_dgx_kernel: (d xin, d gh w_hh^T) of rows d4 [n, 4H]."""
    H = d4.shape[1] // 4
    dgi = d4[:, :3 * H]
    dgh = torch.cat([d4[:, :2 * H], d4[:, 3 * H:]], 1)
    dx = torch.zeros(d4.shape[0], H)
    dh = torch.zeros(d4.shape[0], H)
    for k0 in range(0, 3 * H, K_STEP * DGX_STEPS):
        px = torch.zeros_like(dx)
        ph = torch.zeros_like(dh)
        for k in range(k0, min(3 * H, k0 + K_STEP * DGX_STEPS), K_STEP):
            ks = slice(k, k + K_STEP)
            px = px + mm_3xtf32(dgi[:, ks], w["w_ih"].t()[ks])
            ph = ph + mm_3xtf32(dgh[:, ks], w["w_hh"].t()[ks])
        dx = dx + px
        dh = dh + ph
    return dx, dh


def weight_grads(xin, h, d4, slices):
    """round_dw_kernel for one kind's rows (in increasing order): per slice of
    64-row stages the products in k steps of 8 rows and the bias sums in row
    order; the partials added in slice order."""
    n, H = h.shape
    dgi = d4[:, :3 * H]
    dgh = torch.cat([d4[:, :2 * H], d4[:, 3 * H:]], 1)
    stages = math.ceil(n / DW_STAGE)
    per = math.ceil(stages / slices) if stages else 0
    total = None
    for s in range(slices):
        lo, hi = min(n, s * per * DW_STAGE), min(n, (s + 1) * per * DW_STAGE)
        part = {"w_ih": torch.zeros(H, 3 * H), "w_hh": torch.zeros(H, 3 * H),
                "b_ih": torch.zeros(3 * H), "b_hh": torch.zeros(3 * H)}
        for k in range(lo, hi, K_STEP):
            ks = slice(k, min(hi, k + K_STEP))
            part["w_ih"] = part["w_ih"] + mm_3xtf32(xin[ks].t(), dgi[ks])
            part["w_hh"] = part["w_hh"] + mm_3xtf32(h[ks].t(), dgh[ks])
        for r in range(lo, hi):
            part["b_ih"] = part["b_ih"] + dgi[r]
            part["b_hh"] = part["b_hh"] + dgh[r]
        total = part if total is None else {k: total[k] + part[k] for k in total}
    return total


def round_emulated(h, idxw, we, wn, g, slices):
    """The kernels' forward and backward of the fused round: (out, d h, d we,
    d wn); xin and the incident sums as round_prep_kernel forms them (the
    plain version's), d h by round_bwd_dh (kept: its plain version)."""
    B, cap, H = h.shape
    out_ref, xin = rnd.round_fwd_reference(h, idxw, we, wn)
    edge = ((idxw[..., 2] != 0) & (idxw[..., 3] == 0)).reshape(-1)
    det = (idxw[..., 3] != 0).reshape(-1)
    hf, xf, gf = h.reshape(-1, H), xin.reshape(-1, H), g.reshape(-1, H)
    out = torch.zeros(B * cap, H)
    d4 = torch.zeros(B * cap, 4 * H)
    dxin = torch.zeros(B * cap, H)
    ddir = torch.zeros(B * cap, H)
    dw = []
    for rows, w in ((edge.nonzero()[:, 0], we), (det.nonzero()[:, 0], wn)):
        x, hr, gr = xf[rows], hf[rows], gf[rows]
        r, z, n, ghn = gates(x, hr, w)
        out[rows] = (1.0 - z) * n + z * hr
        da_n = (1.0 - n * n) * ((1.0 - z) * gr)
        d = torch.cat([r * (1.0 - r) * (da_n * ghn), z * (1.0 - z) * ((hr - n) * gr), da_n,
                       r * da_n], 1)
        d4[rows] = d
        dx, dhh = transposed(d, w)
        dxin[rows] = dx
        ddir[rows] = z * gr + dhh
        dw.append(weight_grads(x, hr, d, slices))
    dh = rnd.round_bwd_dh_reference(idxw, dxin.reshape(B, cap, H), ddir.reshape(B, cap, H))
    return out.reshape(B, cap, H), dh, dw[0], dw[1]


@pytest.mark.parametrize("H,slices", [(48, 1), (64, 3), (128, 2)])
def test_emulated_round_kernels_match_interpret_mode_pallas(interpret_mode, H, slices):
    """H 48 and 128 (which the first design refused) and H 64: the emulated
    forward within atol 1e-5 of interpret-mode fused_round, every gradient
    within rtol 1e-4, atol 1e-5 x scale of its VJP."""
    h, idxw, we, wn, cot = round_inputs(H, B=2, cap=64, H=H)
    jwe, jwn = (jax.tree_util.tree_map(jnp.asarray, w) for w in (we, wn))
    want, pull = jax.vjp(lambda x, a, b: PR.fused_round(x, jnp.asarray(idxw), a, b, None, 32),
                         jnp.asarray(h), jwe, jwn)
    wdh, wdwe, wdwn = pull(jnp.asarray(cot))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    out, dh, dwe, dwn = round_emulated(t(h), t(idxw), {k: t(v) for k, v in we.items()},
                                       {k: t(v) for k, v in wn.items()}, t(cot), slices)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0, atol=FWD_ATOL)
    got = [dh] + [dwe[k] for k in KEYS] + [dwn[k] for k in KEYS]
    wants = [wdh] + [wdwe[k] for k in KEYS] + [wdwn[k] for k in KEYS]
    names = ["d h"] + [f"d we.{k}" for k in KEYS] + [f"d wn.{k}" for k in KEYS]
    for name, a, b in zip(names, got, wants):
        b = np.asarray(b)
        assert np.abs(b).max() > 0, name
        np.testing.assert_allclose(a.numpy(), b, rtol=BWD_RTOL,
                                   atol=BWD_ATOL_SCALE * np.abs(b).max(), err_msg=name)


def test_round_width_rule_takes_every_multiple_of_8_to_256():
    for H in range(8, 257, 8):
        assert rnd.round_widths(H) == H


@pytest.mark.parametrize("H", [12, 264, 4, 0, 100])
def test_round_width_rule_refuses_other_widths_by_name(H):
    with pytest.raises(ValueError, match=f"H={H}"):
        rnd.round_widths(H)
    # the wrappers' check names the kernel too, before any library is built
    with pytest.raises(ValueError, match=f"round_fwd: .*H={H}"):
        rnd._dims("round_fwd", torch.zeros(2, 8, H))


def test_round_width_rule_is_evaluated_once_per_width():
    rnd.round_widths.cache_clear()
    for _ in range(3):
        rnd.round_widths(128)
        rnd.round_widths(48)
    info = rnd.round_widths.cache_info()
    assert (info.misses, info.hits) == (2, 4)


DH_AHEAD = 8  # round_bwd_dh_kernel: entries whose d xin rows load before any is added


def dh_lanes(H):
    """round_bwd_dh_kernel's lanes a row: 8 to H 32, 16 to H 64, else 32."""
    return 8 if H <= 32 else 16 if H <= 64 else 32


def dh_walk_emulated(idxw, inc_ptr, inc_idx, dxin, ddir):
    """round_bwd_dh_kernel's walk, in f64 rounded once: per row ddir, at an
    edge row + d es[past] - d es[fut], then the incident entries staged L at
    a time (entry e + s by lane s, its coefficient from the step's idxw) and
    added in CSR order, DH_AHEAD entries a chunk, skipping coefficient 0."""
    B, cap, H = dxin.shape
    L = dh_lanes(H)
    idx = idxw.reshape(-1, 4).long()
    dx = dxin.reshape(-1, H).double()
    dh = ddir.reshape(-1, H).double().clone()
    kind = lambda q: 2 if q[3] != 0 else 1 if q[2] != 0 else 0
    for row in range(B * cap):
        base, r = row - row % cap, row % cap
        q = idx[row]
        if kind(q) == 1:
            if kind(idx[base + q[0]]) == 2:
                dh[row] = dh[row] + dx[base + q[0]]
            if kind(idx[base + q[1]]) == 2:
                dh[row] = dh[row] - dx[base + q[1]]
        e0, e1 = int(inc_ptr[row]), int(inc_ptr[row + 1])
        for e in range(e0, e1, L):
            staged = []
            for s in range(min(L, e1 - e)):
                kk = int(inc_idx[e + s])
                qk = idx[base + kk]
                coef = int(qk[0] == r) - int(qk[1] == r) if kind(qk) == 1 else 0
                staged.append((kk, coef))
            for u0 in range(0, len(staged), DH_AHEAD):
                for kk, coef in staged[u0:u0 + DH_AHEAD]:
                    if coef != 0:
                        dh[row] = dh[row] + coef * dx[base + kk]
    return dh.float().reshape(B, cap, H)


def test_dh_walk_over_a_detection_with_many_incident_edges(interpret_mode):
    """A detection with more than 64 incident edges (three staged lists of
    32 at H 128): the emulated walk against round_bwd_dh_reference on the
    plain backward's d xin and ddir, and against interpret-mode fused_round's
    VJP (rtol 1e-4, atol 1e-5 x scale)."""
    H = 128
    h, idxw, we, wn, cot, inc_ptr, inc_idx = hub_round_inputs(9, H=H)
    assert inc_ptr[1] - inc_ptr[0] > 64 and dh_lanes(H) == 32
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    th, tidx, tg = t(h), t(idxw), t(cot)
    twe, twn = ({k: t(v) for k, v in w.items()} for w in (we, wn))
    xin = rnd.round_fwd_reference(th, tidx, twe, twn)[1]
    _, dxin, ddir = rnd.round_bwd_gru_reference(th, tidx, xin, tg, twe, twn)
    got = dh_walk_emulated(tidx, t(inc_ptr), t(inc_idx), dxin, ddir)
    plain = rnd.round_bwd_dh_reference(tidx, dxin, ddir)
    scale = float(plain.abs().max())
    torch.testing.assert_close(got, plain, rtol=BWD_RTOL, atol=BWD_ATOL_SCALE * scale)
    assert float((got[0, 0] - ddir[0, 0]).abs().max()) > 0  # the hub's walk adds something
    jwe, jwn = (jax.tree_util.tree_map(jnp.asarray, w) for w in (we, wn))
    _, pull = jax.vjp(lambda x: PR.fused_round(x, jnp.asarray(idxw), jwe, jwn, None, 32),
                      jnp.asarray(h))
    (want,) = pull(jnp.asarray(cot))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=BWD_RTOL,
                               atol=BWD_ATOL_SCALE * np.abs(want).max())
