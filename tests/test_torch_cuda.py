"""Checks of the port's CUDA kernels that need the card.  They skip where
CUDA is not available; chip_smoke.py runs the same comparisons at the
serving and training shapes.  This file imports neither JAX nor the JAX package, so on
a machine without JAX it runs alone:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_util import (DCN_KEYS, EDGE_LOSS_COUNTS, EDGE_LOSS_KEYS, ROUND_KEYS,
                             bf16_dgh_scale, bf16_ulp, dcn_inputs, edge_loss_inputs, es_inputs, gat_inputs,
                             hub_round_inputs, in_f64, round_inputs)
from trackmpnn_tpu_torch.ops import block, dcn, gat, loss, mp
from trackmpnn_tpu_torch.ops import round as rnd

REPO = pathlib.Path(__file__).resolve().parents[1]

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: chip_smoke.py runs these checks on the card")
    return torch.device("cuda")


def problem(seed, n, h, device):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(n, h)).astype(np.float32)).to(device),
            torch.from_numpy(rng.integers(0, n, n).astype(np.int32)).to(device),
            torch.from_numpy(rng.integers(0, n, n).astype(np.int32)).to(device),
            torch.from_numpy(rng.random(n) > 0.5).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("n,h", [(1024, 64), (300, 16), (7, 4), (5000, 1040)])
def test_kernels_match_plain_versions(cuda, n, h):
    """gather_diff exact; signed_segment_sum within atol/rtol 1e-5 of its
    plain version (both f64, rounded once), with and without an incidence
    given, bitwise the same on a second launch; one launch a call, one
    incidence build where none is given."""
    hid, past, fut, edge = problem(n, n, h, cuda)
    before, builds = dict(mp.LAUNCHES), dict(mp.BUILDS)
    gd = mp.gather_diff(hid, past, fut, edge)
    ss = mp.signed_segment_sum(hid, past, fut, edge, n)
    assert mp.BUILDS["segment_incidence"] == builds["segment_incidence"] + 1
    inc = mp.segment_incidence(past, fut, n)
    given, again = (mp.signed_segment_sum(hid, past, fut, edge, n, inc) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(gd, mp.gather_diff_reference(hid, past, fut, edge))
    want = mp.signed_segment_sum_reference(hid, past, fut, edge, n)
    for got in (ss, given):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(given, again) and torch.equal(ss, given)
    torch.testing.assert_close(given, mp.signed_segment_sum_pull_reference(hid, edge, inc, n),
                               rtol=1e-5, atol=1e-5)
    assert mp.LAUNCHES["gather_diff"] == before["gather_diff"] + 1
    assert mp.LAUNCHES["signed_segment_sum"] == before["signed_segment_sum"] + 3
    assert mp.BUILDS["segment_incidence"] == builds["segment_incidence"] + 2


def graph_on(seed, cap, h, device, nd=None):
    """A padded slot layout as graph/view.py::pack_slots writes it: detection
    rows, edge rows between them, self-pointing padding; a random mask over
    the edges."""
    rng = np.random.default_rng(seed)
    nd = nd or cap // 12
    n = cap * 3 // 4
    is_det = np.zeros(cap, bool)
    is_det[rng.choice(n, nd, replace=False)] = True
    past = np.arange(cap, dtype=np.int32)
    fut = past.copy()
    edges = np.where(~is_det[:n])[0]
    dets = np.where(is_det)[0]
    past[edges], fut[edges] = rng.choice(dets, len(edges)), rng.choice(dets, len(edges))
    mask = (np.arange(cap) < n) & ~is_det & (rng.random(cap) < 0.8)
    put = lambda a: torch.from_numpy(a).to(device)
    return (put(rng.normal(size=(cap, h)).astype(np.float32)), put(past), put(fut),
            put(is_det), put(mask))


@pytest.mark.cuda
@pytest.mark.parametrize("cap,h,nd", [(16384, 64, 170), (4096, 64, 150), (700, 20, 9)])
def test_signed_segment_sum_pulls_over_a_view_incidence(cuda, cap, h, nd):
    """The serving shape (~170 detection rows of ~70 terms): the incidence
    built on the card with no host synchronisation, the kernel against its
    plain versions and bitwise on a second launch, one launch a call."""
    hid, past, fut, is_det, mask = graph_on(cap, cap, h, cuda, nd)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        inc = mp.segment_incidence(past, fut, cap)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    before = mp.LAUNCHES["signed_segment_sum"]
    got, again = (mp.signed_segment_sum(hid, past, fut, mask, cap, inc) for _ in range(2))
    torch.cuda.synchronize()
    assert mp.LAUNCHES["signed_segment_sum"] == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, mp.signed_segment_sum_reference(hid, past, fut, mask, cap),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, mp.signed_segment_sum_pull_reference(hid, mask, inc, cap),
                               rtol=1e-5, atol=1e-5)
    assert torch.all(got[~is_det] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("layout,cap,n", [("view", 16384, 16384), ("view", 700, 700),
                                          ("random", 5000, 5000), ("random", 300, 200),
                                          ("random", 0, 4), ("random", 9, 0)])
def test_segment_incidence_kernel_matches_its_plain_version(cuda, layout, cap, n):
    """The build kernel against segment_incidence_reference on the card:
    ptr and the listed entries bitwise equal, on a second launch too, with
    no host synchronisation; rows pointing at themselves and endpoints
    outside [0, n), negative or beyond, are not listed."""
    if layout == "view":
        _, past, fut, _, _ = graph_on(cap, cap, 4, cuda)
    else:
        rng = np.random.default_rng(cap + n)
        ends = rng.integers(-3, n + 3, (2, cap)).astype(np.int32)
        ends[:, ::5] = np.arange(cap, dtype=np.int32)[::5]  # pointing at themselves
        past, fut = (torch.from_numpy(a).to(cuda) for a in ends)
    builds = mp.BUILDS["segment_incidence"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, again = (mp.segment_incidence(past, fut, n) for _ in range(2))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want_ptr, want_ent = mp.segment_incidence_reference(past, fut, n)
    assert mp.BUILDS["segment_incidence"] == builds + 2
    for ptr, ent in (got, again):
        assert ptr.dtype == ent.dtype == torch.int32 and ent.shape == (2 * cap,)
        assert torch.equal(ptr, want_ptr)
        listed = int(want_ptr[-1])
        assert torch.equal(ent[:listed], want_ent[:listed])


@pytest.mark.cuda
@pytest.mark.parametrize("call", [
    "mp.gather_diff(h, bad, idx, mask)",
    "mp.signed_segment_sum(h, idx, bad, mask, 8)",
    "mp.signed_segment_sum(h, idx, bad, mask, 8, mp.segment_incidence(idx, bad, 8))",
    "mp.fused_edge_gru(h16, idx, bad, mask, w, w, b, b)",
    "mp.gather_concat(h, bad, idx, mask)",
    "mp.segment_sum_halves_raw(h16[:, :8].contiguous(), idx, bad, mask, 8)",
])
def test_out_of_range_endpoint_traps_the_kernel(cuda, call):
    """An endpoint outside the rows is a CUDA error at the next
    synchronisation, not a read or write out of bounds.  A trap leaves the
    CUDA context unusable, so it runs in a process of its own."""
    code = (
        "import torch\n"
        "from trackmpnn_tpu_torch.ops import mp\n"
        "h = torch.zeros(8, 4, device='cuda')\n"
        "idx = torch.arange(8, dtype=torch.int32, device='cuda')\n"
        "bad = idx.clone(); bad[3] = 8\n"
        "mask = torch.ones(8, dtype=torch.bool, device='cuda')\n"
        "h16, w = torch.zeros(8, 16, device='cuda'), torch.zeros(16, 48, device='cuda')\n"
        "b = torch.zeros(48, device='cuda')\n"
        f"{call}\n"
        "torch.cuda.synchronize()\n"
        "print('no error')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "no error" not in out.stdout, out.stdout
    assert "CUDA error" in out.stderr or "AcceleratorError" in out.stderr, out.stderr[-2000:]


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    hid, past, fut, edge = problem(0, 64, 16, cuda)
    with pytest.raises(TypeError):
        mp.gather_diff(hid, past.long(), fut, edge)
    with pytest.raises(TypeError):
        mp.signed_segment_sum(hid.double(), past, fut, edge, 64)
    with pytest.raises(ValueError):
        mp.gather_diff(hid[:, :6], past, fut, edge)
    with pytest.raises(ValueError):
        mp.gather_diff(hid, past, fut.cpu(), edge)
    ptr, ent = mp.segment_incidence(past, fut, 64)
    for bad in ((ptr[:-1], ent), (ptr, ent.long()), (ptr.cpu(), ent)):
        with pytest.raises((TypeError, ValueError)):
            mp.signed_segment_sum(hid, past, fut, edge, 64, bad)
    # a gradient is no refusal: the ops are autograd Functions
    assert mp.gather_diff(hid.requires_grad_(), past, fut, edge).requires_grad


@pytest.mark.cuda
@pytest.mark.parametrize("n,h", [(4096, 64), (32768, 64), (16384, 64), (300, 16), (1000, 128),
                                 (5, 16), (200000, 64), (777, 100), (50, 4), (999, 264)])
def test_gather_kernels_match_plain_versions(cuda, n, h):
    """#1 in both modes (gather_diff, gather_concat) bitwise equal to its
    plain version and on a relaunch, one launch a call: at the batch-1,
    packed and serving row counts at H 64, at H 16 and 128, above one wave
    of resident CTAs (200,000 rows: each group walks several rows), and at
    widths whose lanes do not fill a power of two (100, 264)."""
    hid, past, fut, edge = problem(n + 1, n, h, cuda)
    for name, plain in (("gather_diff", mp.gather_diff_reference),
                        ("gather_concat", mp.gather_concat_reference)):
        op = getattr(mp, name)
        before = mp.LAUNCHES[name]
        got, again = op(hid, past, fut, edge), op(hid, past, fut, edge)
        torch.cuda.synchronize()
        assert mp.LAUNCHES[name] == before + 2
        want = plain(hid, past, fut, edge)
        assert got.shape == want.shape and torch.equal(got, want), name
        assert torch.equal(got, again), name


@pytest.mark.cuda
@pytest.mark.parametrize("n,h", [(4096, 64), (16384, 64), (300, 16), (1000, 128), (5, 4),
                                 (777, 100)])
def test_segment_sum_halves_matches_plain_version(cuda, n, h):
    """The pull's halves mode (gather_concat's VJP) within atol 1e-5 of its
    plain version evaluated in f64, with and without an incidence given,
    bitwise the same on a relaunch, one launch a call; the autograd
    backward of gather_concat is one launch of it and matches the CPU's."""
    hid, past, fut, edge = problem(n + 2, n, h, cuda)
    g = torch.from_numpy(np.random.default_rng(n).normal(size=(n, 2 * h)).astype(np.float32)
                         ).to(cuda)
    inc = mp.segment_incidence(past, fut, n)
    before = mp.LAUNCHES["segment_sum_halves"]
    given, again = (mp.segment_sum_halves_raw(g, past, fut, edge, n, inc) for _ in range(2))
    built = mp.segment_sum_halves_raw(g, past, fut, edge, n)
    torch.cuda.synchronize()
    assert mp.LAUNCHES["segment_sum_halves"] == before + 3
    (want,) = in_f64(lambda a: mp.segment_sum_halves_reference(a, past, fut, edge, n), g)
    torch.testing.assert_close(given, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(given, again) and torch.equal(given, built)
    x = hid.requires_grad_(True)
    launched = dict(mp.LAUNCHES)
    (dx,) = torch.autograd.grad((mp.gather_concat(x, past, fut, edge, inc) * g).sum(), x)
    assert {k: mp.LAUNCHES[k] - launched[k] for k in launched} == {
        "gather_diff": 0, "signed_segment_sum": 0, "fused_edge_gru": 0, "gather_concat": 1,
        "segment_sum_halves": 1}
    x_c = hid.detach().cpu().requires_grad_(True)
    (dx_c,) = torch.autograd.grad((mp.gather_concat(x_c, past.cpu(), fut.cpu(), edge.cpu())
                                   * g.cpu()).sum(), x_c)
    torch.testing.assert_close(dx.cpu(), dx_c, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_gather_concat_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    hid, past, fut, edge = problem(1, 64, 16, cuda)
    with pytest.raises(TypeError):
        mp.gather_concat(hid, past.long(), fut, edge)
    with pytest.raises(ValueError):  # not a multiple of 4
        mp.gather_concat(hid[:, :6].contiguous(), past, fut, edge)
    with pytest.raises(ValueError):  # not 16-byte aligned
        mp.gather_concat(hid.view(-1)[1:1 + 64 * 12].view(64, 12), past, fut, edge)
    with pytest.raises(ValueError):
        mp.gather_concat(hid, past, fut.cpu(), edge)
    g = torch.zeros(64, 32, device=cuda)
    with pytest.raises(ValueError):  # halves of 12 columns: H 6
        mp.segment_sum_halves_raw(g[:, :12].contiguous(), past, fut, edge, 64)
    with pytest.raises(ValueError):
        mp.segment_sum_halves_raw(g.view(-1)[1:1 + 64 * 16].view(64, 16), past, fut, edge, 64)
    with pytest.raises(TypeError):
        mp.segment_sum_halves_raw(g.double(), past, fut, edge, 64)
    ptr, ent = mp.segment_incidence(past, fut, 64)
    with pytest.raises(ValueError):
        mp.segment_sum_halves_raw(g, past, fut, edge, 64, (ptr[:-1], ent))


def gru_problem(seed, n, h, device):
    """problem()'s rows and masks plus edge-GRU weights [H, 3H] and biases
    [3H] scaled so that the gates spread."""
    rng = np.random.default_rng(seed + 1)
    put = lambda *shape, s: torch.from_numpy((s * rng.normal(size=shape)).astype(np.float32)
                                             ).to(device)
    return (*problem(seed, n, h, device), put(h, 3 * h, s=h ** -0.5), put(h, 3 * h, s=h ** -0.5),
            put(3 * h, s=0.3), put(3 * h, s=0.3))


@pytest.mark.cuda
@pytest.mark.parametrize("n,h", [(16384, 64), (300, 16), (1000, 32), (2000, 48), (777, 100),
                                 (3000, 128), (500, 4), (700, 12), (2000, 256), (5, 64),
                                 (1000, 64), (200, 16), (600, 300), (200, 616)])
def test_fused_edge_gru_matches_plain_version(cuda, n, h):
    """Kernel #3 against its plain version evaluated in f64 within atol 1e-5
    (3xTF32 tensor-core products; two f32 evaluations in different orders
    differ by ~1e-6 at H 128), bitwise on a second launch, one launch counted
    a call.  H 4 and 12 pad the k step and the n tile with zeros; 48 and 100
    leave units of a CTA idle; 128 and 256 split the gates' columns over 4
    and 16 CTAs; 300 holds its slab at 8 units a CTA; 616
    restages its weights each tile (no CTA holds its slab above H 600); N 5
    is below one tile, N 1000 and 200 end in a ragged one."""
    args = gru_problem(n, n, h, cuda)
    before = mp.LAUNCHES["fused_edge_gru"]
    with torch.no_grad():
        got, again = mp.fused_edge_gru(*args), mp.fused_edge_gru(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, in_f64(mp.edge_gru_reference, *args)[0], rtol=0, atol=1e-5)
    assert torch.equal(got, again)
    assert mp.LAUNCHES["fused_edge_gru"] == before + 2


@pytest.mark.cuda
def test_fused_edge_gru_refuses_what_the_kernel_does_not_take(cuda):
    hid, past, fut, edge, w_ih, w_hh, b_ih, b_hh = gru_problem(0, 64, 16, cuda)
    call = lambda **kw: mp.fused_edge_gru(*{**dict(h=hid, past=past, fut=fut, edge_mask=edge,
                                                   w_ih=w_ih, w_hh=w_hh, b_ih=b_ih,
                                                   b_hh=b_hh), **kw}.values())
    with pytest.raises(TypeError):
        call(h=hid.double())
    with pytest.raises(TypeError):
        call(past=past.long())
    with pytest.raises(TypeError):
        call(w_ih=w_ih[:, :32].contiguous())
    with pytest.raises(ValueError):
        call(w_hh=w_hh.t().contiguous().t())  # not contiguous
    with pytest.raises(ValueError):
        call(b_ih=b_ih.cpu())
    with pytest.raises(ValueError):  # H not a multiple of 4
        h6 = hid[:, :6].contiguous()
        mp.fused_edge_gru(h6, past, fut, edge, w_ih[:6, :18].contiguous(),
                          w_hh[:6, :18].contiguous(), b_ih[:18].clone(), b_hh[:18].clone())
    with pytest.raises(RuntimeError, match="no backward"):
        call(w_ih=w_ih.clone().requires_grad_())


def round_problem(seed, P, na, nt, H, device):
    """Inputs of the block round with a rectangular live part per block, as
    the train step makes them (padded cells of h_e are 0), and cotangents."""
    rng = np.random.default_rng(seed)
    blk_na = rng.integers(0, na + 1, size=P)
    blk_nt = rng.integers(0, nt + 1, size=P)
    m = ((np.arange(na)[None, :, None] < blk_na[:, None, None])
         & (np.arange(nt)[None, None, :] < blk_nt[:, None, None])).astype(np.float32)
    arrays = [rng.normal(size=(P, na, nt, H)) * m[..., None],
              rng.normal(size=(P, na, 3 * H)), rng.normal(size=(P, nt, 3 * H)),
              rng.normal(size=(H, 3 * H)) * 0.3, rng.normal(size=(3 * H,)) * 0.1,
              rng.normal(size=(H, 1)) * 0.4, m]
    cots = [rng.normal(size=(P, na, nt, H)), rng.normal(size=(P, na, H)),
            rng.normal(size=(P, nt, H)), rng.normal(size=(P, na, nt))]
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    return [put(a) for a in arrays], [put(a) for a in cots]


def assert_grads_close(got, want):
    """rtol 1e-4 with an absolute floor of 1e-5 times each output's scale:
    the kernel sums in another order than the plain version's matmuls."""
    for name, a, b in zip(["dhe", "dga", "dgb", "dwhh", "dbhh", "dweb"], got, want):
        atol = 1e-5 * max(float(b.abs().max()), 1.0)
        torch.testing.assert_close(a, b, rtol=1e-4, atol=atol, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("sign", [-1.0, 1.0])
@pytest.mark.parametrize("P,na,nt,H", [(11, 8, 16, 16), (16, 24, 24, 64), (3, 5, 40, 32),
                                        (16, 64, 64, 128), (4, 24, 24, 256), (3, 5, 40, 40)])
def test_block_round_kernels_match_plain_versions(cuda, sign, P, na, nt, H):
    """Forward within atol 1e-5 (padded cells exactly 0), backward within
    rtol 1e-4; both bitwise the same on a second launch.  H 128 at na = nt
    = 64 and H 256 lie beyond the shared memory of the first design (one
    CTA a block holding w_hh and every row's gate cotangents); H 40 is a
    width that does not divide 256."""
    args, cots = round_problem(P + na, P, na, nt, H, cuda)
    before = dict(block.LAUNCHES)
    got = block._block_round_fwd_cuda(*args, sign)
    again = block._block_round_fwd_cuda(*args, sign)
    want = in_f64(block.block_round_reference, *args, sign)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, again):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
        assert torch.equal(a, c)
    m = args[-1]
    assert torch.all(got[0][m == 0] == 0) and torch.all(got[3][m == 0] == 0)
    gb = block._block_round_bwd_cuda(*args, sign, *cots)
    gb2 = block._block_round_bwd_cuda(*args, sign, *cots)
    wb = in_f64(block.block_round_backward_reference, *args, sign, *cots)
    torch.cuda.synchronize()
    assert_grads_close(gb, wb)
    assert all(torch.equal(a, b) for a, b in zip(gb, gb2))
    assert block.LAUNCHES["block_round_fwd"] == before["block_round_fwd"] + 2
    assert block.LAUNCHES["block_round_bwd"] == before["block_round_bwd"] + 2


def assert_bf16_close(got, want, name, ulps=1, flip=0.0):
    """bf16 outputs: within `ulps` bf16 ulps of the larger magnitude (a value
    whose f32 sums come in another order may round to the neighbouring bf16
    value), plus 1e-5 of the output's scale (where a sum cancels to near 0,
    f32 summation order alone moves it by more than its own ulp), plus
    `flip`: what one operand of a bf16 product rounded the other way moves
    it by."""
    assert got.dtype == want.dtype == torch.bfloat16, name
    a, b = got.float(), want.float()
    lim = (ulps * bf16_ulp(torch.maximum(a.abs(), b.abs())) + flip
           + 1e-5 * max(float(b.abs().max()), 1.0))
    bad = (a - b).abs() > lim
    assert not bool(bad.any()), (name, float(((a - b).abs() - lim).max()), int(bad.sum()))


def bf16_round_problem(seed, P, na, nt, H, device):
    """round_problem with h_e, ga, gb and d edge_out in bf16."""
    args, cots = round_problem(seed, P, na, nt, H, device)
    return ([a.bfloat16() for a in args[:3]] + args[3:], [cots[0].bfloat16()] + cots[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("sign", [-1.0, 1.0])
@pytest.mark.parametrize("P,na,nt,H", [(11, 8, 16, 16), (16, 24, 24, 64), (3, 5, 40, 40),
                                        (16, 64, 64, 128), (4, 24, 24, 256), (7, 9, 13, 24)])
def test_bf16_block_round_kernels_match_plain_versions(cuda, sign, P, na, nt, H):
    """The bf16 round (block_round_fwd_bf16 / _bwd_bf16) against the plain
    version with the same rounding points, on the card: edge_out, d h_e,
    d ga, d gb (bf16) within one bf16 ulp (assert_bf16_close); rs, cs, lg,
    d b_hh, d w_eb (f32) within rtol 1e-4 and 1e-5 of their scale; d h_e and
    d w_hh, whose products read d gh rounded to bf16, also within 2^-8 |d gh|
    |w_hh| and 2^-8 |d gh| |h_e| (bf16_dgh_scale: one operand rounded the
    other way; without it H 64 missed by up to 0.01 in 13 of 590k values of
    d h_e).  Each bitwise the same on a
    second launch; one launch of each a call, none of the f32 round's.
    H 24 and 40 are widths that 16 does not divide (the last k step of the
    products is half zeros)."""
    args, cots = bf16_round_problem(P + na + 1, P, na, nt, H, cuda)
    before = dict(block.LAUNCHES)
    got = block._block_round_fwd_cuda(*args, sign)
    again = block._block_round_fwd_cuda(*args, sign)
    want = block.block_round_reference(*args, sign)
    torch.cuda.synchronize()
    assert_bf16_close(got[0], want[0], "edge_out")
    for name, a, b in zip(["rs", "cs", "lg"], got[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * max(float(b.abs().max()), 1.0),
                                   msg=name)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    m = args[-1]
    assert torch.all(got[0][m == 0] == 0) and torch.all(got[3][m == 0] == 0)
    gb = block._block_round_bwd_cuda(*args, sign, *cots)
    gb2 = block._block_round_bwd_cuda(*args, sign, *cots)
    wb = block.block_round_backward_reference(*args, sign, *cots)
    torch.cuda.synchronize()
    dgh = 2.0 ** -8 * bf16_dgh_scale(args, cots, sign)
    assert_bf16_close(gb[0], wb[0], "dhe", flip=dgh * float(args[3].abs().max()))
    for name, a, b in zip(["dga", "dgb"], gb[1:3], wb[1:3]):
        assert_bf16_close(a, b, name)
    flip = dgh * float(args[0].float().abs().max())
    for name, a, b in zip(["dwhh", "dbhh", "dweb"], gb[3:], wb[3:]):
        atol = 1e-5 * max(float(b.abs().max()), 1.0) + (flip if name == "dwhh" else 0.0)
        torch.testing.assert_close(a, b, rtol=1e-4, atol=atol, msg=name)
    assert all(torch.equal(a, b) for a, b in zip(gb, gb2))
    assert {k: block.LAUNCHES[k] - before[k] for k in before} == {
        **dict.fromkeys(before, 0), "block_round_fwd_bf16": 2, "block_round_bwd_bf16": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("P,na,nt,H,keep", [(17, 8, 16, 16, 0.5), (120, 24, 24, 64, 1.0),
                                            (3, 5, 40, 30, 0.5), (4, 40, 40, 64, 0.5)])
def test_bf16_aggregate_kernels_match_plain_versions(cuda, P, na, nt, H, keep):
    """#12 on a bf16 h_e at nh 3 (gat_aggregate_fwd_bf16 / _bwd_bf16): rs,
    cs within rtol and atol 1e-5; d e and the statistics' cotangents within
    rtol 1e-4 (1e-5 of their scale); d h_e (bf16, each head's term rounded
    and added in bf16 in head order) within two bf16 ulps; bitwise on a
    second launch; one launch of each, none of the f32 kernels.  H 30 takes
    the kernels' one-value loads."""
    pr = gat_problem(P + 3, 3, P, na, nt, H, keep, cuda)
    a_args = list(pr["agg"])
    a_args[5] = a_args[5].bfloat16()
    before = dict(gat.LAUNCHES)
    got, again = (gat._gat_aggregate_fwd_cuda(*a_args, keep) for _ in range(2))
    want = gat.gat_aggregate_reference(*a_args, keep)
    torch.cuda.synchronize()
    for name, a, b in zip(["rs", "cs"], got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=name)
    args = (*a_args, keep, *pr["agg_cot"])
    gb, gb2 = (gat._gat_aggregate_bwd_cuda(*args) for _ in range(2))
    wb = gat.gat_aggregate_backward_reference(*args)
    torch.cuda.synchronize()
    assert_close_scaled(gb[:5], wb[:5], ["de", "dm_row", "dm_col", "dz_row", "dz_col"])
    assert_bf16_close(gb[5], wb[5], "dhe", ulps=2)
    assert all(torch.equal(a, b) for a, b in zip((*got, *gb), (*again, *gb2)))
    assert {k: gat.LAUNCHES[k] - before[k] for k in before} == {
        **dict.fromkeys(before, 0), "gat_aggregate_fwd_bf16": 2, "gat_aggregate_bwd_bf16": 2}


def tree_to(tree, device):
    """A nested dict / list of tensors copied to `device`."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.cuda
def test_bf16_block_step_on_the_card_matches_the_cpu(cuda):
    """One bf16 block step with two stacked heads (train/block.py,
    compute_dtype=torch.bfloat16) on the card and the CPU on the same keep
    masks: loss within rtol 1e-3, gradients within rtol 1e-2 and 1e-3 of the
    largest |grad|; the bf16 kernels launched T times a step, the f32
    round's and the es round's never."""
    from trackmpnn_tpu_torch.data.synthetic import make_sequence
    from trackmpnn_tpu_torch.graph.schedule import build_window_schedule
    from trackmpnn_tpu_torch.models import mpnn
    from trackmpnn_tpu_torch.train import block as train_block

    scheds = []
    for seed in range(2):
        X, bp, _ = make_sequence(num_tracks=5, num_frames=5, seed=seed, miss_rate=0.1,
                                 fp_rate=0.1)
        scheds.append(build_window_schedule(X, bp[:, :2].astype(np.int64), cap=256, t_cap=5))
    cfg = mpnn.ModelConfig(features="2d", ncategories=3, nhidden=32, nattheads=2)
    base = mpnn.init_params(torch.Generator().manual_seed(0), cfg)
    gen = torch.Generator().manual_seed(1)
    out = {}
    for dev in ("cpu", cuda):
        bb = train_block.build_block_batch(scheds, 5, device=dev)
        if dev == "cpu":
            keeps = [train_block.draw_att_keep(gen, 2, ((s + 1) * 2, bb.na_cap, bb.nt_cap), "cpu")
                     for s in range(bb.t_cap)]
        params = train_block.trainable(tree_to(base, dev))
        stats = tree_to(mpnn.init_batch_stats(cfg), dev)
        before = dict(block.LAUNCHES), dict(gat.LAUNCHES)
        loss, _ = train_block.block_window_forward(
            params, stats, cfg, bb, True, att_keep=[tuple(k.to(dev) for k in ks) for ks in keeps],
            compute_dtype=torch.bfloat16)
        loss.backward()
        launched = {k: v - before[0][k] for k, v in block.LAUNCHES.items()}
        launched.update({k: v - before[1][k] for k, v in gat.LAUNCHES.items()})
        out[str(dev)] = (float(loss.detach()),
                         [t.grad.cpu() for t in train_block.param_leaves(params)], launched)
    (l_c, g_c, _), (l_g, g_g, launched) = out["cpu"], out["cuda"]
    T = 5
    for k in ("block_round_fwd_bf16", "block_round_bwd_bf16", "gat_aggregate_fwd_bf16",
              "gat_aggregate_bwd_bf16", "gat_scores_fwd", "gat_scores_bwd"):
        assert launched[k] == T, (k, launched[k])
    for k in ("block_round_fwd", "block_round_bwd", "block_round_es_fwd", "gat_aggregate_fwd"):
        assert launched[k] == 0, k
    np.testing.assert_allclose(l_g, l_c, rtol=1e-3)
    scale = max(float(g.abs().max()) for g in g_c)
    for a, b in zip(g_g, g_c):
        torch.testing.assert_close(a, b, rtol=1e-2, atol=1e-3 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("P,n,F,B,capD", [(120, 48, 64, 8, 256), (30, 48, 192, 8, 256),
                                          (7, 5, 12, 3, 9), (24, 48, 64, 2, 4096)])
def test_window_scatter_kernel_matches_plain_version(cuda, P, n, F, B, capD):
    """Without an incidence: the full one built on the card (no host
    synchronisation) for each call; duplicate ids within a block included;
    atol 1e-5, bitwise repeatable.  capD 4096 lies beyond the shared memory
    the first design's accumulator needed (capD x 64 floats a CTA)."""
    rng = np.random.default_rng(P)
    vals = torch.from_numpy(rng.normal(size=(P, n, F)).astype(np.float32)).to(cuda)
    idx = torch.from_numpy(rng.integers(0, capD, (P, n)).astype(np.int32)).to(cuda)
    before, builds = block.LAUNCHES["window_scatter"], block.BUILDS["window_incidence"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = block.window_scatter_raw(vals, idx, B, capD)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    again = block.window_scatter_raw(vals, idx, B, capD)
    want = block.window_scatter_reference(vals, idx, B, capD)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert torch.equal(got, again)
    assert block.LAUNCHES["window_scatter"] == before + 2
    assert block.BUILDS["window_incidence"] == builds + 2


def block_batch_on(device, n=8, seed0=100):
    """A real BlockBatch of `n` synthetic windows and its step-major ids."""
    from torch_port_util import training_chunks
    from trackmpnn_tpu_torch.graph import schedule
    from trackmpnn_tpu_torch.train import block as train_block

    scheds = [schedule.build_window_schedule(X, y, cap=1024, t_cap=16)
              for X, y in training_chunks(n, seed0, num_tracks=12)]
    bb = train_block.build_block_batch(scheds, 16, device=device)
    B, T = bb.n_windows, bb.t_cap
    perm = torch.arange(B * T, device=device).reshape(B, T).t().reshape(-1)
    act = (bb.active_idx[perm] % bb.capD).to(torch.int32)
    new = (bb.newdet_idx[perm] % bb.capD).to(torch.int32)
    return bb, act, new


def listed_values(bb, shape, seed, device):
    """Random values [P, na + nt, F] that are 0 wherever the batch's
    incidence lists nothing, as every caller's are."""
    P, W, F = shape
    slot = bb.det_inc_slot.long()
    live = torch.zeros(P * W, dtype=torch.bool, device=device)
    live[slot[slot < P * W]] = True
    rng = np.random.default_rng(seed)
    vals = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device)
    return torch.where(live.reshape(P, W, 1), vals, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("F,P_frac", [(64, 1.0), (192, 1.0), (48, 0.5)])
def test_window_scatter_pulls_over_the_batch_incidence(cuda, F, P_frac):
    """With the BlockBatch's incidence: the es form and window_gather2's
    backward (both cotangents in one launch) against their plain versions
    (atol 1e-5) and the plain pull (incidence_sum_reference), bitwise the
    same on a second launch, one launch a call and no incidence built."""
    bb, act, new = block_batch_on(cuda)
    B, capD, na, nt = bb.n_windows, bb.capD, bb.na_cap, bb.nt_cap
    P = max(B, int(act.shape[0] * P_frac) // B * B)
    inc = (bb.det_inc_ptr, bb.det_inc_slot)
    vals = listed_values(bb, (P, na + nt, F), F, cuda)
    idx = torch.cat([act, new], 1)[:P].contiguous()
    before, builds = block.LAUNCHES["window_scatter"], dict(block.BUILDS)
    es, es2 = (block.window_scatter_raw(vals, idx, B, capD, inc) for _ in range(2))
    dga, dgb = vals[:, :na].contiguous(), vals[:, na:].contiguous()
    g2 = [block.window_gather2_backward_raw(dga, dgb, act[:P].contiguous(),
                                            new[:P].contiguous(), B, capD, inc)
          for _ in range(2)]
    torch.cuda.synchronize()
    assert block.LAUNCHES["window_scatter"] == before + 4 and block.BUILDS == builds
    assert torch.equal(es, es2) and all(torch.equal(a, b) for a, b in zip(*g2))
    torch.testing.assert_close(es, block.window_scatter_reference(vals, idx, B, capD),
                               rtol=0, atol=1e-5)
    rows, _ = block.incidence_sum_reference(vals, vals[:, :0], *inc, B * capD)
    torch.testing.assert_close(es, rows.float(), rtol=0, atol=1e-5)
    for got, src, ids in zip(g2[0], (dga, dgb), (act[:P], new[:P])):
        torch.testing.assert_close(got, block.window_scatter_reference(src, ids, B, capD),
                                   rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("given", [True, False], ids=["batch incidence", "built"])
def test_window_gather2_backward_takes_two_widths(cuda, given):
    """Cotangents of two widths (d ga F 48, d gb F 24, and the reverse) in
    one launch, with the batch's incidence or the one built for the call:
    against their plain versions (atol 1e-5), bitwise on a second launch."""
    bb, act, new = block_batch_on(cuda)
    B, capD, na, nt = bb.n_windows, bb.capD, bb.na_cap, bb.nt_cap
    P = act.shape[0]
    inc = (bb.det_inc_ptr, bb.det_inc_slot) if given else None
    for fa, fb in ((48, 24), (24, 48)):
        dga = listed_values(bb, (P, na + nt, fa), fa, cuda)[:, :na].contiguous()
        dgb = listed_values(bb, (P, na + nt, fb), fb, cuda)[:, na:].contiguous()
        before = block.LAUNCHES["window_scatter"]
        g2 = [block.window_gather2_backward_raw(dga, dgb, act, new, B, capD, inc)
              for _ in range(2)]
        torch.cuda.synchronize()
        assert block.LAUNCHES["window_scatter"] == before + 2
        assert all(torch.equal(a, b) for a, b in zip(*g2))
        for got, src, ids in zip(g2[0], (dga, dgb), (act, new)):
            assert got.shape == (B * capD, src.shape[2])
            torch.testing.assert_close(got, block.window_scatter_reference(src, ids, B, capD),
                                       rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_block_ops_autograd_launch_their_kernels(cuda):
    """Through autograd: the round launches its forward and backward kernel
    once each, the gather's backward one window scatter for both
    cotangents; the gradients match the CPU's plain backward."""
    args, _ = round_problem(0, 6, 8, 8, 16, cuda)
    he, ga, gb, whh, bhh, web, m = args
    B, capD = 3, 16
    rng = np.random.default_rng(1)
    ga_d = torch.from_numpy(rng.normal(size=(B * capD, 48)).astype(np.float32))
    act = torch.from_numpy(rng.integers(0, capD, (6, 8)).astype(np.int32))
    new = torch.from_numpy(rng.integers(0, capD, (6, 8)).astype(np.int32))
    grads = {}
    for dev in ("cpu", cuda):
        leaves = [t.detach().to(dev).requires_grad_(True) for t in (he, ga_d, whh, bhh, web)]
        h, gd, w, b, we = leaves
        before = dict(block.LAUNCHES)
        a_g, b_g = block.window_gather2(gd, gd, act.to(dev), new.to(dev), B, capD)
        eo, rs, cs, lg = block.fused_block_round(h, a_g, b_g, w, b, we, m.to(dev), -1.0)
        es = block.window_scatter(torch.cat([rs, -cs], 1), torch.cat([act, new], 1).to(dev),
                                  B, capD)
        ((eo ** 2).sum() + lg.sum() + (es ** 2).sum()).backward()
        launched = {k: block.LAUNCHES[k] - before[k] for k in before}
        assert launched == {**dict.fromkeys(block.LAUNCHES, 0), **(
            {} if dev == "cpu" else
            {"block_round_fwd": 1, "block_round_bwd": 1, "window_scatter": 2})}
        grads[str(dev)] = [t.grad.cpu() for t in leaves]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * max(float(b.abs().max()), 1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("call", [
    "block.window_scatter_raw(vals, idx, 2, 16)",
    "block.window_scatter_raw(vals, idx, 2, 16, inc)",
    "block.window_gather2_backward_raw(*(t.contiguous() for t in (vals[:, :1], vals[:, 1:], "
    "ok[:, :1], idx[:, 1:])), 2, 16, inc)",
    "block.window_scatter_raw(vals, ok, 2, 16, (inc[0] + 100, inc[1]))",
    "block.window_scatter_raw(vals, ok, 2, 16, (inc[0] - 1, inc[1]))",
])
def test_window_scatter_traps_an_id_outside_its_window(cuda, call):
    """A window-local id >= capD is a CUDA error at the next synchronisation,
    not a write out of bounds, also where the incidence given does not list
    it; so are an incidence's offsets outside its slots (a process of its
    own: a trap leaves the CUDA context unusable)."""
    code = (
        "import torch\n"
        "from trackmpnn_tpu_torch.ops import block\n"
        "vals = torch.ones(4, 3, 8, device='cuda')\n"
        "ok = torch.zeros(4, 3, dtype=torch.int32, device='cuda')\n"
        "idx = ok.clone(); idx[2, 1] = 16\n"
        "inc = block.window_incidence(ok, 2, 16)\n"
        f"{call}\n"
        "torch.cuda.synchronize()\n"
        "print('no error')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "no error" not in out.stdout, out.stdout
    assert "CUDA error" in out.stderr or "AcceleratorError" in out.stderr, out.stderr[-2000:]


@pytest.mark.cuda
def test_block_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    args, _ = round_problem(0, 4, 8, 8, 16, cuda)
    with pytest.raises(TypeError):
        block._block_round_fwd_cuda(args[0].double(), *args[1:], -1.0)
    with pytest.raises(ValueError):
        block._block_round_fwd_cuda(args[0], args[1].cpu(), *args[2:], -1.0)
    with pytest.raises(ValueError):
        block._block_round_fwd_cuda(args[0].transpose(1, 2), *args[1:], -1.0)
    for H in (12, 264):  # the width rule: multiples of 8 from 8 to 256
        wide, cots = round_problem(0, 2, 3, 3, H, cuda)
        with pytest.raises(ValueError, match=f"H={H}"):
            block._block_round_fwd_cuda(*wide, -1.0)
        with pytest.raises(ValueError, match=f"H={H}"):
            block._block_round_bwd_cuda(*wide, -1.0, *cots)
    vals = torch.zeros(4, 3, 6, device=cuda)
    with pytest.raises(ValueError):
        block.window_scatter_raw(vals, torch.zeros(4, 3, dtype=torch.int32, device=cuda), 2, 8)
    with pytest.raises(TypeError):
        block.window_scatter_raw(vals[..., :4].contiguous(),
                                 torch.zeros(4, 3, dtype=torch.int64, device=cuda), 2, 8)
    ids = torch.zeros(4, 3, dtype=torch.int32, device=cuda)
    ptr, slot = block.window_incidence(ids, 2, 8)
    for bad in ((ptr[:-1], slot), (ptr.long(), slot), (ptr, slot.cpu())):
        with pytest.raises((TypeError, ValueError)):
            block.window_scatter_raw(vals[..., :4].contiguous(), ids, 2, 8, bad)


def gat_problem(seed, nh, P, na, nt, H, keep, device):
    """torch_port_util.gat_inputs as tensors on `device`."""
    x = gat_inputs(seed, nh, keep, P=P, na=na, nt=nt, H=H)
    return {k: [torch.from_numpy(a).to(device) for a in v] for k, v in x.items()}


def assert_close_scaled(got, want, names):
    """rtol 1e-4 with an absolute floor of 1e-5 times each output's scale."""
    for name, a, b in zip(names, got, want):
        atol = 1e-5 * max(float(b.abs().max()), 1.0)
        torch.testing.assert_close(a, b, rtol=1e-4, atol=atol, msg=name)


# the widths the first design refused (its shared memory grew with na, nt and
# nh) are held against the plain versions evaluated in f64: there an exp-sum
# or a d a sums thousands of terms, and two f32 evaluations in different
# orders differ by more than the tolerances allow the kernels
WIDE_NA = 64


def plain_for(plain, na, nt):
    """The plain version, or at the wide widths the plain version in f64."""
    if max(na, nt) < WIDE_NA:
        return plain

    def wide(*args):
        out = in_f64(plain, *args)
        return out[0] if len(out) == 1 else out
    return wide


@pytest.mark.cuda
@pytest.mark.parametrize("nh", [1, 3])
@pytest.mark.parametrize("P,na,nt,H,keep", [(17, 8, 16, 16, 0.5), (120, 24, 24, 64, 1.0),
                                            (3, 5, 40, 32, 0.5), (4, 128, 128, 64, 0.5)])
def test_gat_kernels_match_plain_versions(cuda, nh, P, na, nt, H, keep):
    """The four attention kernels against their plain versions: forwards
    within rtol and atol 1e-5 (a score sums H products and an exp-sum up to
    nt terms, so the rounding of another summation order grows with the
    value), backwards within rtol 1e-4; each bitwise the same on a second
    launch; all-masked rows give exactly 0.  na = nt = 128 (several bands,
    column tiles and row tiles a block) is a width the first design refused
    in both backward kernels; it is held against the plain versions in f64."""
    pr = gat_problem(P + nh, nh, P, na, nt, H, keep, cuda)
    s_args, a_args = pr["scores"], pr["agg"]
    before = dict(gat.LAUNCHES)
    runs = [  # (kernel, plain version, arguments, output names, is a forward)
        (gat._gat_scores_fwd_cuda, gat.gat_scores_stats_reference, (*s_args, 0.2, nh),
         ["e", "rmax", "cmax", "sa_l", "sb_l"], True),
        (gat._gat_scores_bwd_cuda, gat.gat_scores_stats_backward_reference,
         (*s_args, 0.2, nh, *pr["scores_cot"]), ["dha", "dhn", "da"], False),
        (gat._gat_aggregate_fwd_cuda, gat.gat_aggregate_reference, (*a_args, keep),
         ["rs", "cs"], True),
        (gat._gat_aggregate_bwd_cuda, gat.gat_aggregate_backward_reference,
         (*a_args, keep, *pr["agg_cot"]), ["de", "dm_row", "dm_col", "dz_row", "dz_col", "dhe"],
         False),
    ]
    for kernel, plain, args, names, forward in runs:
        got, again, want = kernel(*args), kernel(*args), plain_for(plain, na, nt)(*args)
        torch.cuda.synchronize()
        if forward:
            for name, a, b in zip(names, got, want):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=name)
        else:
            assert_close_scaled(got, want, names)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    rs, cs = gat._gat_aggregate_fwd_cuda(*a_args, keep)
    live = a_args[6] > 0
    assert torch.all(rs[~live.any(2)] == 0) and torch.all(cs[~live.any(1)] == 0)
    assert {k: gat.LAUNCHES[k] - before[k] for k in before} == {
        **dict.fromkeys(before, 0), "gat_scores_fwd": 2, "gat_scores_bwd": 2,
        "gat_aggregate_fwd": 3, "gat_aggregate_bwd": 2}


@pytest.mark.cuda
def test_gat_autograd_launches_its_kernels(cuda):
    """Through the autograd Functions, as the train step calls them: one
    launch of each kernel, and the gradients of the CPU's plain versions."""
    nh, keep = 2, 0.5
    pr = gat_problem(5, nh, 6, 8, 8, 16, keep, "cpu")
    grads = {}
    for dev in ("cpu", cuda):
        s_args = [t.detach().to(dev) for t in pr["scores"]]
        a_args = [t.detach().to(dev) for t in pr["agg"]]
        leaves = [t.requires_grad_(True) for t in s_args[:3] + a_args[:6]]
        before = dict(gat.LAUNCHES)
        e, _, _, sal, sbl = gat.gat_scores_stats(*s_args, 0.2, nh)
        rs, cs = gat.gat_aggregate(*a_args, keep)
        ((e ** 2).sum() + sal.sum() + sbl.sum() + (rs ** 2).sum() + cs.sum()).backward()
        launched = {k: gat.LAUNCHES[k] - before[k] for k in before}
        assert launched == {k: int(dev != "cpu" and k.startswith("gat_")
                                   and not k.endswith("_bf16")) for k in launched}, launched
        grads[str(dev)] = [t.grad.cpu() for t in leaves]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * max(float(b.abs().max()), 1.0))


GAT1_KERNELS = ("gat1_scores_fwd", "gat1_scores_bwd", "gat1_aggregate_fwd", "gat1_aggregate_bwd")
GAT0_KERNELS = ("gat0_scores_fwd", "gat0_scores_bwd")


def gat1_problem(seed, P, na, nt, H, keep, device):
    """One head's inputs (gat_problem at nh = 1 without the head axis)."""
    pr = gat_problem(seed, 1, P, na, nt, H, keep, device)
    e, mr, mc, zr, zc, he, m3, ka, kn = pr["agg"]
    g_e, g_sal, g_sbl = pr["scores_cot"]
    return {"scores": pr["scores"], "scores_cot": [g_e[0], g_sal[0], g_sbl[0]],
            "agg": [e[0], mr[0], mc[0], zr[0], zc[0], he, m3, ka[0], kn[0]],
            "agg_cot": pr["agg_cot"]}


@pytest.mark.cuda
@pytest.mark.parametrize("P,na,nt,H,keep", [(17, 8, 16, 16, 0.5), (120, 24, 24, 64, 1.0),
                                            (120, 24, 24, 64, 0.5), (3, 5, 40, 32, 0.5),
                                            (2, 112, 112, 64, 0.5)])
def test_gat1_kernels_match_plain_versions_and_the_stacked_kernels(cuda, P, na, nt, H, keep):
    """The four single-head kernels (#9 and #10) against their plain
    versions (forwards rtol and atol 1e-5, backwards rtol 1e-4 with atol
    1e-5 x each output's scale), bitwise the same on a second launch, and
    bitwise equal to the stacked kernels at nh = 1, which compute the same
    function; one launch of each a call.  na = nt = 112 is a width the first
    design refused in the score backward (held against the plain versions in
    f64)."""
    pr = gat1_problem(P, P, na, nt, H, keep, cuda)
    s_args, a_args = pr["scores"], pr["agg"]
    stacked_agg = [t[None] for t in a_args[:5]] + a_args[5:7] + [t[None] for t in a_args[7:]]
    before = dict(gat.LAUNCHES)
    runs = [  # (kernel, plain, arguments, stacked kernel, its arguments, names, is a forward)
        (gat._gat1_scores_fwd_cuda, gat.gat_scores_stats_1h_reference, (*s_args, 0.2),
         gat._gat_scores_fwd_cuda, (*s_args, 0.2, 1), ["e", "rmax", "cmax", "sa_l", "sb_l"],
         True),
        (gat._gat1_scores_bwd_cuda, gat.gat_scores_stats_1h_backward_reference,
         (*s_args, 0.2, *pr["scores_cot"]), gat._gat_scores_bwd_cuda,
         (*s_args, 0.2, 1, *(t[None] for t in pr["scores_cot"])), ["dha", "dhn", "da"], False),
        (gat._gat1_aggregate_fwd_cuda, gat.gat_aggregate_1h_reference, (*a_args, keep),
         gat._gat_aggregate_fwd_cuda, (*stacked_agg, keep), ["rs", "cs"], True),
        (gat._gat1_aggregate_bwd_cuda, gat.gat_aggregate_1h_backward_reference,
         (*a_args, keep, *pr["agg_cot"]), gat._gat_aggregate_bwd_cuda,
         (*stacked_agg, keep, *pr["agg_cot"]),
         ["de", "dm_row", "dm_col", "dz_row", "dz_col", "dhe"], False),
    ]
    for kernel, plain, args, stacked, st_args, names, forward in runs:
        got, again, st = kernel(*args), kernel(*args), stacked(*st_args)
        want = plain_for(plain, na, nt)(*args)
        torch.cuda.synchronize()
        if forward:
            for name, a, b in zip(names, got, want):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=name)
        else:
            assert_close_scaled(got, want, names)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        assert all(torch.equal(a, b.reshape(a.shape)) for a, b in zip(got, st))
    rs, cs = gat._gat1_aggregate_fwd_cuda(*a_args, keep)
    live = a_args[6] > 0
    assert torch.all(rs[~live.any(2)] == 0) and torch.all(cs[~live.any(1)] == 0)
    assert {k: gat.LAUNCHES[k] - before[k] for k in GAT1_KERNELS} == {
        "gat1_scores_fwd": 2, "gat1_scores_bwd": 2, "gat1_aggregate_fwd": 3,
        "gat1_aggregate_bwd": 2}


@pytest.mark.cuda
def test_gat1_autograd_launches_its_kernels(cuda):
    """Through the single-head autograd Functions, as the per-head route
    calls them: one launch of each single-head kernel and none of the
    stacked ones on the card, none on the CPU, and the CPU's gradients."""
    keep = 0.5
    pr = gat1_problem(6, 6, 8, 8, 16, keep, "cpu")
    grads = {}
    for dev in ("cpu", cuda):
        s_args = [t.detach().to(dev) for t in pr["scores"]]
        a_args = [t.detach().to(dev) for t in pr["agg"]]
        leaves = [t.requires_grad_(True) for t in s_args[:3] + a_args[:6]]
        before = dict(gat.LAUNCHES)
        e, _, _, sal, sbl = gat.gat_scores_stats_1h(*s_args, 0.2)
        rs, cs = gat.gat_aggregate_1h(*a_args, keep)
        ((e ** 2).sum() + sal.sum() + sbl.sum() + (rs ** 2).sum() + cs.sum()).backward()
        launched = {k: gat.LAUNCHES[k] - before[k] for k in before}
        assert launched == {k: int(dev != "cpu" and k in GAT1_KERNELS) for k in launched}
        grads[str(dev)] = [t.grad.cpu() for t in leaves]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * max(float(b.abs().max()), 1.0))


@pytest.mark.cuda
def test_gat1_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    pr = gat1_problem(0, 4, 8, 8, 16, 0.5, cuda)
    ha, hn, a, m = pr["scores"]
    e, mr, mc, zr, zc, he, m3, ka, kn = pr["agg"]
    with pytest.raises(TypeError):
        gat._gat1_scores_fwd_cuda(ha.double(), hn, a, m, 0.2)
    with pytest.raises(ValueError):
        gat._gat1_scores_fwd_cuda(ha, hn.cpu(), a, m, 0.2)
    with pytest.raises(TypeError):
        gat._gat1_scores_fwd_cuda(ha, hn, a[:8], m, 0.2)  # a of another width
    with pytest.raises(TypeError):
        gat._gat1_scores_bwd_cuda(ha, hn, a, m, 0.2, e[:, :, :4], mr, mc)
    with pytest.raises(TypeError):
        gat._gat1_aggregate_fwd_cuda(e[None], mr, mc, zr, zc, he, m3, ka, kn, 0.5)  # a head axis
    with pytest.raises(TypeError):
        gat._gat1_aggregate_fwd_cuda(e, mr, mc, zr, zc, he, m3, ka[None], kn, 0.5)
    with pytest.raises(ValueError):
        gat._gat1_aggregate_fwd_cuda(e, mr, mc, zr, zc, he.transpose(1, 2), m3, ka, kn, 0.5)
    with pytest.raises(TypeError):
        gat._gat1_aggregate_bwd_cuda(e, mr, mc, zr, zc, he, m3, ka, kn, 0.5,
                                     pr["agg_cot"][0][:, :4], pr["agg_cot"][1])


def unaligned(t):
    """t's values in a contiguous tensor whose data starts 4 bytes past a
    16-byte boundary (the aggregate kernels then load one float a lane)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("P,na,nt,nh,H,keep,shift", [(3, 70, 9, 2, 6, 0.5, False),
                                                     (2, 9, 33, 1, 130, 1.0, False),
                                                     (2, 33, 65, 2, 72, 0.5, True)])
def test_gat_kernels_take_any_width(cuda, P, na, nt, nh, H, keep, shift):
    """Widths the training paths do not reach: H not a multiple of 4 or
    beyond one staged chunk of 64 units, several bands, column tiles and row
    tiles a block, and (shift) h_e and the cotangents off a 16-byte boundary,
    so one float a lane: each attention kernel against its plain version in
    f64 (forwards rtol and atol 1e-5, backwards rtol 1e-4 with atol 1e-5 x
    each output's scale), bitwise the same on a second launch."""
    pr = gat_problem(P * nh + H, nh, P, na, nt, H, keep, cuda)
    s_args, a_args, cots = pr["scores"], list(pr["agg"]), list(pr["agg_cot"])
    if shift:
        a_args[5] = unaligned(a_args[5])
        cots = [unaligned(c) for c in cots]
    runs = [
        (gat._gat_scores_fwd_cuda, gat.gat_scores_stats_reference, (*s_args, 0.2, nh), True),
        (gat._gat_scores_bwd_cuda, gat.gat_scores_stats_backward_reference,
         (*s_args, 0.2, nh, *pr["scores_cot"]), False),
        (gat._gat_aggregate_fwd_cuda, gat.gat_aggregate_reference, (*a_args, keep), True),
        (gat._gat_aggregate_bwd_cuda, gat.gat_aggregate_backward_reference,
         (*a_args, keep, *cots), False),
    ]
    for kernel, plain, args, forward in runs:
        got, again, want = kernel(*args), kernel(*args), in_f64(plain, *args)
        torch.cuda.synchronize()
        if forward:
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        else:
            assert_close_scaled(got, want, [str(k) for k in range(len(want))])
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_gat_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    pr = gat_problem(0, 2, 4, 8, 8, 16, 0.5, cuda)
    ha, hn, a, m = pr["scores"]
    e, mr, mc, zr, zc, he, m3, ka, kn = pr["agg"]
    with pytest.raises(TypeError):
        gat._gat_scores_fwd_cuda(ha.double(), hn, a, m, 0.2, 2)
    with pytest.raises(ValueError):
        gat._gat_scores_fwd_cuda(ha, hn.cpu(), a, m, 0.2, 2)
    with pytest.raises(ValueError):
        gat._gat_scores_fwd_cuda(ha, hn, a, m, 0.2, 3)  # 32 features are not 3 heads
    with pytest.raises(ValueError):
        gat._gat_scores_fwd_cuda(ha, hn, a, m.transpose(1, 2), 0.2, 2)
    with pytest.raises(TypeError):
        gat._gat_aggregate_fwd_cuda(e, mr, mc, zr, zc, he.double(), m3, ka, kn, 0.5)
    with pytest.raises(ValueError):
        gat._gat_aggregate_fwd_cuda(e, mr, mc, zr, zc, he, m3, ka.repeat(2, 1, 1, 1),
                                    kn.repeat(2, 1, 1, 1), 0.5)  # 4 mask heads for 2
    with pytest.raises(TypeError):
        gat._gat_aggregate_bwd_cuda(e, mr, mc, zr, zc, he, m3, ka, kn, 0.5,
                                    pr["agg_cot"][0][:, :4], pr["agg_cot"][1])


@pytest.mark.cuda
def test_mp_autograd_launches_each_kernel_as_the_others_backward(cuda):
    """gather_diff's backward is one signed_segment_sum launch and the other
    way round; the gradients match the CPU's plain versions (d gather_diff
    within atol 1e-5, f64 sums in another order; d signed_segment_sum
    exact)."""
    n, h = 512, 64
    hid, past, fut, edge = problem(9, n, h, "cpu")
    cot = torch.from_numpy(np.random.default_rng(1).normal(size=(n, h)).astype(np.float32))
    grads = {}
    for dev in ("cpu", cuda):
        x = hid.to(dev).requires_grad_(True)
        idx = [t.to(dev) for t in (past, fut, edge)]
        before = dict(mp.LAUNCHES)
        (g_gd,) = torch.autograd.grad((mp.gather_diff(x, *idx) * cot.to(dev)).sum(), x)
        (g_ss,) = torch.autograd.grad((mp.signed_segment_sum(x, *idx, n) * cot.to(dev)).sum(), x)
        launched = {k: mp.LAUNCHES[k] - before[k] for k in before}
        assert launched == ({"gather_diff": 0, "signed_segment_sum": 0, "fused_edge_gru": 0,
                             "gather_concat": 0, "segment_sum_halves": 0}
                            if dev == "cpu" else
                            {"gather_diff": 2, "signed_segment_sum": 2, "fused_edge_gru": 0,
                             "gather_concat": 0, "segment_sum_halves": 0})
        grads[str(dev)] = (g_gd.cpu(), g_ss.cpu())
    torch.testing.assert_close(grads["cuda"][0], grads["cpu"][0], rtol=0, atol=1e-5)
    assert torch.equal(grads["cuda"][1], grads["cpu"][1])
    # a gradient needs n == N on the card as on the CPU; without one any n runs
    x = hid.to(cuda).requires_grad_(True)
    idx = [t.to(cuda) for t in (past, fut, edge)]
    with pytest.raises(ValueError, match="n == N"):
        mp.signed_segment_sum(x, *idx, n + 1)
    with torch.no_grad():
        assert mp.signed_segment_sum(x, *idx, n + 1).shape == (n + 1, h)


def round_problem_on(seed, B, cap, H, device):
    """torch_port_util.round_inputs as tensors on `device`, with the incidence."""
    h, idxw, we, wn, cot = round_inputs(seed, B, cap, H)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    inc = [put(a) for a in rnd.round_incidence(idxw)]
    return (put(h), put(idxw), inc, {k: put(v) for k, v in we.items()},
            {k: put(v) for k, v in wn.items()}, put(cot))


def round_plain_f64(h, idxw, xin, d4, dxin, ddir, g, we, wn):
    """The four round stages' plain versions evaluated in f64, rounded to
    f32: at H 128 two f32 evaluations in different orders differ by about
    the tolerances."""
    w64 = lambda w: {k: v.double() for k, v in w.items()}
    we64, wn64 = w64(we), w64(wn)
    return {
        "round_fwd": in_f64(lambda a, b: rnd.round_fwd_reference(a, b, we64, wn64), h, idxw),
        "round_bwd_gru": in_f64(lambda a, b, c, d: rnd.round_bwd_gru_reference(
            a, b, c, d, we64, wn64), h, idxw, xin, g),
        "round_bwd_dw": in_f64(lambda a, b, c, d: [v for w in rnd.round_bwd_dw_reference(
            a, b, c, d) for v in w.values()], h, idxw, xin, d4),
        "round_bwd_dh": in_f64(rnd.round_bwd_dh_reference, idxw, dxin, ddir),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("B,cap,H", [(2, 64, 64), (3, 300, 32), (1, 129, 16), (8, 1024, 64),
                                     (2, 256, 128), (2, 128, 48)])
def test_round_kernels_match_plain_versions(cuda, B, cap, H):
    """The four kernels of the fused round against their plain versions
    evaluated in f64: the forward (out and xin) within atol 1e-5, dead rows
    exactly 0; the backward stages within rtol 1e-4 and an atol of 1e-5 x
    each output's scale; each bitwise the same on a second launch.  H 128
    and 48 are widths the first design refused."""
    h, idxw, (ip, ii), we, wn, g = round_problem_on(B * cap + H, B, cap, H, cuda)
    before = dict(rnd.LAUNCHES)
    out, xin = rnd.round_fwd_reference(h, idxw, we, wn)
    d4, dxin, ddir = rnd.round_bwd_gru_reference(h, idxw, xin, g, we, wn)
    plain = round_plain_f64(h, idxw, xin, d4, dxin, ddir, g, we, wn)
    runs = [
        ("round_fwd", lambda: rnd._round_fwd_cuda(h, idxw, ip, ii, we, wn), True),
        ("round_bwd_gru", lambda: rnd._round_bwd_gru_cuda(h, idxw, xin, g, we, wn), False),
        ("round_bwd_dw",
         lambda: [v for w in rnd._round_bwd_dw_cuda(h, idxw, xin, d4) for v in w.values()],
         False),
        ("round_bwd_dh", lambda: (rnd._round_bwd_dh_cuda(idxw, ip, ii, dxin, ddir),), False),
    ]
    for name, kernel, forward in runs:
        got, again, want = kernel(), kernel(), plain[name]
        torch.cuda.synchronize()
        for k, (a, b) in enumerate(zip(got, want)):
            if forward:
                torch.testing.assert_close(a, b, rtol=0, atol=1e-5, msg=f"{name} {k}")
            else:
                atol = 1e-5 * max(float(b.abs().max()), 1.0)
                torch.testing.assert_close(a, b, rtol=1e-4, atol=atol, msg=f"{name} {k}")
        assert all(torch.equal(a, b) for a, b in zip(got, again)), name
    dead = (idxw[..., 2] == 0) & (idxw[..., 3] == 0)
    got_out, got_xin = rnd._round_fwd_cuda(h, idxw, ip, ii, we, wn)
    assert torch.all(got_out[dead] == 0) and torch.all(got_xin[dead] == 0)
    assert {k: rnd.LAUNCHES[k] - before[k] for k in before} == {
        "round_fwd": 3, "round_bwd_gru": 2, "round_bwd_dw": 2, "round_bwd_dh": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("H", [64, 128, 256])
def test_round_bwd_dh_walks_a_detection_with_many_incident_edges(cuda, H):
    """round_bwd_dh at a round whose detection row 0 has 72 incident edges
    (a listed edge dead at this step), so a row's entries cross several
    staged lists (of 16 lanes at H 64, 32 above): against the plain version
    evaluated in f64 within rtol 1e-4 and atol 1e-5 x scale, bitwise the
    same on a second launch, one launch a call."""
    h, idxw, we, wn, cot, ip, ii = hub_round_inputs(H, H=H)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    h, idxw, g, ip, ii = put(h), put(idxw), put(cot), put(ip), put(ii)
    we, wn = ({k: put(v) for k, v in w.items()} for w in (we, wn))
    assert int(ip[1] - ip[0]) > 64
    xin = rnd.round_fwd_reference(h, idxw, we, wn)[1]
    _, dxin, ddir = rnd.round_bwd_gru_reference(h, idxw, xin, g, we, wn)
    before = rnd.LAUNCHES["round_bwd_dh"]
    got, again = (rnd._round_bwd_dh_cuda(idxw, ip, ii, dxin, ddir) for _ in range(2))
    (want,) = in_f64(rnd.round_bwd_dh_reference, idxw, dxin, ddir)
    torch.cuda.synchronize()
    assert rnd.LAUNCHES["round_bwd_dh"] == before + 2
    assert_close_scaled([got], [want], ["d h"])
    assert torch.equal(got, again)
    assert float((got[0, 0] - ddir[0, 0]).abs().max()) > 0


@pytest.mark.cuda
def test_fused_round_autograd_on_the_card_matches_the_cpu(cuda):
    """Through FusedRound, as the packed step calls it: one launch of each
    kernel, and the CPU's gradients (rtol 1e-4, atol 1e-5 x scale)."""
    grads = {}
    for dev in ("cpu", cuda):
        h, idxw, inc, we, wn, g = round_problem_on(3, 2, 256, 64, dev)
        leaves = [h] + [we[k] for k in ROUND_KEYS] + [wn[k] for k in ROUND_KEYS]
        for leaf in leaves:
            leaf.requires_grad_(True)
        before = dict(rnd.LAUNCHES)
        out = rnd.fused_round(h, idxw, we, wn, inc=inc)
        grads[str(dev)] = [out.detach().cpu()] + [
            t.cpu() for t in torch.autograd.grad(out, leaves, g)]
        launched = {k: rnd.LAUNCHES[k] - before[k] for k in before}
        assert set(launched.values()) == ({0} if dev == "cpu" else {1}), launched
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * max(float(b.abs().max()), 1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["idxw[0, 3] = torch.tensor([64, 0, 1, 0], dtype=torch.int32)",
                                 "ii[0] = 64"])
def test_round_kernels_trap_an_index_outside_the_window(cuda, bad):
    """An edge's endpoint or an incidence entry outside the window is a CUDA
    error at the next synchronisation (a process of its own: a trap leaves
    the CUDA context unusable)."""
    code = (
        "import numpy as np, torch, sys\n"
        "sys.path.insert(0, 'tests')\n"
        "from torch_port_util import round_inputs\n"
        "from trackmpnn_tpu_torch.ops import round as rnd\n"
        "h, idxw, we, wn, _ = round_inputs(0, 1, 64, 16)\n"
        "ip, ii = (torch.from_numpy(a).cuda() for a in rnd.round_incidence(idxw))\n"
        "h, idxw = torch.from_numpy(h).cuda(), torch.from_numpy(idxw).cuda()\n"
        "we = {k: torch.from_numpy(v).cuda() for k, v in we.items()}\n"
        "wn = {k: torch.from_numpy(v).cuda() for k, v in wn.items()}\n"
        "idxw[:, :, 2:] = 0; idxw[0, :8, 3] = 1\n"
        f"{bad}\n"
        "rnd._round_fwd_cuda(h, idxw, ip, ii, we, wn)\n"
        "torch.cuda.synchronize()\n"
        "print('no error')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "no error" not in out.stdout, out.stdout
    assert "CUDA error" in out.stderr or "AcceleratorError" in out.stderr, out.stderr[-2000:]


@pytest.mark.cuda
def test_round_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    h, idxw, (ip, ii), we, wn, g = round_problem_on(0, 2, 64, 16, cuda)
    with pytest.raises(TypeError):
        rnd._round_fwd_cuda(h.double(), idxw, ip, ii, we, wn)
    with pytest.raises(TypeError):
        rnd._round_fwd_cuda(h, idxw.long(), ip, ii, we, wn)
    with pytest.raises(ValueError):
        rnd._round_fwd_cuda(h, idxw.cpu(), ip, ii, we, wn)
    with pytest.raises(ValueError):
        rnd._round_fwd_cuda(h.transpose(0, 1), idxw, ip, ii, we, wn)
    with pytest.raises(TypeError):
        rnd._round_fwd_cuda(h, idxw, ip[:-1], ii, we, wn)
    for H in (12, 264):  # widths the kernels do not take: not a multiple of 8, above 256
        hh = torch.zeros(2, 64, H, device=cuda)
        ww = {k: torch.zeros(s, device=cuda) for k, s in
              zip(ROUND_KEYS, [(H, 3 * H), (H, 3 * H), (3 * H,), (3 * H,)])}
        with pytest.raises(ValueError, match=f"H={H}"):
            rnd._round_fwd_cuda(hh, idxw, ip, ii, ww, ww)
    with pytest.raises(TypeError):
        rnd._round_bwd_gru_cuda(h, idxw, h, g[:, :8], we, wn)
    with pytest.raises(TypeError):
        rnd._round_bwd_dh_cuda(idxw, ip, ii, h, h[:, :, :8].contiguous())
    shifted = torch.empty(h.numel() + 1, device=cuda)[1:].view(h.shape)  # 4 bytes off
    with pytest.raises(ValueError, match="16-byte aligned"):
        rnd._round_bwd_dh_cuda(idxw, ip, ii, shifted, h)


# ------------------------------------------------ es round and edge losses ----
ES_SHAPES = [dict(B=3, T=3, capD=16, na=5, nt=6, H=8),
             dict(B=8, T=15, capD=256, na=24, nt=24, H=64),
             dict(B=4, T=4, capD=128, na=64, nt=64, H=128),
             dict(B=2, T=2, capD=64, na=24, nt=24, H=256),
             dict(B=3, T=1, capD=48, na=5, nt=40, H=40)]


def es_problem(seed, sign, device, P=None, **shape):
    """torch_port_util.es_inputs as the es round's arguments on `device`
    (its first P blocks) and its cotangents."""
    act, new, blk_na, blk_nt, w, cot = es_inputs(seed, sign, **shape)
    B, capD = shape["B"], shape["capD"]
    P = P or act.shape[0]
    ip, islot = block.block_incidence(act, new, blk_na, blk_nt, B * capD)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    ga_d = put(w["ga_d"])
    gb_d = ga_d if sign < 0 else put(w["gb_d"])
    args = (put(w["h_e"][:P] * w["mask3"][:P, :, :, None]), put((act % capD)[:P].astype(np.int32)),
            put((new % capD)[:P].astype(np.int32)), ga_d, gb_d, put(w["b_ih"]), put(w["w_hh"]),
            put(w["b_hh"]), put(w["w_eb"]), put(w["mask3"][:P]), sign, B, capD, put(ip),
            put(islot))
    return args, [put(cot["g_eo"][:P]), put(cot["g_lg"][:P]), put(cot["g_es"])]


@pytest.mark.cuda
@pytest.mark.parametrize("sign", [-1.0, 1.0])
@pytest.mark.parametrize("shape", ES_SHAPES, ids=["small", "training", "h128", "h256", "h40"])
def test_es_round_kernels_match_plain_versions(cuda, sign, shape):
    """block_round_es_fwd within atol 1e-5 (padded cells exactly 0), the
    backward within rtol 1e-4 and atol 1e-5 x each output's scale; both
    bitwise the same on a second launch; a round over fewer blocks than the
    incidence lists too."""
    for P in (None, 2 * shape["B"]):
        args, cots = es_problem(7, sign, cuda, P, **shape)
        before = dict(block.LAUNCHES)
        got = block._block_round_es_fwd_cuda(*args)
        again = block._block_round_es_fwd_cuda(*args)
        want = in_f64(block.block_round_es_reference, *args)
        torch.cuda.synchronize()
        for a, b, c in zip(got, want, again):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
            assert torch.equal(a, c)
        m = args[9]
        assert torch.all(got[0][m == 0] == 0) and torch.all(got[1][m == 0] == 0)
        gb = block._block_round_es_bwd_cuda(*args, *cots)
        gb2 = block._block_round_es_bwd_cuda(*args, *cots)
        wb = in_f64(block.block_round_es_backward_reference, *args, *cots)
        torch.cuda.synchronize()
        assert_close_scaled(gb, wb, ["dhe", "dga_d", "dgb_d", "dbih", "dwhh", "dbhh", "dweb"])
        assert all(torch.equal(a, b) for a, b in zip(gb, gb2))
        assert block.LAUNCHES["block_round_es_fwd"] == before["block_round_es_fwd"] + 2
        assert block.LAUNCHES["block_round_es_bwd"] == before["block_round_es_bwd"] + 2


def edge_loss_problem(seed, device, **shape):
    x, d_part = edge_loss_inputs(seed, **shape)
    args = [torch.from_numpy(np.asarray(x[k])).to(device) if k != "nD" else x[k]
            for k in EDGE_LOSS_KEYS]
    return args, torch.from_numpy(d_part).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,shape", [(3, dict(P=11, na=8, nt=8, K=16, nD=32)),
                                        (3, dict(P=120, na=24, nt=24, K=64, nD=2048)),
                                        (3, dict(P=120, na=24, nt=24, K=192, nD=2048)),
                                        (3, dict(P=13, na=8, nt=8, K=48, nD=32)),
                                        (3, dict(P=11, na=8, nt=8, K=384, nD=32)),
                                        (4, dict(P=4, na=128, nt=128, K=192, nD=2048)),
                                        (3, dict(P=5, na=37, nt=29, K=50, nD=2048))],
                         ids=["small", "training", "three_branches", "k48", "k384", "wide128",
                              "ragged_k50"])
def test_edge_loss_kernels_match_plain_versions(cuda, seed, shape):
    """L1 and L2 within atol 1e-5 (the counts exact), the backward within
    rtol 1e-4 and atol 1e-5 x each output's scale; the logits and the
    backward against their plain versions evaluated in f64 (a block of 128 x
    128 sums tens of thousands of terms, and two f32 orders differ by about
    the tolerances), L1's row statistics against the plain version's of the
    kernel's logits in f64, L2 against its plain version, which sums in f64 the f32
    terms the kernel forms (in f64 the terms would move a block's BCE sum
    of ~10^4 by several ulps of its f32 result); each bitwise the same on a
    second launch, each launched once a call.  The head width
    K = nb*H: one branch at H 16 and 64, three at H 64 (192), and widths that
    do not divide the backward's 256 threads (48, 50) or exceed them (384);
    na = nt = 128 (a block the first design held whole in shared memory: the
    kernels' shared memory grows with nt only), and na 37, nt 29 (a last
    tile of one row, K % 4 != 0)."""
    (h_eo, w_e, b_e, lbl, m3, ebnt, bna, act, act_m, nD), d_part = edge_loss_problem(
        seed, cuda, **shape)
    before = dict(loss.LAUNCHES)
    l1 = [loss._l1_cuda(h_eo, w_e, b_e, lbl, m3, ebnt) for _ in range(2)]
    # the logits against the plain version in f64, the row statistics against
    # the plain version's of the kernel's own logits in f64 (at nt 128 an f32
    # logit's rounding alone moves s_r by ~1e-5)
    want = in_f64(loss.edge_loss_l1_reference, h_eo, w_e, b_e, lbl, m3, ebnt)[:1] + in_f64(
        loss.edge_loss_row_stats, l1[0][0], lbl, m3, ebnt)
    torch.cuda.synchronize()
    for a, b, c in zip(l1[0], want, l1[1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
        assert torch.equal(a, c)
    logits, r_min, m_r, s_r = loss.edge_loss_l1_reference(h_eo, w_e, b_e, lbl, m3, ebnt)
    glue = loss.edge_loss_glue(r_min, m_r, s_r, m3, ebnt, act, act_m, nD)
    l2 = [loss._l2_cuda(logits, lbl, m3, ebnt, bna, *glue) for _ in range(2)]
    want2 = loss.edge_loss_l2_reference(logits, lbl, m3, ebnt, bna, *glue)
    torch.cuda.synchronize()
    assert torch.equal(l2[0], l2[1])
    assert torch.equal(l2[0][:, EDGE_LOSS_COUNTS], want2[:, EDGE_LOSS_COUNTS])
    torch.testing.assert_close(l2[0], want2, rtol=0, atol=1e-5)
    wg = loss.edge_loss_spread(r_min, glue[0], glue[2], d_part, act, act_m, nD)
    bargs = (h_eo, w_e, logits, lbl, m3, ebnt, bna, *glue, wg, d_part)
    gb = [loss._bwd_cuda(*bargs) for _ in range(2)]
    wb = in_f64(loss.edge_loss_bwd_reference, *bargs)
    torch.cuda.synchronize()
    assert_close_scaled(gb[0], wb, ["dheo", "dwe", "dbe"])
    assert all(torch.equal(a, b) for a, b in zip(*gb))
    assert {k: loss.LAUNCHES[k] - before[k] for k in before} == dict.fromkeys(before, 2)


@pytest.mark.cuda
def test_es_round_and_edge_losses_autograd_on_the_card_match_the_cpu(cuda):
    """Through autograd, as the block step with es_kernel and fused_loss
    calls them: one launch of each kernel on the card, none on the CPU, and
    the CPU's gradients (rtol 1e-4, atol 1e-5 x scale)."""
    shape = dict(B=3, T=3, capD=16, na=5, nt=6, H=16)
    grads = {}
    for dev in ("cpu", cuda):
        args, cots = es_problem(4, -1.0, dev, **shape)
        (he, act_l, new_l, ga_d, _, b_ih, w_hh, b_hh, w_eb, m3, sign, B, capD, ip, islot) = args
        leaves = [t.clone().requires_grad_(True) for t in (he, ga_d, b_ih, w_hh, b_hh, w_eb)]
        h, gd, bi, wh, bh, we = leaves
        before = {**block.LAUNCHES, **loss.LAUNCHES}
        eo, lg, es = block.fused_block_round_es(h, act_l, new_l, gd, gd, bi, wh, bh, we, m3,
                                                sign, B, capD, (ip, islot))
        P, na, nt = m3.shape
        act = (act_l.long() + (torch.arange(P, device=m3.device) % B)[:, None] * capD).int()
        ebnt = torch.stack([torch.arange(P, device=m3.device).float() * na * nt,
                            m3[:, 0].sum(1)], 1).contiguous()
        lbl = (torch.arange(na * nt, device=m3.device).reshape(1, na, nt) % 3 == 0).float() * m3
        part = loss.edge_losses(eo, we, torch.full((1, 1), -0.5, device=m3.device), lbl, m3,
                                ebnt, m3[:, :, 0].sum(1, keepdim=True).contiguous(), act,
                                (m3[:, :, 0] > 0.5).reshape(-1), B * capD)
        total = ((part[:, :3] ** 2).sum() + (eo * cots[0]).sum() + (lg * cots[1]).sum()
                 + (es * cots[2]).sum())
        grads[str(dev)] = [g.cpu() for g in torch.autograd.grad(total, leaves)]
        launched = {k: v - before[k] for k, v in {**block.LAUNCHES, **loss.LAUNCHES}.items()}
        want = {k: 0 for k in launched}
        if dev != "cpu":
            want.update(dict.fromkeys(["block_round_es_fwd", "block_round_es_bwd",
                                       "edge_loss_l1", "edge_loss_l2", "edge_loss_bwd"], 1))
        assert launched == want
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * max(float(b.abs().max()), 1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["args[1][2, 0] = 16", "args[2][3, 1] = -1"])
def test_es_round_traps_an_id_outside_its_window(cuda, bad):
    """A window-local row or column id outside [0, capD) is a CUDA error at
    the next synchronisation (a process of its own: a trap leaves the CUDA
    context unusable)."""
    code = (
        "import sys, torch\n"
        "sys.path.insert(0, 'tests')\n"
        "from test_torch_cuda import es_problem\n"
        "from trackmpnn_tpu_torch.ops import block\n"
        "args, _ = es_problem(1, -1.0, 'cuda', B=3, T=3, capD=16, na=5, nt=6, H=8)\n"
        "args = list(args); args[9].fill_(1.0)\n"
        f"{bad}\n"
        "block._block_round_es_fwd_cuda(*args)\n"
        "torch.cuda.synchronize()\n"
        "print('no error')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "no error" not in out.stdout, out.stdout
    assert "CUDA error" in out.stderr or "AcceleratorError" in out.stderr, out.stderr[-2000:]


@pytest.mark.cuda
def test_es_round_and_edge_loss_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    args, cots = es_problem(0, -1.0, cuda, B=3, T=3, capD=16, na=5, nt=6, H=8)
    swap = lambda i, v: args[:i] + (v,) + args[i + 1:]
    with pytest.raises(TypeError):
        block._block_round_es_fwd_cuda(*swap(1, args[1].long()))
    with pytest.raises(TypeError):
        block._block_round_es_fwd_cuda(*swap(3, args[3][:-1]))
    with pytest.raises(TypeError):
        block._block_round_es_fwd_cuda(*swap(13, args[13][:-1]))
    with pytest.raises(ValueError):
        block._block_round_es_fwd_cuda(*swap(14, args[14].cpu()))
    with pytest.raises(ValueError):
        block._block_round_es_fwd_cuda(*swap(0, args[0].transpose(1, 2)))
    with pytest.raises(TypeError):
        block._block_round_es_bwd_cuda(*args, cots[0], cots[1], cots[2][:, :4])
    (h_eo, w_e, b_e, lbl, m3, ebnt, bna, act, act_m, nD), d_part = edge_loss_problem(
        0, cuda, K=48)
    with pytest.raises(TypeError):
        loss._l1_cuda(h_eo.double(), w_e, b_e, lbl, m3, ebnt)
    with pytest.raises(ValueError):
        loss._l1_cuda(h_eo, w_e, b_e, lbl, m3.cpu(), ebnt)
    with pytest.raises(TypeError):
        loss._l2_cuda(lbl, lbl, m3, ebnt, bna[:, 0], *(lbl[:, :, 0].contiguous(),) * 3)
    z = lbl[:, :, 0].contiguous()
    with pytest.raises(TypeError):  # a cotangent of the partials of another shape
        loss._bwd_cuda(h_eo, w_e, lbl, lbl, m3, ebnt, bna, z, z, z, z, d_part[:, :7].contiguous())


# ------------------------------------------------ bounded deformable conv ----
DCN_SHAPES = [dict(N=2, H=7, W=9, C=5, O=4), dict(N=2, H=13, W=21, C=64, O=64),
              dict(N=1, H=12, W=40, C=512, O=256), dict(N=4, H=24, W=80, C=128, O=64),
              dict(N=8, H=96, W=320, C=64, O=64), dict(N=8, H=12, W=40, C=512, O=256)]
# DCN_SHAPES from here on: the widest deform block and the widest projection
# of the bounded DLA-34 step at 8 x 384 x 1280, held against the plain
# versions evaluated in f64 (sums of 9 x 512 products and of 245,760 pixels
# in two f32 orders differ by about the tolerances)
DCN_WIDE = 4


def dcn_problem(seed, device, kind="mixed", max_offset=2.0, **shape):
    x = dcn_inputs(seed, kind=kind, max_offset=max_offset, **shape)
    return [torch.from_numpy(x[k]).to(device) for k in DCN_KEYS]


def dcn_kernel_outputs(xs, w, b, off, m, g, max_offset, plain, wide=False):
    """[out, d weight, d offset, d mask, d x] of the kernels, or of their
    plain versions (in f64 where wide)."""
    N, H, W, C = xs.shape
    dcols = (g.reshape(-1, w.shape[1]) @ w.t()).reshape(N, H, W, 9 * C)
    if plain:
        run = (lambda fn, *a: in_f64(fn, *a)) if wide else (
            lambda fn, *a: list(fn(*a)) if fn is dcn.dcn_sample_backward_reference else [fn(*a)])
        return (run(dcn.dcn_forward_reference, xs, w, b, off, m, max_offset)
                + run(dcn.dcn_sample_backward_reference, xs, off, m, dcols, g, max_offset)
                + run(dcn.dcn_dx_reference, off, m, dcols, max_offset))
    return ([dcn._fwd_cuda(xs, w, b, off, m, max_offset)]
            + list(dcn._sample_cuda(xs, off, m, dcols, g, max_offset))
            + [dcn._dx_cuda(off, m, dcols, max_offset)])


@pytest.mark.cuda
@pytest.mark.parametrize("kind,max_offset", [("mixed", 2.0), ("int", 2.0), ("beyond", 1.5),
                                             ("frac", 0.0)])
@pytest.mark.parametrize("shape", DCN_SHAPES,
                         ids=["tiny", "c64", "c512", "c128", "widest", "widest_proj"])
def test_dcn_kernels_match_plain_versions(cuda, shape, kind, max_offset):
    """dcn_fwd within atol 1e-5 x the output's scale; d weight, d offset, d
    mask and d x within rtol 1e-4, atol 1e-5 x each output's scale (the
    wide shapes against the plain versions in f64); each bitwise the same
    on a second launch; d offset exactly 0 at integer offsets."""
    args = dcn_problem(3, cuda, kind, max_offset, **shape)
    wide = DCN_SHAPES.index(shape) >= DCN_WIDE
    before = dict(dcn.LAUNCHES)
    got = dcn_kernel_outputs(*args, max_offset, plain=False)
    again = dcn_kernel_outputs(*args, max_offset, plain=False)
    want = dcn_kernel_outputs(*args, max_offset, plain=True, wide=wide)
    torch.cuda.synchronize()
    assert {k: dcn.LAUNCHES[k] - before[k] for k in before} == dict.fromkeys(before, 2)
    for i, (a, b) in enumerate(zip(got, want)):
        scale = max(float(b.abs().max()), 1e-30)
        if i == 0:
            assert float((a - b).abs().max()) <= 1e-5 * scale
        else:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * scale)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if kind == "int" or max_offset == 0.0:
        assert not got[2].any()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [DCN_SHAPES[1], DCN_SHAPES[4]], ids=["c64", "widest"])
@pytest.mark.parametrize("kind", ["mixed", "int"])
def test_dcn_bwd_dx_at_reach_8(cuda, shape, kind):
    """dcn_bwd_dx at the widest reach the kernels take (max_offset 8: a halo
    of 27 x 35 pixels a tile) against its plain version in f64, rtol 1e-4,
    atol 1e-5 x the scale, and bitwise the same on a second launch."""
    xs, w, b, off, m, g = dcn_problem(7, cuda, kind, float(dcn.MAX_REACH), **shape)
    N, H, W, C = xs.shape
    dcols = (g.reshape(-1, w.shape[1]) @ w.t()).reshape(N, H, W, 9 * C)
    before = dcn.LAUNCHES["dcn_bwd_dx"]
    got = dcn._dx_cuda(off, m, dcols, float(dcn.MAX_REACH))
    again = dcn._dx_cuda(off, m, dcols, float(dcn.MAX_REACH))
    want = in_f64(dcn.dcn_dx_reference, off, m, dcols, float(dcn.MAX_REACH))[0]
    torch.cuda.synchronize()
    assert dcn.LAUNCHES["dcn_bwd_dx"] - before == 2
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * float(want.abs().max()))
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_dcn_autograd_on_the_card_matches_the_cpu(cuda):
    """deform_conv_shift forward and every gradient, card against CPU (the
    plain versions): rtol 1e-4, atol 1e-5 x each gradient's scale."""
    grads = {}
    for dev in ("cuda", "cpu"):
        xs, w, b, off, m, g = (t.requires_grad_(i < 5)
                               for i, t in enumerate(dcn_problem(4, dev, **DCN_SHAPES[1])))
        before = dict(dcn.LAUNCHES)
        out = dcn.deform_conv_shift(xs, w, b, off, m, 2.0)
        out.backward(g)
        launched = {k: dcn.LAUNCHES[k] - before[k] for k in before}
        assert launched == dict.fromkeys(before, 1 if dev == "cuda" else 0)
        grads[dev] = [out.detach()] + [t.grad for t in (xs, w, b, off, m)]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4,
                                   atol=1e-5 * max(float(b.abs().max()), 1.0))


@pytest.mark.cuda
def test_a_cuda_tensor_never_reaches_the_plain_dcn(cuda, monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("a plain DCN version ran on the card")

    for name in ("dcn_forward_reference", "dcn_sample_backward_reference", "dcn_dx_reference"):
        monkeypatch.setattr(dcn, name, refuse)
    xs, w, b, off, m, g = (t.requires_grad_(i < 5)
                           for i, t in enumerate(dcn_problem(5, cuda, **DCN_SHAPES[0])))
    dcn.deform_conv_shift(xs, w, b, off, m, 2.0).backward(g)
    torch.cuda.synchronize()
    assert all(t.grad is not None for t in (xs, w, b, off, m))


@pytest.mark.cuda
def test_dcn_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    xs, w, b, off, m, g = dcn_problem(6, cuda, **DCN_SHAPES[0])
    with pytest.raises(TypeError):
        dcn._fwd_cuda(xs.double(), w, b, off, m, 2.0)
    with pytest.raises(TypeError):
        dcn._fwd_cuda(xs, w[:-1], b, off, m, 2.0)
    with pytest.raises(TypeError):
        dcn._fwd_cuda(xs, w, b, off[..., :-1], m, 2.0)
    with pytest.raises(ValueError):
        dcn._fwd_cuda(xs, w, b, off, m.cpu(), 2.0)
    with pytest.raises(ValueError):
        dcn._fwd_cuda(xs.transpose(1, 2).contiguous().transpose(1, 2), w, b, off, m, 2.0)
    with pytest.raises(ValueError, match="max_offset"):
        dcn._fwd_cuda(xs, w, b, off, m, dcn.MAX_REACH + 1.0)
    with pytest.raises(ValueError, match="max_offset"):
        dcn._dx_cuda(off, m, torch.zeros(2, 7, 9, 45, device=cuda), -1.0)
    with pytest.raises(TypeError):
        dcn._sample_cuda(xs, off, m, torch.zeros(2, 7, 9, 44, device=cuda), g, 2.0)
    with pytest.raises(TypeError):
        dcn._sample_cuda(xs, off, m, torch.zeros(2, 7, 9, 45, device=cuda),
                         g[:, :, :-1].contiguous(), 2.0)
    with pytest.raises(TypeError):
        dcn._dx_cuda(off, m, torch.zeros(2, 7, 9, 44, device=cuda), 2.0)


@pytest.mark.cuda
@pytest.mark.parametrize("P,na,nt,H", [(17, 8, 16, 16), (120, 24, 24, 64), (3, 5, 40, 32),
                                       (2, 112, 112, 64)])
def test_gat0_kernels_match_plain_versions_and_gat1(cuda, P, na, nt, H):
    """Kernel #8 (gat0_scores_fwd / _bwd) against its plain versions
    (forward rtol and atol 1e-5, backward rtol 1e-4 with atol 1e-5 x each
    output's scale), bitwise the same on a second launch, and bitwise equal
    to #9's gat1_* on the same inputs: its scores, and its backward with
    zero statistic cotangents.  na = nt = 112, a width the first design
    refused, is held against the plain versions in f64."""
    pr = gat1_problem(P + 7, P, na, nt, H, 1.0, cuda)
    ha, hn, a, m = pr["scores"]
    ge = pr["scores_cot"][0]
    zeros = (torch.zeros_like(pr["scores_cot"][1]), torch.zeros_like(pr["scores_cot"][2]))
    before = dict(gat.LAUNCHES)
    e, e2 = gat._gat0_scores_fwd_cuda(ha, hn, a, m, 0.2), gat._gat0_scores_fwd_cuda(ha, hn, a, m,
                                                                                    0.2)
    g, g2 = (gat._gat0_scores_bwd_cuda(ha, hn, a, m, 0.2, ge) for _ in range(2))
    e1 = gat._gat1_scores_fwd_cuda(ha, hn, a, m, 0.2)[0]
    g1 = gat._gat1_scores_bwd_cuda(ha, hn, a, m, 0.2, ge, *zeros)
    torch.cuda.synchronize()
    torch.testing.assert_close(e, plain_for(gat.gat_scores_reference, na, nt)(ha, hn, a, m, 0.2),
                               rtol=1e-5, atol=1e-5)
    assert_close_scaled(g, plain_for(gat.gat_scores_backward_reference, na, nt)(
        ha, hn, a, m, 0.2, ge), ["dha", "dhn", "da"])
    assert torch.equal(e, e2) and all(torch.equal(x, y) for x, y in zip(g, g2))
    assert torch.equal(e, e1) and all(torch.equal(x, y) for x, y in zip(g, g1))
    assert torch.all(e[m == 0] == 0)
    assert {k: gat.LAUNCHES[k] - before[k] for k in GAT0_KERNELS} == {
        "gat0_scores_fwd": 2, "gat0_scores_bwd": 2}


@pytest.mark.cuda
def test_gat0_autograd_launches_its_kernels(cuda):
    """gat_scores through autograd: one launch of each #8 kernel and no
    other attention kernel on the card, none on the CPU, and the CPU's
    gradients."""
    pr = gat1_problem(8, 6, 8, 8, 16, 1.0, "cpu")
    grads = {}
    for dev in ("cpu", cuda):
        ha, hn, a, m = (t.detach().to(dev) for t in pr["scores"])
        leaves = [t.requires_grad_(True) for t in (ha, hn, a)]
        before = dict(gat.LAUNCHES)
        (gat.gat_scores(ha, hn, a, m, 0.2) ** 2).sum().backward()
        launched = {k: gat.LAUNCHES[k] - before[k] for k in before}
        assert launched == {k: int(dev != "cpu" and k in GAT0_KERNELS) for k in launched}
        grads[str(dev)] = [t.grad.cpu() for t in leaves]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * max(float(b.abs().max()), 1.0))


@pytest.mark.cuda
def test_batch_tracker_on_the_card_matches_the_cpu(cuda):
    """BatchedTracker on the card against the CPU on small sequences:
    identical tracks, one fused_edge_gru and signed_segment_sum launch a
    forward for the whole cohort, no gather_diff."""
    from torch_port_util import spread_weights
    from trackmpnn_tpu_torch.data.synthetic import make_sequence
    from trackmpnn_tpu_torch.decode import BatchedTracker, TrackerConfig
    from trackmpnn_tpu_torch.models import mpnn, weights

    cfg = mpnn.ModelConfig(features="2d", nhidden=16)
    params, stats = weights.from_jax_params(*spread_weights(cfg, seed=5), cfg)
    seqs = []
    for seed in (31, 32, 33):
        X, bp, _ = make_sequence(num_tracks=6, num_frames=12, seed=seed)
        seqs.append((X, bp[:, :2].astype(np.int64)))
    tcfg = TrackerConfig(cur_win_size=4, hungarian=True)
    want = BatchedTracker(params, stats, cfg, tcfg, device="cpu").run(seqs)
    before = dict(mp.LAUNCHES)
    tracker = BatchedTracker(params, stats, cfg, tcfg, device=cuda)
    got = tracker.run(seqs, pipeline=True)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert {k: mp.LAUNCHES[k] - before[k] for k in before} == {
        "gather_diff": 0, "signed_segment_sum": tracker.n_forwards,
        "fused_edge_gru": tracker.n_forwards, "gather_concat": 0, "segment_sum_halves": 0}


@pytest.mark.cuda
def test_train_cli_epoch_on_the_card(cuda, tmp_path):
    """One short epoch of the training CLI on the card at --feats 2d: finite
    losses, validation, a best checkpoint, and the batch-1 step's kernels
    (gather_diff and signed_segment_sum) launched."""
    from trackmpnn_tpu_torch.cli import train
    from trackmpnn_tpu_torch.data.synthetic import write_kitti_tree

    root = str(tmp_path / "kitti")
    write_kitti_tree(root, num_seqs=21, num_frames=6, num_tracks=4, seed=0)
    before = dict(mp.LAUNCHES)
    hist = train.main(["--dataset-root-path", root, "--output-dir", str(tmp_path / "out"),
                       "--category", "All", "--detections", "rrc", "--feats", "2d",
                       "--cur-win-size", "4", "--epochs", "1", "--num-hidden-feats", "16"])
    launched = {k: mp.LAUNCHES[k] - before[k] for k in before}
    assert np.isfinite(hist["loss"][0]) and hist["steps"][0] > 0
    assert launched["gather_diff"] > 0 and launched["fused_edge_gru"] == hist["val_forwards"][0]
    assert (tmp_path / "out" / "track-mpnn_best.npz").exists()
