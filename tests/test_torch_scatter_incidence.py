"""The destination-sorted incidences that the two scatter kernels pull
over (ops/mp.py::segment_incidence for signed_segment_sum, ops/block.py::
block_incidence and window_incidence for window_scatter), their plain pull
versions against the JAX package's Pallas kernels in interpret mode, and the
contracts the callers keep: every row that a round masks in is listed, and
the values the block step scatters are exactly 0 where the batch's
incidence lists nothing.  On the CPU the wrappers run today's plain
versions; tests/test_torch_cuda.py holds the kernels to these on the card.

Tolerances: the pull sums in f64 and rounds once, the Pallas kernels sum in
f32 in another order: atol 1e-5 against them (inputs O(1), a few dozen
terms a row), as tests/test_torch_mp_ops.py and test_torch_block_ops.py
hold the plain versions.  The pull against the port's own f64 plain
versions: atol 1e-6 (both f64, rounded once).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import training_chunks, window_graph
from trackmpnn_tpu.ops import pallas_block, pallas_mp
from trackmpnn_tpu_torch.graph import schedule
from trackmpnn_tpu_torch.graph.view import make_view
from trackmpnn_tpu_torch.models import mpnn
from trackmpnn_tpu_torch.ops import block, mp
from trackmpnn_tpu_torch.train import block as train_block
from trackmpnn_tpu_torch.train import optim, step

torch.set_num_threads(1)

CAP, TCAP, HIDDEN = 256, 10, 8


def graph_problem(seed, nd=12, ne=40, cap=64, h=8):
    """A padded slot layout as pack_slots writes it: nd detection rows and
    ne edge rows between them, interleaved, then self-pointing padding;
    a random mask over the edges."""
    rng = np.random.default_rng(seed)
    n = nd + ne
    is_det = np.zeros(cap, bool)
    is_det[rng.choice(n, nd, replace=False)] = True
    dets = np.where(is_det)[0]
    past = np.arange(cap, dtype=np.int32)
    fut = past.copy()
    edges = np.where(~is_det[:n])[0]
    past[edges] = rng.choice(dets, len(edges))
    fut[edges] = rng.choice(dets, len(edges))
    live = np.arange(cap) < n
    mask = live & ~is_det & (rng.random(cap) < 0.7)
    hid = rng.normal(size=(cap, h)).astype(np.float32)
    return hid, past, fut, is_det, mask


def segment_oracle(past, fut, n):
    """numpy: per destination, the +1 entries (k = row) by row, then the -1
    entries (k = N + row) by row, of every row not pointing at itself."""
    N = len(past)
    rows = np.arange(N)
    listed = (past != rows) | (fut != rows)
    lists = [[] for _ in range(n)]
    for off, ends in ((0, past), (N, fut)):
        for e in np.where(listed)[0]:
            if 0 <= ends[e] < n:
                lists[ends[e]].append(off + e)
    ptr = np.concatenate([[0], np.cumsum([len(x) for x in lists])])
    return ptr, np.array([v for x in lists for v in x], np.int64)


@pytest.mark.parametrize("layout", ["view", "random"])
def test_segment_incidence_matches_a_numpy_oracle(layout):
    """A view's slot layout (detections and padding point at themselves) and
    random endpoints (some rows self-pointing by chance); an endpoint
    outside the rows, beyond them or negative, is not listed (the kernel
    traps on it)."""
    hid, past, fut, is_det, mask = graph_problem(0)
    cap = len(past)
    if layout == "random":
        rng = np.random.default_rng(1)
        past, fut = (rng.integers(0, cap, cap).astype(np.int32) for _ in range(2))
        past[::7] = fut[::7] = np.arange(cap, dtype=np.int32)[::7]
    bad, bad_neg = (int(e) for e in np.where(~is_det)[0][:2])  # two edge rows
    fut[bad] = cap + 3
    past[bad_neg] = -2
    ptr, ent = mp.segment_incidence(torch.from_numpy(past), torch.from_numpy(fut), cap)
    want_ptr, want_ent = segment_oracle(past, fut, cap)
    assert ptr.dtype == ent.dtype == torch.int32 and ent.shape == (2 * cap,)
    np.testing.assert_array_equal(ptr.numpy(), want_ptr)
    np.testing.assert_array_equal(ent[:int(ptr[-1])].numpy(), want_ent)
    if layout == "view":
        # every edge row, the rows that can be masked in, is listed at both
        # of its endpoints; no detection or padding row is
        got = set(ent[:int(ptr[-1])].tolist())
        rows = np.arange(cap)
        for e in rows[(rows != bad) & (rows != bad_neg)]:
            edge = not is_det[e] and e < 52
            assert ({e, cap + e} <= got) == edge and (edge or not {e, cap + e} & got)
        assert bad in got and cap + bad not in got
        assert bad_neg not in got and cap + bad_neg in got


def test_window_incidence_matches_a_numpy_oracle_and_holds_the_batch_incidence():
    _, bb = batches()
    P, B, capD = bb.active_idx.shape[0], bb.n_windows, bb.capD
    perm = torch.arange(P).reshape(B, -1).t().reshape(-1)
    act, new = bb.active_idx[perm], bb.newdet_idx[perm]
    ids = torch.cat([act % capD, new % capD], 1).to(torch.int32)
    ptr, slot = block.window_incidence(ids, B, capD)
    dest = ((np.arange(P) % B) * capD)[:, None] + ids.numpy()
    order = np.argsort(dest.reshape(-1), kind="stable")
    np.testing.assert_array_equal(slot.numpy(), order)
    np.testing.assert_array_equal(ptr.numpy(), np.searchsorted(dest.reshape(-1)[order],
                                                               np.arange(B * capD + 1)))
    # the batch's incidence is each detection's full list without the
    # positions of padded rows, padded columns and blocks without cells
    bptr, bslot = bb.det_inc_ptr.numpy(), bb.det_inc_slot.numpy()
    for d in range(B * capD):
        full = slot.numpy()[ptr[d]:ptr[d + 1]]
        sub = bslot[bptr[d]:bptr[d + 1]]
        assert np.all(np.diff(sub) > 0) and set(sub) <= set(full)


@pytest.mark.parametrize("seed,cap,h", [(1, 64, 8), (2, 256, 32)])
def test_signed_pull_reference_matches_pallas(seed, cap, h):
    hid, past, fut, is_det, mask = graph_problem(seed, nd=cap // 6, ne=cap // 2, cap=cap, h=h)
    want = pallas_mp.signed_segment_sum_pallas(*map(jnp.asarray, (hid, past, fut, mask)), cap,
                                               interpret=True, tile=64)
    t = [torch.from_numpy(a) for a in (hid, past, fut, is_det, mask)]
    inc = mp.segment_incidence(t[1], t[2], cap)
    got = mp.signed_segment_sum_pull_reference(t[0], t[4], inc, cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    torch.testing.assert_close(got, mp.signed_segment_sum_reference(t[0], t[1], t[2], t[4], cap),
                               rtol=0, atol=1e-6)


def scatter_case(seed, B=2, capD=8, P=6, na=4, nt=5, F=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(P, na, F)).astype(np.float32),
            rng.normal(size=(P, nt, F)).astype(np.float32),
            rng.integers(0, capD, (P, na)).astype(np.int32),
            rng.integers(0, capD, (P, nt)).astype(np.int32), B, capD)


def test_window_pull_reference_matches_pallas_scatter_and_gather2_vjp():
    """The full incidence's pull: the es form (one source of n = na + nt
    columns) against pallas_block.window_scatter, the two-output form
    against the VJP of pallas_block.window_gather2 with two operands."""
    va, vb, act, new, B, capD = scatter_case(3)
    vals, idx = np.concatenate([va, vb], 1), np.concatenate([act, new], 1)
    want = pallas_block.window_scatter(jnp.asarray(vals), jnp.asarray(idx, jnp.float32), B,
                                       capD, 4, True)
    t_vals, t_idx = torch.from_numpy(vals), torch.from_numpy(idx)
    inc = block.window_incidence(t_idx, B, capD)
    rows, cols = block.incidence_sum_reference(t_vals, t_vals[:, :0], *inc, B * capD)
    np.testing.assert_allclose(rows.float().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert torch.all(cols == 0)
    torch.testing.assert_close(rows.float(), block.window_scatter_reference(t_vals, t_idx, B, capD),
                               rtol=0, atol=1e-6)
    gd = np.zeros((B * capD, va.shape[2]), np.float32)
    f = lambda a, b: pallas_block.window_gather2(a, b, jnp.asarray(act, jnp.float32),
                                                 jnp.asarray(new, jnp.float32), B, capD, 4, True)
    _, pull = jax.vjp(f, jnp.asarray(gd), jnp.asarray(gd))
    wa, wb = pull((jnp.asarray(va), jnp.asarray(vb)))
    ga, gb = block.incidence_sum_reference(torch.from_numpy(va), torch.from_numpy(vb), *inc,
                                           B * capD)
    np.testing.assert_allclose(ga.float().numpy(), np.asarray(wa), rtol=0, atol=1e-5)
    np.testing.assert_allclose(gb.float().numpy(), np.asarray(wb), rtol=0, atol=1e-5)


def batches(n=3, heads=0):
    chunks = training_chunks(n, 0)
    scheds = [schedule.build_window_schedule(X, y, cap=CAP, t_cap=TCAP) for X, y in chunks]
    return scheds, train_block.build_block_batch(scheds, TCAP, device="cpu")


def listed_positions(bb, P, W):
    """bool [P, W]: the slots q*W + r (q < P) that the batch's incidence lists."""
    slot = bb.det_inc_slot.long()
    slot = slot[slot < P * W]
    out = torch.zeros(P * W, dtype=torch.bool)
    out[slot] = True
    return out.reshape(P, W)


@pytest.mark.parametrize("heads,gat_fused", [(0, True), (2, True), (2, False)],
                         ids=["default", "stacked heads", "per-head"])
def test_block_step_scatters_zeros_outside_the_batch_incidence(monkeypatch, heads, gat_fused):
    """One real small BlockBatch step: every window_scatter and every
    window_gather2 backward gets values that are exactly 0 at the positions
    the batch's incidence does not list, so the kernels' pull over that
    incidence equals window_scatter_reference (to f64 rounding)."""
    _, bb = batches()
    cfg = mpnn.ModelConfig(features="2d", ncategories=3, nhidden=HIDDEN, nattheads=heads)
    params = train_block.trainable(mpnn.init_params(torch.Generator().manual_seed(0), cfg))
    stats = mpnn.init_batch_stats(cfg)
    B, capD, na, nt = bb.n_windows, bb.capD, bb.na_cap, bb.nt_cap
    inc = (bb.det_inc_ptr, bb.det_inc_slot)
    seen = {"scatter": 0, "gather2": 0, "largest": 0.0}
    scatter, gather2 = block.window_scatter_raw, block.window_gather2_backward_raw

    def check(vals, got_inc):
        assert got_inc is not None and all(a is b for a, b in zip(got_inc, inc))
        live = listed_positions(bb, vals.shape[0], na + nt)
        assert torch.all(vals[~live] == 0)
        seen["largest"] = max(seen["largest"], float(vals[live].abs().max()))

    def rec_scatter(vals, idx_l, B_, capD_, inc_=None):
        check(vals, inc_)
        rows, _ = block.incidence_sum_reference(vals, vals[:, :0], *inc_, B * capD)
        want = scatter(vals, idx_l, B_, capD_)
        torch.testing.assert_close(rows.float(), want, rtol=0, atol=1e-6)
        seen["scatter"] += 1
        return want

    def rec_gather2(dga, dgb, act_l, new_l, B_, capD_, inc_=None):
        check(torch.cat([dga, dgb], 1), inc_)
        rows, cols = block.incidence_sum_reference(dga, dgb, *inc_, B * capD)
        want = gather2(dga, dgb, act_l, new_l, B_, capD_)
        torch.testing.assert_close(rows.float(), want[0], rtol=0, atol=1e-6)
        torch.testing.assert_close(cols.float(), want[1], rtol=0, atol=1e-6)
        seen["gather2"] += 1
        return want

    monkeypatch.setattr(block, "window_scatter_raw", rec_scatter)
    monkeypatch.setattr(block, "window_gather2_backward_raw", rec_gather2)
    keep = None
    if heads:
        gen = torch.Generator().manual_seed(1)
        keep = [train_block.draw_att_keep(gen, heads, ((s + 1) * B, na, nt), "cpu")
                for s in range(bb.t_cap)]
    loss, _ = train_block.block_window_forward(params, stats, cfg, bb, False, att_keep=keep,
                                               gat_fused=gat_fused)
    loss.backward()
    # a round: the es sum (one a head on the per-head route) and the gate
    # gather's backward, plus one for the heads' projections (one a head)
    scatters, gathers = (heads, 1 + heads) if not gat_fused else (1, 2 if heads else 1)
    assert (seen["scatter"], seen["gather2"]) == (scatters * bb.t_cap, gathers * bb.t_cap)
    assert seen["largest"] > 0.0


def record_segment_sums(monkeypatch, want_inc=None):
    """Record every signed_segment_sum_raw call; check that each masked-in
    row is listed in the incidence it gets and that the pull over that
    incidence equals the plain version."""
    calls = []
    orig = mp.signed_segment_sum_raw

    def rec(h, past, fut, edge_mask, n, inc=None):
        assert inc is not None
        if want_inc is not None:
            assert all(a is b for a, b in zip(inc, want_inc))
        ptr, ent = inc
        listed = torch.zeros(2 * h.shape[0], dtype=torch.bool)
        listed[ent[:int(ptr[-1])].long()] = True
        assert torch.all(listed.reshape(2, -1)[:, edge_mask.bool()])  # both ends of each row
        want = orig(h, past, fut, edge_mask, n, inc)
        torch.testing.assert_close(mp.signed_segment_sum_pull_reference(h, edge_mask, inc, n),
                                   want, rtol=0, atol=1e-6)
        calls.append(int(edge_mask.sum()))
        return want

    monkeypatch.setattr(mp, "signed_segment_sum_raw", rec)
    return calls


def test_batch1_step_pulls_every_round_over_the_step_batch_incidence(monkeypatch):
    """The batch-1 step: one incidence a step batch (built when it is moved
    to the card; a CPU batch builds none), handed to every round's forward
    and to gather_diff's backward while `live` grows; every masked-in row is
    listed."""
    (X, y), = training_chunks(1, 4)
    ws = schedule.build_window_schedule(X, y, cap=CAP, t_cap=TCAP)
    builds = dict(mp.BUILDS)
    assert step.schedule_to_device(ws, "cpu").inc is None  # the plain version reads none
    assert mp.BUILDS == builds
    # build it on the CPU too, to follow where the card's incidence goes
    monkeypatch.setattr(mp, "kernel_incidence", mp.segment_incidence)
    sb = step.schedule_to_device(ws, "cpu")
    assert mp.BUILDS["segment_incidence"] == builds["segment_incidence"] + 1
    calls = record_segment_sums(monkeypatch, sb.inc)
    cfg = mpnn.ModelConfig(features="2d", ncategories=3, nhidden=HIDDEN)
    params = train_block.trainable(mpnn.init_params(torch.Generator().manual_seed(0), cfg))
    opt = optim.make_optimizer(train_block.param_leaves(params), 1e-4, 5e-4)
    before = (dict(mp.BUILDS), dict(mp.LAUNCHES))
    step.make_train_step(cfg, False)(params, mpnn.init_batch_stats(cfg), opt, sb)
    assert (dict(mp.BUILDS), dict(mp.LAUNCHES)) == before  # the CPU builds and launches none
    valid = int(np.sum(ws.step_valid))
    assert len(calls) == 2 * valid and len(set(calls)) > 1  # forward and backward; live grows


def test_served_forward_pulls_over_the_view_incidence(monkeypatch):
    """make_view builds the incidence once where the kernel reads it (a CPU
    view builds none); a served forward with two branches hands it to both
    branches' scatters."""
    g, X, n_new = window_graph(steps=3)
    cfg = mpnn.ModelConfig(features="2d+temp", ncategories=3, nhidden=HIDDEN)
    X = np.concatenate([X, X[:, :cfg.branches[1][1]]], 1)
    builds = mp.BUILDS["segment_incidence"]
    assert make_view(g, X, n_new, 512, "cpu").inc is None
    assert mp.BUILDS["segment_incidence"] == builds
    monkeypatch.setattr(mp, "kernel_incidence", mp.segment_incidence)
    view = make_view(g, X, n_new, 512, "cpu")
    assert mp.BUILDS["segment_incidence"] == builds + 1
    calls = record_segment_sums(monkeypatch, view.inc)
    params = mpnn.init_params(torch.Generator().manual_seed(0), cfg)
    with torch.no_grad():
        mpnn.forward(params, mpnn.init_batch_stats(cfg), cfg, view, None)
    assert len(calls) == 2 and calls[0] > 0
    assert mp.BUILDS["segment_incidence"] == builds + 1
