"""The port's host-side training packing (graph/schedule.py and the host
half of train/block.py) against the JAX package's, on the same synthetic
chunks: every field equal, including the per-step block descriptors."""

import numpy as np
import pytest
import torch

from torch_port_util import training_chunks
from trackmpnn_tpu.graph import schedule as jschedule
from trackmpnn_tpu.train import block as jblock
from trackmpnn_tpu_torch.graph import schedule
from trackmpnn_tpu_torch.train import block

torch.set_num_threads(1)

CAP, TCAP = 256, 10
FIELDS = ["is_det", "past", "fut", "label", "feat", "n_before", "n_after", "step_valid"]


def both_schedules(n, seed0, **kw):
    chunks = training_chunks(n, seed0)
    return ([jschedule.build_window_schedule(X, y, **kw) for X, y in chunks],
            [schedule.build_window_schedule(X, y, **kw) for X, y in chunks])


@pytest.mark.parametrize("kw", [{}, {"cap": CAP, "t_cap": TCAP}, {"t_st": 1, "bucket": 64}])
def test_window_schedules_equal_jax(kw):
    want, got = both_schedules(4, 0, **kw)
    for w, g in zip(want, got):
        assert (w is None) == (g is None)
        if w is None:
            continue
        for f in FIELDS:
            a, b = np.asarray(getattr(w, f)), getattr(g, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        assert (w.n_rows, w.n_steps, w.n_edges) == (g.n_rows, g.n_steps, g.n_edges)
        assert len(w.blocks) == len(g.blocks)
        for bw, bg in zip(w.blocks, g.blocks):
            assert (bw is None) == (bg is None)
            if bw is not None:
                assert (bw.edge_base, bw.na, bw.nt, bw.det_base) == \
                    (bg.edge_base, bg.na, bg.nt, bg.det_base)
                assert np.array_equal(bw.active_rows, bg.active_rows)


def test_capacity_errors_match_jax():
    X, y = training_chunks(1)[0]
    for fn in (jschedule.build_window_schedule, schedule.build_window_schedule):
        with pytest.raises(ValueError, match="capacity"):
            fn(X, y, cap=4)
        with pytest.raises(ValueError, match="t_cap"):
            fn(X, y, t_cap=1)


@pytest.mark.parametrize("caps", [{}, {"capD": 128, "na_cap": 16, "nt_cap": 16}])
def test_block_batch_equals_jax(caps):
    want, got = both_schedules(3, 20, cap=CAP, t_cap=TCAP)
    assert block.block_dims(got) == jblock.block_dims(want)
    jb = jblock.build_block_batch(want, TCAP, **caps)
    tb = block.build_block_batch(got, TCAP, device="cpu", **caps)
    for f in jb._fields:
        a, b = np.asarray(getattr(jb, f)), getattr(tb, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (tb.t_cap, tb.n_windows, tb.capD, tb.na_cap, tb.nt_cap) == \
        (jb.t_cap, jb.n_windows, jb.capD, jb.na_cap, jb.nt_cap)


def test_block_batch_refuses_small_caps():
    _, got = both_schedules(2, 0, cap=CAP, t_cap=TCAP)
    with pytest.raises(ValueError, match="capD"):
        block.build_block_batch(got, TCAP, capD=4, device="cpu")
    with pytest.raises(ValueError, match="na_cap"):
        block.build_block_batch(got, TCAP, na_cap=1, nt_cap=1, device="cpu")
