"""Kernel #3, fused_edge_gru (gather-diff + the edge GRU in one launch,
trackmpnn_tpu/ops/pallas_mp.py:84), against the JAX package: the port's
plain version (what a CPU tensor gets) against JAX's edge_gru_reference
and against the Pallas kernel in interpret mode, on numpy-seeded inputs
(N 512, the Pallas tile; H 16 and 64; about half the rows edges).
Tolerance atol 1e-5: each gate sums H f32 products in another order
before sigmoid / tanh, on O(1) values.

The model's served forward (no gradient recorded) takes the kernel in
place of gather_diff + gru_cell; both routes compute the same function
(within 1e-6: the same products, summed by one matmul or two), and the
wrapper refuses where autograd would need its gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import spread_weights, window_graph
from trackmpnn_tpu.ops import pallas_mp
from trackmpnn_tpu_torch.graph import view as tview
from trackmpnn_tpu_torch.models import mpnn, weights
from trackmpnn_tpu_torch.ops import mp

torch.set_num_threads(1)

ATOL = 1e-5


def gru_inputs(seed, N=512, H=16):
    """h [N, H], past/fut int32 [N], edge_mask bool [N], w_ih/w_hh [H, 3H],
    b_ih/b_hh [3H] (numpy), with weights large enough that the gates are
    not all near 0.5."""
    rng = np.random.default_rng(seed)
    f32 = lambda *shape, s=1.0: (s * rng.normal(size=shape)).astype(np.float32)
    past = rng.integers(0, N, N).astype(np.int32)
    fut = rng.integers(0, N, N).astype(np.int32)
    em = rng.random(N) < 0.5
    return (f32(N, H), past, fut, em, f32(H, 3 * H, s=H ** -0.5), f32(H, 3 * H, s=H ** -0.5),
            f32(3 * H, s=0.3), f32(3 * H, s=0.3))


@pytest.mark.parametrize("H", [16, 64])
def test_plain_version_matches_jax_reference_and_interpret_kernel(H):
    args = gru_inputs(H, H=H)
    got = mp.fused_edge_gru(*map(torch.from_numpy, args)).numpy()
    jargs = list(map(jnp.asarray, args))
    want_ref = np.asarray(pallas_mp.edge_gru_reference(*jargs))
    want_kernel = np.asarray(pallas_mp.fused_edge_gru(*jargs, interpret=True))
    np.testing.assert_allclose(got, want_ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, want_kernel, rtol=0, atol=ATOL)
    # the edge rows' gathers matter: without them the rows would differ
    no_edges = mp.fused_edge_gru(*map(torch.from_numpy, args[:3]),
                                 torch.zeros(512, dtype=torch.bool),
                                 *map(torch.from_numpy, args[4:])).numpy()
    assert np.abs(no_edges - got)[args[3]].max() > 1e-2
    np.testing.assert_array_equal(no_edges[~args[3]], got[~args[3]])


def test_refuses_where_a_gradient_is_needed():
    args = [torch.from_numpy(a) for a in gru_inputs(1)]
    for i in (0, 4, 5, 6, 7):  # h and the four weights
        a = list(args)
        a[i] = a[i].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            mp.fused_edge_gru(*a)
        with torch.no_grad():
            torch.testing.assert_close(mp.fused_edge_gru(*a), mp.fused_edge_gru(*args),
                                       rtol=0, atol=0)


@pytest.mark.parametrize("features,heads", [("2d", 0), ("2d+temp+vis", 0), ("2d", 1)])
def test_model_routes_agree(monkeypatch, features, heads):
    """mpnn.forward under torch.inference_mode (one fused_edge_gru a branch,
    no gather_diff) against the same forward with grad enabled (gather_diff
    + gru_cell), eval mode: hidden, logits and scores within 1e-6."""
    cfg = mpnn.ModelConfig(features=features, ncategories=3, nhidden=16, nattheads=heads,
                           num_vis_feats=8)
    g, X, n_new = window_graph(seed=7)
    extra = cfg.nfeatures - X.shape[1]
    X = np.concatenate([X, np.random.default_rng(7).normal(size=(X.shape[0], extra))],
                       1).astype(np.float32)
    tv = tview.make_view(g, X, n_new, 512, "cpu")
    p, s = weights.from_jax_params(*spread_weights(cfg, 7), cfg)
    h_prev = torch.from_numpy(np.random.default_rng(8).normal(
        size=(512, len(cfg.branches) * 16)).astype(np.float32))
    calls = {"fused_edge_gru": 0, "gather_diff": 0}

    def spy(name):
        fn = getattr(mp, name)

        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    for name in calls:
        monkeypatch.setattr(mp, name, spy(name))
    want, _ = mpnn.forward(p, s, cfg, tv, h_prev, train=False)
    assert calls == {"fused_edge_gru": 0, "gather_diff": len(cfg.branches)}
    with torch.inference_mode():
        got, _ = mpnn.forward(p, s, cfg, tv, h_prev, train=False)
    assert calls == {"fused_edge_gru": len(cfg.branches), "gather_diff": len(cfg.branches)}
    for a, b in ((got.hidden, want.hidden), (got.logits, want.logits),
                 (got.scores, want.scores)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
