"""Kernel #8's op, ops/gat.py::gat_scores (its plain forward and backward,
which a CPU tensor runs), against the JAX package's gat_scores in
interpret mode (as tests/test_pallas_gat.py runs it) and its plain oracle
reference_gat_scores, on the same numpy-seeded inputs.  Tolerances: the
forward within atol and rtol 1e-5 (an H-term f32 sum in another order);
gradients rtol 1e-4, atol 1e-5 x each gradient's largest magnitude."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackmpnn_tpu.ops import pallas_gat as pg
from trackmpnn_tpu_torch.ops import gat

torch.set_num_threads(1)

ALPHA = 0.2


def inputs(seed, P, na, nt, H):
    """ha, hn, a, mask3 and a cotangent; one block's rows all masked, and
    ties (hn rows equal to ha rows: sign(0) = 0 in the backward)."""
    rng = np.random.default_rng(seed)
    ha = rng.normal(size=(P, na, H)).astype(np.float32)
    hn = rng.normal(size=(P, nt, H)).astype(np.float32)
    hn[0, 0] = ha[0, 1]
    hn[-1, nt - 1, : H // 2] = ha[-1, 0, : H // 2]
    a = rng.normal(size=(H, 1)).astype(np.float32)
    m = (rng.random((P, na, nt)) > 0.3).astype(np.float32)
    m[0, 1] = 1.0  # the tied cell is live
    m[min(1, P - 1)] = 0.0  # an all-masked block
    m[-1, :, 0] = 0.0  # an all-masked column
    ge = rng.normal(size=(P, na, nt)).astype(np.float32)
    return ha, hn, a, m, ge


@pytest.mark.parametrize("P,na,nt,H", [(3, 5, 4, 8), (6, 8, 3, 16), (2, 2, 1, 4)])
def test_forward_and_gradients_match_jax(P, na, nt, H):
    ha, hn, a, m, ge = inputs(P * 100 + H, P, na, nt, H)
    want_e = np.asarray(pg.gat_scores(ha, hn, a, m, ALPHA, 4, True))
    oracle_e = np.asarray(pg.reference_gat_scores(ha, hn, a, m, ALPHA))
    grads = jax.grad(lambda x, y, z: jnp.sum(pg.gat_scores(x, y, z, jnp.asarray(m), ALPHA, 4, True)
                                             * ge), (0, 1, 2))(ha, hn, a)

    t = [torch.tensor(x, requires_grad=True) for x in (ha, hn, a)]
    e = gat.gat_scores(*t, torch.tensor(m), ALPHA)
    (e * torch.tensor(ge)).sum().backward()
    np.testing.assert_allclose(e.detach().numpy(), want_e, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(e.detach().numpy(), oracle_e, rtol=1e-5, atol=1e-5)
    assert np.all(e.detach().numpy()[m == 0] == 0.0)
    for got, want in zip(t, grads):
        want = np.asarray(want)
        np.testing.assert_allclose(got.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(want).max(), 1e-30))


def test_masked_cells_pass_no_cotangent_and_ties_give_zero():
    """A cotangent on masked cells changes no gradient; a tied unit (|d| at
    0) contributes nothing to d ha and d hn, as jnp.sign(0) = 0."""
    ha, hn, a, m, ge = inputs(7, 2, 3, 3, 4)
    t = [torch.tensor(x) for x in (ha, hn, a)]
    mt = torch.tensor(m)
    base = gat.gat_scores_backward_reference(*t, mt, ALPHA, torch.tensor(ge))
    noisy = ge + np.where(m == 0, 100.0, 0.0).astype(np.float32)
    again = gat.gat_scores_backward_reference(*t, mt, ALPHA, torch.tensor(noisy))
    for x, y in zip(base, again):
        assert torch.equal(x, y)
    one = np.zeros_like(ge)
    one[0, 1, 0] = 1.0  # only the tied cell (ha[0, 1] == hn[0, 0])
    dha, dhn, _ = gat.gat_scores_backward_reference(*t, mt, ALPHA, torch.tensor(one))
    assert torch.count_nonzero(dha) == 0 and torch.count_nonzero(dhn) == 0
    jd = jax.grad(lambda x: jnp.sum(pg.gat_scores(x, hn, a, m, ALPHA, 4, True) * one))(ha)
    np.testing.assert_array_equal(np.asarray(jd), dha.numpy())


def test_plain_version_is_the_stats_ops_first_output():
    """#8 is #9 without its statistics: the same scores, and the same
    backward as #9's with zero statistic cotangents."""
    ha, hn, a, m, ge = inputs(3, 4, 6, 5, 8)
    t = [torch.tensor(x) for x in (ha, hn, a, m)]
    assert torch.equal(gat.gat_scores_reference(*t, ALPHA),
                       gat.gat_scores_stats_1h_reference(*t, ALPHA)[0])
    g = torch.tensor(ge)
    z = (torch.zeros(4, 6), torch.zeros(4, 5))
    for x, y in zip(gat.gat_scores_backward_reference(*t, ALPHA, g),
                    gat.gat_scores_stats_1h_backward_reference(*t, ALPHA, g, *z)):
        assert torch.equal(x, y)
