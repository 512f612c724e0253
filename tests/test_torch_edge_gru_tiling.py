"""The arithmetic of the port's edge GRU kernel (kernel #3, fused_edge_gru in
trackmpnn_tpu_torch/csrc/mp_kernels.cu), on the CPU.

The kernel runs both products on the tensor cores in split TF32 (3xTF32,
tests/torch_port_util.py::mm_3xtf32) with its own grouping: per k step of
8, every product goes to a fresh sum that is added to its accumulator in
f32; the r and z columns take ns x w_ih and h x w_hh of a k step into one
accumulator (a K = 2H product of [ns | h] against [w_ih; w_hh]), ns first;
gi_n and gh_n keep their own; b_ih + b_hh of r and z are added as one.
Here that arithmetic is emulated in PyTorch and held against the JAX
package's edge_gru_reference and the Pallas kernel in interpret mode at
the kernel's tolerance, atol 1e-5; plain TF32 products miss it by more
than ten times.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_edge_gru import gru_inputs
from torch_port_util import mm_3xtf32, mm_tf32
from trackmpnn_tpu.ops import pallas_mp
from trackmpnn_tpu_torch.ops import mp

torch.set_num_threads(1)

ATOL = 1e-5
K_STEP = 8  # the mma's k


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


def edge_gru_tiled(mm, h, past, fut, edge_mask, w_ih, w_hh, b_ih, b_hh):
    """edge_gru_reference's function as the kernel groups it, each product of
    one k step taken by mm."""
    H = h.shape[1]
    ns = mp.gather_diff_reference(h, past, fut, edge_mask)
    acc = [torch.zeros_like(h) for _ in range(4)]  # r, z, gi_n, gh_n
    for k in range(0, H, K_STEP):
        a_ns, a_h = ns[:, k:k + K_STEP], h[:, k:k + K_STEP]
        wi, wh = w_ih[k:k + K_STEP], w_hh[k:k + K_STEP]
        for q in range(3):  # the ns mmas of the step, then the h mmas
            acc[q] = acc[q] + mm(a_ns, wi[:, q * H:(q + 1) * H])
        for q, into in ((0, 0), (1, 1), (2, 3)):
            acc[into] = acc[into] + mm(a_h, wh[:, q * H:(q + 1) * H])
    r = torch.sigmoid(acc[0] + (b_ih[:H] + b_hh[:H]))
    z = torch.sigmoid(acc[1] + (b_ih[H:2 * H] + b_hh[H:2 * H]))
    n = torch.tanh((acc[2] + b_ih[2 * H:]) + r * (acc[3] + b_hh[2 * H:]))
    return (1.0 - z) * n + z * h


@pytest.mark.parametrize("H", [16, 64, 128])
def test_3xtf32_tiles_meet_the_kernels_bound(H):
    """N 512 (the Pallas tile), about half the rows edges: the kernel's
    arithmetic within atol 1e-5 of the JAX reference and of the Pallas kernel
    in interpret mode; plain TF32 products more than ten times outside."""
    args = gru_inputs(100 + H, H=H)
    t = [torch.from_numpy(a) for a in args]
    jargs = list(map(jnp.asarray, args))
    want_ref = torch.from_numpy(np.array(pallas_mp.edge_gru_reference(*jargs)))
    want_kernel = torch.from_numpy(np.array(pallas_mp.fused_edge_gru(*jargs, interpret=True)))
    got = edge_gru_tiled(mm_3xtf32, *t)
    for want in (want_ref, want_kernel):
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    assert float((edge_gru_tiled(mm_tf32, *t) - want_ref).abs().max()) > 10 * ATOL


@pytest.mark.parametrize("H", [4, 12])
def test_widths_below_a_k_step_pad_with_zeros(H):
    """H % 8 == 4: the last k step holds four columns (the kernel pads the
    other four with zeros); still within atol 1e-5 of the plain version."""
    t = [torch.from_numpy(a) for a in gru_inputs(H, N=64, H=H)]
    torch.testing.assert_close(edge_gru_tiled(mm_3xtf32, *t), mp.edge_gru_reference(*t),
                               rtol=0, atol=ATOL)
