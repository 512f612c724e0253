"""Shared inputs for the tests that hold trackmpnn_tpu_torch against the
JAX package: numpy-made weights in the JAX layout and real rolling-window
graphs from synthetic sequences."""

import numpy as np

from trackmpnn_tpu_torch.data.synthetic import make_sequence
from trackmpnn_tpu_torch.graph import engine
from trackmpnn_tpu_torch.models import weights


def spread_weights(cfg, seed, std=0.2):
    """JAX-layout (params, batch_stats) with numpy leaves: normal(std)
    weights, zero head biases and running stats away from (0, 1), so that
    scores spread around 0.5 and associations actually happen."""
    rng = np.random.default_rng(seed)

    def leaf(_, shape, path):
        a = (std * rng.normal(size=shape)).astype(np.float32)
        if path.startswith("out_") and path.endswith("/b"):
            a[:] = 0.0
        return a

    shapes = weights.param_shapes(cfg)
    params = weights.map_shaped(leaf, shapes, shapes)
    stat_shapes = weights.stats_shapes(cfg)
    stats = weights.map_shaped(
        lambda _, shape, path: (rng.uniform(0.5, 1.5, shape) if path.endswith("var")
                                else rng.normal(0, 0.3, shape)).astype(np.float32),
        stat_shapes, stat_shapes)
    return params, stats


def window_graph(num_tracks=6, num_frames=8, steps=3, seed=0):
    """A RollingGraph after `steps` test-mode updates with trivial scores
    (detections positive, edges negative, so nothing associates), plus the
    sequence's features and the number of rows the last update added."""
    X, bbox_pred, _ = make_sequence(num_tracks=num_tracks, num_frames=num_frames, seed=seed)
    y = bbox_pred[:, :2].astype(np.int64)
    g = engine.initialize(y, 0, "test")
    n_new = g.n
    for t in range(g.t_next, g.t_next + steps):
        p = np.where(g.ts != -1, 0.99, 0.01).astype(np.float32)
        n_new = engine.update(g, y, t, np.stack([1 - p, p], 1), "test", use_hungarian=True)
    return g, X, n_new


def training_chunks(n, seed0=0, num_tracks=4):
    """`n` synthetic training chunks (features, (ts, track_id) labels) of 5-7
    frames that seed a window, made with numpy so that both packages can
    build their schedules from the same arrays."""
    from trackmpnn_tpu_torch.graph.schedule import build_window_schedule

    out, s = [], seed0
    while len(out) < n:
        X, bp, _ = make_sequence(num_tracks=num_tracks, num_frames=5 + (s % 3), seed=s,
                                 miss_rate=0.15, fp_rate=0.2)
        y = bp[:, :2].astype(np.int64)
        if build_window_schedule(X, y) is not None:
            out.append((X, y))
        s += 1
    return out


def gat_inputs(seed, nh, keep=1.0, mask_heads=None, P=5, na=6, nt=7, H=8):
    """numpy f32 inputs and cotangents of both attention ops (ops/gat.py):
    "scores" (ha, hn, a, m3), "scores_cot" (for e, sa_l, sb_l), "agg" (e,
    m_row, m_col, z_row, z_col, h_e, m3, ka, kn), "agg_cot" (for rs, cs).
    Each block has a rectangular live part (block 0 none) and a live cell
    with ha_i == hn_j (d = 0); keep masks have `mask_heads` heads (default
    nh), or at keep 1 are the cell mask, as the train step passes them."""
    rng = np.random.default_rng(seed)
    blk_na, blk_nt = rng.integers(1, na + 1, P), rng.integers(1, nt + 1, P)
    blk_nt[0] = 0
    m = ((np.arange(na)[None, :, None] < blk_na[:, None, None])
         & (np.arange(nt)[None, None, :] < blk_nt[:, None, None]))
    ha, hn = rng.normal(size=(P, na, nh * H)), rng.normal(size=(P, nt, nh * H))
    hn[:, 0] = ha[:, 0]
    e = rng.normal(size=(nh, P, na, nt)) * m
    keep_mask = lambda: (rng.random((mask_heads or nh, P, na, nt)) < keep if keep < 1.0
                         else m[None])
    arrays = {
        "scores": [ha, hn, rng.normal(size=(nh * H, 1)) * 0.3, m],
        "scores_cot": [rng.normal(size=(nh, P, na, nt)), rng.normal(size=(nh, P, na)),
                       rng.normal(size=(nh, P, nt))],
        "agg": [e, e.max(3) + rng.uniform(0, 1, (nh, P, na)),
                e.max(2) + rng.uniform(0, 1, (nh, P, nt)), rng.uniform(1, 3, (nh, P, na)),
                rng.uniform(1, 3, (nh, P, nt)), rng.normal(size=(P, na, nt, H)) * m[..., None],
                m, keep_mask(), keep_mask()],
        "agg_cot": [rng.normal(size=(P, na, H)), rng.normal(size=(P, nt, H))],
    }
    return {k: [np.ascontiguousarray(a, np.float32) for a in v] for k, v in arrays.items()}


ROUND_KEYS = ("w_ih", "w_hh", "b_ih", "b_hh")


def round_inputs(seed, B=2, cap=64, H=64):
    """numpy inputs of the fused round (ops/round.py) as
    tests/test_pallas_round.py makes them: h f32[B, cap, H], idxw
    int32[B, cap, 4] with rows of kind 0 dead (h = 0), 1 edge, 2 detection
    and endpoints anywhere in the window, the two GRUs' weight dicts, and a
    cotangent of out."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, cap, H)).astype(np.float32) * 0.5
    past = rng.integers(0, cap, (B, cap)).astype(np.int32)
    fut = rng.integers(0, cap, (B, cap)).astype(np.int32)
    kind = rng.integers(0, 3, (B, cap))
    h[kind == 0] = 0.0
    idxw = np.stack([past, fut, (kind == 1).astype(np.int32), (kind == 2).astype(np.int32)], -1)
    shapes = [(H, 3 * H), (H, 3 * H), (3 * H,), (3 * H,)]
    we, wn = ({k: (0.2 * rng.normal(size=s)).astype(np.float32) for k, s in zip(ROUND_KEYS, shapes)}
              for _ in range(2))
    cot = rng.normal(size=h.shape).astype(np.float32)
    return h, idxw, we, wn, cot


def hub_round_inputs(seed, B=1, cap=96, H=128, hub_edges=72):
    """round_inputs with detection row 0 of window 0 incident to hub_edges
    edges (rows 1 .. hub_edges, past or fut 0 at random; a few self-loops
    through the other end), the incidence built on that idxw, then edge row 5
    dead at this step (the kernels skip a listed edge the step does not
    flag).  Returns round_inputs' five and (inc_ptr, inc_idx)."""
    from trackmpnn_tpu_torch.ops.round import round_incidence

    h, idxw, we, wn, cot = round_inputs(seed, B, cap, H)
    rng = np.random.default_rng(seed + 1)
    edges = np.arange(1, hub_edges + 1)
    idxw[0, 0, 2:] = (0, 1)
    idxw[0, edges, 2:] = (1, 0)
    side = rng.random(hub_edges) < 0.5
    idxw[0, edges, 0] = np.where(side, 0, idxw[0, edges, 0])
    idxw[0, edges, 1] = np.where(side, idxw[0, edges, 1], 0)
    h[0, :hub_edges + 1] = 0.5 * rng.normal(size=(hub_edges + 1, H))
    inc_ptr, inc_idx = round_incidence(idxw)
    idxw[0, 5, 2:] = 0
    h[0, 5] = 0.0
    return h, idxw, we, wn, cot, inc_ptr, inc_idx


def tf32(x):
    """x rounded to TF32 (10 explicit mantissa bits): to nearest, ties away
    from zero, by adding half of the dropped 13 bits on the int32 view, as
    the port's tensor-core kernels do (csrc/tf32_mma.cuh)."""
    import torch

    return ((x.contiguous().view(torch.int32) + 0x1000) & -8192).view(torch.float32)


def mm_3xtf32(a, b):
    """a @ b in split TF32 (3xTF32): a.small b.big + a.big b.small + a.big b.big,
    summed in that order in f32."""
    a_big, b_big = tf32(a), tf32(b)
    a_small, b_small = tf32(a - a_big), tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def mm_tf32(a, b):
    """a @ b in plain TF32: both operands rounded once."""
    return tf32(a) @ tf32(b)


def in_f64(plain, *args):
    """A plain version (ops/*.py) evaluated in f64 and rounded to f32, the
    reference for the block round kernels: at H 128 and 256 two f32
    evaluations in different orders (the plain version's and the kernel's)
    differ by about 1e-5 in lg, a sum of H products, so the kernels are held
    to the exact function at the same tolerances."""
    wide = lambda a: a.double() if hasattr(a, "is_floating_point") and a.is_floating_point() else a
    out = plain(*map(wide, args))
    return [o.float() for o in (out if isinstance(out, (tuple, list)) else [out])]


def es_inputs(seed, sign, B=3, T=3, capD=16, na=5, nt=6, H=8):
    """numpy inputs and cotangents of the es round (ops/block.py::
    fused_block_round_es) over B*T step-major blocks (block q of window
    q % B): global detection ids act [P, na] / new [P, nt], distinct within
    a block, with block 0 and block 4 (where T > 1) without cells; ga_d is
    also gb_d at sign -1 ('diff').  Returns (act, new, blk_na, blk_nt,
    weights, cotangents)."""
    rng = np.random.default_rng(seed)
    P = B * T
    blk_na, blk_nt = rng.integers(1, na + 1, P), rng.integers(1, nt + 1, P)
    blk_na[0], blk_nt[min(4, P - 1)] = 0, 0
    act = np.zeros((P, na), np.int64)
    new = np.zeros((P, nt), np.int64)
    for q in range(P):
        ids = rng.choice(capD, blk_na[q] + blk_nt[q], replace=False)
        act[q, :blk_na[q]] = (q % B) * capD + ids[:blk_na[q]]
        new[q, :blk_nt[q]] = (q % B) * capD + ids[blk_na[q]:]
    m = ((np.arange(na)[None, :, None] < blk_na[:, None, None])
         & (np.arange(nt)[None, None, :] < blk_nt[:, None, None])).astype(np.float32)
    f = lambda *s, scale=1.0: (scale * rng.normal(size=s)).astype(np.float32)
    ga_d = f(B * capD, 3 * H)
    gb_d = ga_d if sign < 0 else f(B * capD, 3 * H)
    weights = dict(h_e=f(P, na, nt, H), ga_d=ga_d, gb_d=gb_d, b_ih=f(3 * H),
                   w_hh=f(H, 3 * H, scale=0.3), b_hh=f(3 * H), w_eb=f(H, 1), mask3=m)
    cot = dict(g_eo=f(P, na, nt, H), g_lg=f(P, na, nt), g_es=f(B * capD, H))
    return act, new, blk_na, blk_nt, weights, cot


EDGE_LOSS_KEYS = ("h_eo", "w_e", "b_e", "lbl", "mask3", "ebnt", "bna", "active_idx", "act_m",
                  "nD")
EDGE_LOSS_COUNTS = [3, 4, 5, 6]  # bce_count, tp, fp, fn: no gradient


def edge_loss_inputs(seed, P=11, na=8, nt=8, K=16, nD=32):
    """numpy inputs of the fused edge losses (ops/loss.py::edge_losses),
    keyed as EDGE_LOSS_KEYS, and a cotangent of the partials (0 at the
    counts); some detections have live rows and no positive edge."""
    rng = np.random.default_rng(seed)
    blk_na, blk_nt = rng.integers(0, na + 1, P), rng.integers(0, nt + 1, P)
    m3 = ((np.arange(na)[None, :, None] < blk_na[:, None, None])
          & (np.arange(nt)[None, None, :] < blk_nt[:, None, None])).astype(np.float32)
    lbl = (rng.random((P, na, nt)) < 0.25).astype(np.float32) * m3
    eb = np.cumsum(blk_na * blk_nt) - blk_na * blk_nt
    active_idx = rng.integers(0, nD, size=(P, na)).astype(np.int32)
    act_m = (m3[:, :, 0] > 0.5).reshape(-1)
    live_det = np.unique(active_idx.reshape(-1)[act_m])
    pos_det = np.unique(active_idx[(lbl > 0).any(2)])
    assert len(np.setdiff1d(live_det, pos_det)) > 0
    d_part = rng.normal(size=(P, 8)).astype(np.float32)
    d_part[:, EDGE_LOSS_COUNTS + [7]] = 0.0
    return dict(h_eo=(0.5 * rng.normal(size=(P, na, nt, K))).astype(np.float32),
                w_e=(0.3 * rng.normal(size=(K, 1))).astype(np.float32),
                b_e=np.full((1, 1), -1.0, np.float32), lbl=lbl, mask3=m3,
                ebnt=np.stack([eb, blk_nt], 1).astype(np.float32),
                bna=blk_na[:, None].astype(np.float32), active_idx=active_idx,
                act_m=act_m, nD=nD), d_part


DCN_KEYS = ("x", "weight", "bias", "offset", "mask", "g")


def dcn_inputs(seed, N=2, H=7, W=9, C=5, O=4, kind="frac", max_offset=2.0, lo=None):
    """numpy f32 inputs of the bounded deformable conv (ops/dcn.py), keyed
    by DCN_KEYS: x [N, H, W, C], weight [9*C, O], bias [O], offset [N, H,
    W, 18], mask [N, H, W, 9] in (0, 1) and a cotangent g [N, H, W, O].
    Offsets by kind: "frac" inside the bound (within +-0.5 for a bound
    below 0.6) and at least 0.05 off every integer; "int" integers in [-R, R]; "beyond" up to 1.5 past the bound
    (some clamped); "mixed" each of the three at random per element."""
    rng = np.random.default_rng(seed)
    R = int(np.ceil(max_offset))
    hi = max(max_offset - 0.1, 0.5)
    frac = rng.uniform(-hi, hi, (N, H, W, 18))
    frac = np.where(np.abs(frac - np.round(frac)) < 0.05, frac + 0.1, frac)
    ints = rng.integers(-R, R + 1, (N, H, W, 18)).astype(np.float64)
    beyond = rng.uniform(-max_offset - 1.5, max_offset + 1.5, (N, H, W, 18))
    pick = {"frac": frac, "int": ints, "beyond": beyond}
    off = (pick[kind] if kind in pick
           else np.choose(rng.integers(0, 3, (N, H, W, 18)), [frac, ints, beyond]))
    arrays = [rng.normal(size=(N, H, W, C)), rng.normal(size=(9 * C, O)) / np.sqrt(9 * C),
              rng.normal(size=(O,)), off, rng.uniform(0.05, 1.0, (N, H, W, 9)),
              rng.normal(size=(N, H, W, O))]
    return {k: np.ascontiguousarray(a, np.float32) for k, a in zip(DCN_KEYS, arrays)}


OFFSET_BIASES = (-3.5, -0.5, 0.5, 3.5)  # the DCN offsets' centres (2 of 4 beyond the bound 2)


def calibrate_dcn_offsets(net, x, seed, spread=0.05):
    """Give every DCN block of `net` random offset / mask conv weights,
    scaled on the input x [N, 3, H, W] so that each block's offsets spread
    `spread` (std) around per-channel centres drawn from OFFSET_BIASES:
    every offset fractional, about half of them beyond a bound of 2, and
    all a margin away from an integer and from the bound, where the
    bilinear derivative jumps (two f32 sums in another order could land on
    two sides of such a kink).  In forward order, so that each block is
    scaled on calibrated inputs; BN on its running statistics."""
    import torch
    import torch.nn.functional as F

    from trackmpnn_tpu_torch.backbones.deform_conv import DCN

    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))

    def scale(conv, inputs):
        with torch.no_grad():
            conv.weight.copy_(f32(rng.normal(size=conv.weight.shape)))
            conv.bias.copy_(f32(np.concatenate([rng.choice(OFFSET_BIASES, 18),
                                                rng.normal(0, 0.5, 9)])))
            raw = F.conv2d(inputs[0], conv.weight[:18], padding=1)
            conv.weight.mul_(spread / float(raw.std()))

    hooks = [m.conv_offset_mask.register_forward_pre_hook(scale)
             for m in net.modules() if isinstance(m, DCN)]
    training = net.training
    with torch.no_grad():
        net.eval()(x)
    net.train(training)
    for h in hooks:
        h.remove()
    return net


def backbone_params(arch, seed, num_vis_feats=16, dcn_max_offset=None, probe_hw=(32, 64)):
    """A JAX-layout flat dict (numpy) for `arch` ("espv2" / "dla34"): the
    port's seeded initialisation, then every leaf moved off its default so
    that a transposed, flipped or misplaced tensor shows: BN running stats
    away from (0, 1), per-channel leaves (BN affine, PReLU, biases) and the
    bilinear up-convs perturbed, and the DCN offset / mask convs (zero at
    init) calibrated on a seeded probe image of probe_hw
    (calibrate_dcn_offsets)."""
    import torch

    from trackmpnn_tpu_torch.backbones import weights as bw

    rng = np.random.default_rng(seed)
    net = bw.make_backbone(arch, num_vis_feats, dcn_max_offset,
                           torch.Generator().manual_seed(seed))
    out = {}
    for k, v in bw.backbone_to_jax_params(net).items():
        if k.endswith("running_var"):
            v = rng.uniform(0.5, 1.5, v.shape)
        elif k.endswith("running_mean"):
            v = rng.normal(0, 0.3, v.shape)
        elif (v.ndim == 1 or ".up_" in k) and "conv_offset_mask" not in k:
            v = v + rng.normal(0, 0.1 if v.ndim == 1 else 0.05, v.shape)
        out[k] = np.ascontiguousarray(v, np.float32)
    if arch == "dla34":
        net.load_state_dict(bw.state_dict_from_jax(out, net.state_dict()))
        probe = rng.normal(size=(2, 3, *probe_hw)).astype(np.float32)
        calibrate_dcn_offsets(net, torch.from_numpy(probe), seed)
        out = bw.backbone_to_jax_params(net)
    return out
