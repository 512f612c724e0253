"""TrackMPNN forward on a GraphView (the counterpart of
trackmpnn_tpu/models/mpnn.py), for msg_type 'diff' and 'concat', with or
without GAT attention heads, for any of the feature branches 2d, temp and
vis.

  * per-feature-branch input MLP (Linear-BN-ReLU-Linear) applied to the rows
    introduced this step - including zero-feature edge rows, which therefore
    take part in BatchNorm statistics (ref track_mpnn.py:58-61);
  * new edge rows start with zero hidden state;
  * one FactorGraphGRU round per step: edge rows update from the difference
    of their endpoints' hiddens (ops.mp.gather_diff) through the edge GRU,
    both in one ops.mp.fused_edge_gru where no gradient is recorded; with
    msg 'concat' from both endpoints' hiddens side by side
    (ops.mp.gather_concat) through an edge GRU of input width 2H, with or
    without a gradient;
    detection rows update from the signed sum of incident edge hiddens
    (ops.mp.signed_segment_sum), or with attention heads from the mean over
    heads of the attention-weighted signed sums, through the node GRU (ref
    layers.py:7-46, 84-116);
  * biased output heads: detections +4.595 prior, edges -4.595
    (ref track_mpnn.py:35-43).

Parameters are nested dicts/lists of tensors in the JAX package's layout
(models/nn.py); models/weights.py converts them from and to the JAX pytrees.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from trackmpnn_tpu_torch.graph.view import GraphView
from trackmpnn_tpu_torch.models import nn
from trackmpnn_tpu_torch.ops import mp
from trackmpnn_tpu_torch.ops.segment import segment_softmax, segment_sum

LEAKY_ALPHA = 0.2
ATT_DROPOUT = 0.5
HEAD_BIAS = 4.595  # sigmoid prior ~0.99 for detections, ~0.01 for edges


def branch_widths(features: str, ncategories: int, num_vis_feats: int = 128):
    """(name, width) per feature branch in concatenation order; '2d' is the
    category one-hot + [score, xc, yc, w, h]."""
    widths = []
    if "2d" in features:
        widths.append(("2d", ncategories + 5))
    if "temp" in features:
        widths.append(("temp", 2))
    if "vis" in features:
        widths.append(("vis", num_vis_feats))
    if not widths:
        raise ValueError(f"no recognized feature branches in {features!r}")
    return widths


class ModelConfig(NamedTuple):
    features: str = "2d"
    ncategories: int = 3
    nhidden: int = 64
    nattheads: int = 0
    msg_type: str = "diff"  # 'diff' | 'concat'
    num_vis_feats: int = 128

    @property
    def branches(self):
        return branch_widths(self.features, self.ncategories, self.num_vis_feats)

    @property
    def nfeatures(self):
        return sum(w for _, w in self.branches)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a configuration the model does not define."""
    if cfg.msg_type not in ("diff", "concat"):
        raise ValueError(f"msg_type must be 'diff' or 'concat', got {cfg.msg_type!r}")


class ModelOutput(NamedTuple):
    scores: torch.Tensor   # f32[N]  sigmoid(logits), 0 on rows not live
    logits: torch.Tensor   # f32[N]
    hidden: torch.Tensor   # f32[N, nbranches*nhidden]


def init_params(generator: torch.Generator, cfg: ModelConfig, device="cpu"):
    """Reference-style init (normal std 0.01, zero biases, +/-4.595 head
    priors; attention heads xavier-uniform with gain 1.414) drawn from
    `generator`; the JAX package draws other numbers from its own keys, so
    shared weights go through models/weights.py."""
    check_supported(cfg)
    H = cfg.nhidden
    branches = []
    for _, width in cfg.branches:
        b = {
            "input": nn.input_transform_init(generator, width, H, device),
            "edge_gru": nn.gru_init(generator, 2 * H if cfg.msg_type == "concat" else H, H,
                                    device=device),
            "node_gru": nn.gru_init(generator, H, H, device=device),
        }
        if cfg.nattheads > 0:
            b["gat"] = [{"W_att": nn.xavier_uniform(generator, (H, H), 1.414, device),
                         "a": nn.xavier_uniform(generator, (H, 1), 1.414, device)}
                        for _ in range(cfg.nattheads)]
        branches.append(b)
    nb = len(cfg.branches)
    return {
        "branches": branches,
        "out_node": nn.linear_init(generator, nb * H, 1, b_val=+HEAD_BIAS, device=device),
        "out_edge": nn.linear_init(generator, nb * H, 1, b_val=-HEAD_BIAS, device=device),
    }


def init_batch_stats(cfg: ModelConfig, device="cpu"):
    return {"branches": [{"bn": nn.batchnorm_stats_init(cfg.nhidden, device)}
                         for _ in cfg.branches]}


def _gat_head(params, h, g: GraphView, generator, keep=None):
    """One GraphAttentionLayer head (ref layers.py:7-46, mpnn.py:141-166).

    A scalar score per edge from |h_att[past] - h_att[fut]| @ a; a softmax
    per detection over its incident edges (each edge is in both endpoints'
    sets, with sign +1 at its past end and -1 at its future end); at train
    time dropout on the attention weights, with the keep mask `keep`
    ([2N], as the JAX package draws it) or else one drawn from `generator`
    (another stream than the JAX package's, the same distribution)."""
    n = g.capacity
    em = g.edge_mask()
    h_att = h @ params["W_att"]
    a_in = torch.where(em[:, None], (h_att[g.past] - h_att[g.fut]).abs(), 0.0)
    e_score = torch.nn.functional.leaky_relu(a_in @ params["a"], LEAKY_ALPHA)[:, 0]
    # doubled incidence: entry k < n is (past[k] <- +e_k), k >= n is (fut[k] <- -e_k)
    seg = torch.cat([g.past, g.fut])
    mask2 = torch.cat([em, em])
    att = segment_softmax(torch.cat([e_score, e_score]), seg, n, mask=mask2)
    if keep is None and generator is not None:
        keep = torch.rand(att.shape, generator=generator, device=att.device) < 1.0 - ATT_DROPOUT
    if keep is not None:
        att = att * keep / (1.0 - ATT_DROPOUT)
    sign = torch.cat([h.new_ones(n), -h.new_ones(n)])
    return segment_sum(torch.cat([h, h]) * (att * sign)[:, None], seg, n, mask=mask2)


def _factor_graph_gru(params, h, g: GraphView, msg_type, nattheads, generator, keeps=None):
    """FactorGraphGRU round (ref layers.py:84-116): edge-GRU then node-GRU.
    keeps: per head, the keep mask of its attention dropout, or None."""
    em = g.edge_mask()
    eg = params["edge_gru"]
    if msg_type == "concat":  # fused_edge_gru takes diff only
        edge_out = nn.gru_cell(eg, mp.gather_concat(h, g.past, g.fut, em, g.inc), h)
    elif torch.is_grad_enabled():
        edge_out = nn.gru_cell(eg, mp.gather_diff(h, g.past, g.fut, em, g.inc), h)
    else:  # the same function in one launch, which has no backward
        edge_out = mp.fused_edge_gru(h, g.past, g.fut, em, eg["w_ih"], eg["w_hh"],
                                     eg["b_ih"], eg["b_hh"])
    if nattheads > 0:
        keeps = keeps if keeps is not None else [None] * nattheads
        edge_support = sum(_gat_head(hp, h, g, generator, k)
                           for hp, k in zip(params["gat"], keeps)) / nattheads
    else:
        edge_support = mp.signed_segment_sum(h, g.past, g.fut, em, g.capacity, g.inc)
    node_out = nn.gru_cell(params["node_gru"], edge_support, h)
    out = torch.where(g.is_det[:, None], node_out, edge_out)
    return torch.where(g.live[:, None], out, 0.0)


def forward(params, batch_stats, cfg: ModelConfig, g: GraphView,
            h_prev: Optional[torch.Tensor], *, train: bool = False,
            generator: Optional[torch.Generator] = None, att_keep=None):
    """One message-passing round over the live window.

    h_prev: f32[N, nbranches*nhidden] hidden state from the previous round
    (rows for slots not yet live are ignored), or None on the first round.
    At train time with attention heads, dropout on the attention weights:
    att_keep[branch][head] is a keep mask (bool or 0/1 [2N], the shape the
    JAX package draws with its keys, models/mpnn.py:161), or else
    `generator` draws them on the device of g; one of the two is needed
    unless ATT_DROPOUT is 0.

    Returns (ModelOutput, new_batch_stats).
    """
    check_supported(cfg)
    dropout = train and cfg.nattheads > 0 and ATT_DROPOUT > 0.0
    if dropout and generator is None and att_keep is None:
        raise ValueError("training with attention heads needs a generator for the "
                         "attention dropout (pass generator=...)")
    n = g.capacity
    H = cfg.nhidden
    nb = len(cfg.branches)
    if h_prev is None:
        h_prev = torch.zeros(n, nb * H, device=g.feat.device)

    has_new = g.new.any()
    new_det = g.new & g.is_det

    outs = []
    new_stats_branches = []
    off = 0
    for bi, (_, width) in enumerate(cfg.branches):
        bp = params["branches"][bi]
        bs = batch_stats["branches"][bi]["bn"]
        x = g.feat[:, off : off + width]
        off += width
        xt, bn_stats = nn.input_transform(bp["input"], bs, x, g.new, train=train)
        # if no rows were introduced this step, torch never runs BN: keep stats
        bn_stats = {k: torch.where(has_new, bn_stats[k], bs[k]) for k in bs}
        new_stats_branches.append({"bn": bn_stats})
        h_b = h_prev[:, bi * H : (bi + 1) * H]
        # new detection rows take the transformed input; new edge rows start at 0
        h_b = torch.where(new_det[:, None], xt, torch.where(g.new[:, None], 0.0, h_b))
        h_b = torch.where(g.live[:, None], h_b, 0.0)
        outs.append(_factor_graph_gru(bp, h_b, g, cfg.msg_type, cfg.nattheads,
                                      generator if dropout else None,
                                      att_keep[bi] if dropout and att_keep is not None else None))

    h_out = torch.cat(outs, dim=-1)
    y_node = nn.linear(params["out_node"], h_out)[:, 0]
    y_edge = nn.linear(params["out_edge"], h_out)[:, 0]
    logits = torch.where(g.is_det, y_node, y_edge)
    logits = torch.where(g.live, logits, 0.0)
    scores = torch.where(g.live, torch.sigmoid(logits), 0.0)
    return ModelOutput(scores=scores, logits=logits, hidden=h_out), {"branches": new_stats_branches}
