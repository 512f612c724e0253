"""Appearance-embedding losses for joint backbone training (the counterpart
of trackmpnn_tpu/losses/embedding.py).

FairMOT-style identity classification (ref models/loss.py:162-181): track
ids map to class indices modulo the embedding width; false positives are
ignored.  Also the discriminative loss (pull to the cluster mean, push the
cluster means apart; ref loss.py:118-159), an optional alternative.  Both
take fixed-shape padded inputs with a validity mask.
"""

from __future__ import annotations

import torch

from trackmpnn_tpu_torch.ops.segment import segment_sum


def fairmot_id_loss(features, track_ids, valid, num_classes: int):
    """Cross-entropy of the embedding logits against track_id % num_classes.

    features f32[N, num_classes] raw logits; track_ids int[N] (-1 = false
    positive); valid bool[N].  False positives and padding are ignored; the
    mean runs over the counted rows (at least 1)."""
    counted = valid & (track_ids >= 0)
    cls = torch.where(counted, track_ids.long() % num_classes, 0)
    nll = -torch.log_softmax(features, dim=-1).gather(1, cls[:, None])[:, 0]
    n = torch.clamp(counted.sum(), min=1)
    return torch.where(counted, nll, 0.0).sum() / n


def discriminative_embedding_loss(features, track_ids, valid, max_clusters: int,
                                  delta_var: float = 0.5, delta_dist: float = 10.0):
    """Variance (pull) + distance (push) terms over per-track cluster means;
    track ids are bucketed by id % max_clusters."""
    tp = valid & (track_ids >= 0)
    seg = torch.where(tp, track_ids.long() % max_clusters, max_clusters)
    n = features.shape[0]
    counts = segment_sum(features.new_ones(n), seg, max_clusters, mask=tp)
    sums = segment_sum(features, seg, max_clusters, mask=tp)
    present = counts > 0
    means = sums / torch.clamp(counts, min=1.0)[:, None]

    # pull: mean over clusters of mean-over-members relu(||f - mu|| - dv)^2
    d = torch.linalg.vector_norm(features - means[seg.clamp(0, max_clusters - 1)], dim=1)
    per_row = torch.relu(d - delta_var) ** 2
    per_cluster = segment_sum(per_row, seg, max_clusters, mask=tp) / torch.clamp(counts, min=1.0)
    n_clusters = torch.clamp(present.sum(), min=1)
    var_loss = torch.where(present, per_cluster, 0.0).sum() / n_clusters

    # push: pairwise relu(dd - ||mu_i - mu_j||)^2 over distinct present pairs
    diff = means[:, None, :] - means[None, :, :]
    dist = torch.sqrt((diff ** 2).sum(-1) + 1e-12)
    eye = torch.eye(max_clusters, dtype=torch.bool, device=features.device)
    pair = present[:, None] & present[None, :] & ~eye
    push = torch.relu(delta_dist - dist) ** 2
    n_pairs = torch.clamp(pair.sum(), min=1)
    dist_loss = torch.where(pair, push, 0.0).sum() / n_pairs
    return var_loss + torch.where(present.sum() > 1, dist_loss, 0.0)
