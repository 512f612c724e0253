"""The port's MOT metrics (eval/mot.py) and detection mAP
(eval/detection.py) against the JAX package's, on its hand-computed metric
fixtures and on seeded random tracking results.  Both are numpy and scipy,
so every number must be equal."""

import numpy as np
import pytest

from test_metrics_fixtures import CASES
from trackmpnn_tpu.eval import detection as jdetection
from trackmpnn_tpu.eval import mot as jmot
from trackmpnn_tpu_torch.eval import detection, mot


@pytest.mark.parametrize("name,frames,expected", CASES, ids=[c[0] for c in CASES])
def test_fixture_summaries_match_jax(name, frames, expected):
    got, want = [], []
    for seq in frames:
        a, b = mot.MOTAccumulator(), jmot.MOTAccumulator()
        for gt, hyp, d in seq:
            d = np.asarray(d, dtype=float).reshape(len(gt), len(hyp))
            a.update(gt, hyp, d)
            b.update(gt, hyp, d)
        got.append(a)
        want.append(b)
    ours = mot.summarize(got)
    assert ours == jmot.summarize(want)
    for k, v in expected.items():
        assert ours[k] == pytest.approx(v, abs=1e-12), k


def random_tracks(rng, frames=12, objects=5):
    """(bbox_pred, bbox_gt, y_out, y_gt) of one sequence: GT boxes moving,
    hypotheses noisy copies with misses, false positives and id swaps."""
    gt_rows, pred_rows, y_gt, y_out = [], [], [], []
    start = rng.uniform(0, 400, (objects, 2))
    for t in range(frames):
        for o in range(objects):
            x, y = start[o] + 6 * t
            box = [float(rng.integers(1, 4)), 0.0, x, y, x + 40, y + 30] + [0.0] * 7 + [1.0]
            gt_rows.append(box)
            y_gt.append([t, o])
            if rng.random() < 0.15:
                continue
            noisy = list(box)
            noisy[2:6] = [v + rng.normal(0, 3) for v in box[2:6]]
            noisy[13] = float(rng.uniform(0.3, 1.0))
            pred_rows.append(noisy)
            y_out.append([t, o if rng.random() > 0.1 else (o + 1) % objects])
        for _ in range(rng.poisson(0.5)):
            x, y = rng.uniform(0, 500, 2)
            pred_rows.append([1.0, 0.0, x, y, x + 30, y + 30] + [0.0] * 7
                             + [float(rng.uniform(0, 1))])
            y_out.append([t, -1 if rng.random() < 0.5 else 99])
    f = lambda r: np.array(r, np.float64)
    return f(pred_rows), f(gt_rows), np.array(y_out, np.int64), np.array(y_gt, np.int64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_sequences_match_jax(seed):
    rng = np.random.default_rng(seed)
    seqs = [random_tracks(rng) for _ in range(3)]
    got = [mot.accumulate_sequence(*s) for s in seqs]
    want = [jmot.accumulate_sequence(*s) for s in seqs]
    assert mot.summarize(got) == jmot.summarize(want)
    preds = {str(i): (s[2][s[2][:, 1] >= 0], s[0][s[2][:, 1] >= 0]) for i, s in enumerate(seqs)}
    gts = {str(i): (s[3], s[1]) for i, s in enumerate(seqs)}
    m = detection.compute_map(preds, gts)
    assert m == jdetection.compute_map(preds, gts) and 0.0 < m <= 1.0
    g, h = seqs[0][1][:6, 2:6].copy(), seqs[0][0][:7, 2:6].copy()
    np.testing.assert_array_equal(mot.iou_distance_matrix(g, h, 0.5),
                                  jmot.iou_distance_matrix(g, h, 0.5))
