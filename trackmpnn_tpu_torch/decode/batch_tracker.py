"""Batched multi-sequence inference (the counterpart of
trackmpnn_tpu/decode/batch_tracker.py).

K sequences advance in lockstep: each global step does all K host-side
graph plans, and the K padded views go to the device as ONE graph of K*cap
rows, lane k's rows at [k*cap, (k+1)*cap) and its edge endpoints offset by
k*cap.  One mpnn.forward then scores the whole cohort, so a served forward
launches each kernel once per feature branch whatever K is (where the JAX
package vmaps the one-sequence forward).  Lanes cannot interact: an edge
row's endpoints lie in its own lane, the attention softmax runs over an
endpoint's own edges, and BatchNorm uses its running statistics at
inference.  Per-sequence results are identical to the one-sequence Tracker
(the state machine below is its init -> [update -> forward -> decode] loop
with graph-empty re-init).

The hidden state stays on the device between steps: the host only drops
and permutes rows (prune and decode keeps, new rows appended), and
engine.decode_tracks / engine.prune return that plan as kept-row index
vectors.  Each step uploads the [K*cap] gather plan with the view and
downloads the [K*cap] scores; the hidden tensor never crosses to the host.

run(pipeline=True) double-buffers two cohorts: the scores come back by an
asynchronous copy, so while the card runs cohort A's forward the host
decodes and re-plans cohort B.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import List, Optional

import numpy as np
import torch

from trackmpnn_tpu_torch.decode.tracker import (TrackerConfig, _bucketed, resolve_device,
                                                scores2_from_probs)
from trackmpnn_tpu_torch.graph import engine
from trackmpnn_tpu_torch.graph.view import GraphView, pack_slots
from trackmpnn_tpu_torch.models import mpnn, weights
from trackmpnn_tpu_torch.ops import mp


class _SeqState:
    """One sequence's host-side rolling state (mirrors Tracker.run)."""

    def __init__(self, X, y_seq, cfg: TrackerConfig):
        self.X = X
        self.y = y_seq.astype(np.int64)
        self.cfg = cfg
        self.y_out = self.y.copy()
        self.y_out[:, 1] = -1
        # device-resident hidden: the cohort forward's output rows of this
        # sequence start at hid_base; the host holds only the kept-row plan
        self.hid_src: Optional[torch.Tensor] = None
        self.hid_base = 0
        self.hid_rows: Optional[np.ndarray] = None
        self.scores2 = np.zeros((0, 2), np.float32)
        self.g: Optional[engine.RollingGraph] = None
        self.phase = "init"  # init | after_init | after_update | loop | done
        self.t_cur = 0
        self.t_skip = 0
        self.t_end = 0
        self.n_new = 0
        if X.shape[0] == 0:
            self.phase = "done"

    def prepare(self) -> bool:
        """Advance host state to the next forward; False when done."""
        c = self.cfg
        if self.phase == "done":
            return False
        if self.phase == "init":
            self.g = engine.initialize(self.y, 0, mode="test")
            if self.g is None:
                self.phase = "done"
                return False
            self.t_skip = self.g.t_next
            self.t_cur = self.t_skip
            self.t_end = self.g.t_end
            self.n_new = self.g.n
            self.hid_src, self.hid_rows = None, None
            self.phase = "after_init"
            return True
        while self.t_cur < self.t_end and self.t_cur < self.t_skip:
            self.t_cur += 1
        if self.t_cur >= self.t_end:
            self.phase = "done"
            return False
        if self.g.n == 0:
            g = engine.initialize(self.y, self.t_cur, mode="test")
            if g is None:
                self.phase = "done"
                return False
            self.g = g
            self.t_skip = g.t_next
            self.n_new = g.n
            self.hid_src, self.hid_rows = None, None
        else:
            self.n_new = engine.update(self.g, self.y, self.t_cur, self.scores2,
                                       mode="test", use_hungarian=c.hungarian)
        self.phase = "after_update"
        return True

    def consume(self, probs: np.ndarray, hid_src, base: int, on_step=None):
        c = self.cfg
        n = self.g.n
        probs = probs[:n]
        self.hid_src, self.hid_base = hid_src, base
        rows = np.arange(n, dtype=np.int64)
        self.scores2 = scores2_from_probs(self.g, probs, c.tp_classifier)
        if on_step is not None:
            on_step(self.g, self.scores2)
        if self.phase == "after_init":
            self.hid_rows = rows
            self.phase = "loop"
            return
        if c.prune_threshold is not None and self.g.n > 0:
            keep = engine.prune(
                self.g, self.scores2,
                int(self.g.ts[self.g.ts != -1].min()) if np.any(self.g.ts != -1) else 0,
                self.t_cur, c.prune_threshold)
            rows = rows[keep]
            self.scores2 = self.scores2[keep]
        t_upto = self.t_end if self.t_cur == self.t_end - 1 else \
            self.t_cur - c.cur_win_size + 2
        keep = engine.decode_tracks(self.g, self.scores2, self.y_out, t_upto,
                                    c.ret_win_size, use_hungarian=c.hungarian)
        self.hid_rows = rows[keep]
        self.scores2 = self.scores2[keep]
        self.t_cur += 1
        self.phase = "loop"

    def view(self, cap: int, lane: int):
        """The padded slot arrays of lane `lane` of a cohort graph with `cap`
        rows a lane (endpoints offset into the lane) and the hidden gather
        plan: rows into hid_src, -1 for a zero row."""
        g = self.g
        is_det, past, fut, feat = pack_slots(g, self.X, cap)
        idx = np.arange(cap)
        live = idx < g.n
        new = (idx >= g.n - self.n_new) & live
        rows = np.full(cap, -1, np.int64)
        if self.hid_src is not None and self.hid_rows is not None and self.hid_rows.shape[0]:
            m = min(self.hid_rows.shape[0], cap)
            rows[:m] = self.hid_base + self.hid_rows[:m]
        off = lane * cap
        return is_det, past + off, fut + off, live, new, feat, rows


class BatchedTracker:
    """Tracks K sequences with one device forward per global step, on
    `device` (the card unless the caller asks for the CPU)."""

    def __init__(self, params, batch_stats, model_cfg: mpnn.ModelConfig, cfg: TrackerConfig,
                 device="cuda"):
        self.device = resolve_device(device)
        mpnn.check_supported(model_cfg)
        self.params, self.batch_stats = weights.to_device(params, batch_stats, model_cfg,
                                                          self.device)
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.n_forwards = 0
        self.phase_s = None

    @torch.inference_mode()
    def _forward(self, views, src):
        """One forward over the stacked lanes; returns (host scores as they
        arrive, an event to wait on or None, the device hidden)."""
        dev = self.device
        put = lambda i, dtype: torch.from_numpy(
            np.ascontiguousarray(np.concatenate([v[i] for v in views]), dtype)).to(dev)
        g = GraphView(is_det=put(0, bool), past=put(1, np.int32), fut=put(2, np.int32),
                      live=put(3, bool), new=put(4, bool), feat=put(5, np.float32))
        g = g._replace(inc=mp.kernel_incidence(g.past, g.fut, g.capacity))
        h = None
        if src is not None:
            rows = put(6, np.int64)
            h = torch.where((rows >= 0)[:, None], src[rows.clamp(0, src.shape[0] - 1)], 0.0)
        out, _ = mpnn.forward(self.params, self.batch_stats, self.model_cfg, g, h, train=False)
        self.n_forwards += 1
        if dev.type != "cuda":
            return out.scores.numpy(), None, out.hidden
        scores = out.scores.to("cpu", non_blocking=True)  # pinned: the copy runs async
        done = torch.cuda.Event()
        done.record()
        return scores, done, out.hidden

    def run(self, sequences: List, on_step=None, pipeline: bool = True,
            profile: bool = False) -> List[np.ndarray]:
        """sequences: list of (X [N, F], y_seq [N, 2]).  Returns the y_out of
        each.  on_step(seq_index, graph, scores2) fires after every forward.

        pipeline=True (needs >= 2 sequences) splits the sequences into two
        cohorts and double-buffers them; per-sequence results are identical
        to lockstep, only the interleaving of on_step calls across sequences
        changes.  profile=True sums host wall by phase into self.phase_s:
        plan (engine.initialize / update), pack (the views), dispatch (upload
        and enqueue), block (waiting for the scores), decode."""
        states = [_SeqState(X, y, self.cfg) for X, y in sequences]
        seq_idx = {id(s): i for i, s in enumerate(states)}
        self.phase_s = defaultdict(float) if profile else None
        clock = time.perf_counter

        def add(key, t0):
            if profile:
                self.phase_s[key] += clock() - t0
            return clock()

        def launch(cohort):
            t0 = clock()
            active = [s for s in cohort if s.prepare()]
            if not active:
                return None
            t0 = add("plan", t0)
            cap = _bucketed(max(s.g.n for s in active), self.cfg.bucket)
            views = [s.view(cap, k) for k, s in enumerate(active)]
            srcs = {id(s.hid_src): s.hid_src for s in active if s.hid_src is not None}
            if len(srcs) > 1:
                raise RuntimeError("cohort members must share one hidden source tensor")
            t0 = add("pack", t0)
            scores, done, hidden = self._forward(views, next(iter(srcs.values()), None))
            add("dispatch", t0)
            return active, cap, scores, done, hidden

        def consume(inflight):
            active, cap, scores, done, hidden = inflight
            t0 = clock()
            if done is not None:
                done.synchronize()
                scores = scores.numpy()
            t0 = add("block", t0)
            for k, s in enumerate(active):
                cb = (lambda g, sc, _i=seq_idx[id(s)]: on_step(_i, g, sc)) \
                    if on_step is not None else None
                s.consume(scores[k * cap:(k + 1) * cap], hidden, k * cap, on_step=cb)
            add("decode", t0)

        if pipeline and len(states) >= 2:
            mid = (len(states) + 1) // 2
            cohorts = (states[:mid], states[mid:])
            inflight = [launch(cohorts[0]), launch(cohorts[1])]
            turn = 0
            while inflight[0] is not None or inflight[1] is not None:
                if inflight[turn] is not None:
                    consume(inflight[turn])
                    inflight[turn] = launch(cohorts[turn])
                turn ^= 1
        else:
            while True:
                fl = launch(states)
                if fl is None:
                    break
                consume(fl)
        return [s.y_out for s in states]
