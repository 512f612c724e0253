"""Device-side graph representation: padded, static-shape, index-based
(the counterpart of trackmpnn_tpu/graph/view.py).

Every graph row is a "slot" (detection node or association/edge node),
numbered in exactly the reference's append order.  An edge slot carries the
slot ids of its two detection endpoints (`past`, `fut`); detections carry
self-indices (inert under masks).  `live` masks the active window and `new`
the rows introduced at the current step.  Message passing then never builds
a matrix: node_adj @ h is a two-gather subtract, edge_adj @ h a signed
segment-sum (ops/mp.py), pulled on the card through the view's incidence
(`inc`, ops/mp.py::segment_incidence), built once a view where the kernel
reads it (a CUDA view; None on the CPU, whose plain version reads none).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from trackmpnn_tpu_torch.ops import mp


class GraphView(NamedTuple):
    """One step's padded view of the rolling-window graph (capacity N)."""

    is_det: torch.Tensor  # bool[N]  True = detection slot, False = edge slot
    past: torch.Tensor    # int32[N] past-endpoint slot id (edges; self for dets)
    fut: torch.Tensor     # int32[N] future-endpoint slot id
    live: torch.Tensor    # bool[N]  slot active at this step
    new: torch.Tensor     # bool[N]  slot introduced at this step
    feat: torch.Tensor    # f32[N,F] input features (zeros for edge slots)
    # signed_segment_sum's incidence of past/fut (segment_incidence), shared
    # by every branch and round over these slots; None on the CPU, or built
    # per call
    inc: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    @property
    def capacity(self):
        return self.is_det.shape[0]

    def edge_mask(self):
        return self.live & ~self.is_det


def pack_slots(g, X: np.ndarray, cap: int):
    """Pad a RollingGraph's slot arrays to `cap` (host-side, numpy).

    The engine's endpoint arrays are int64; they are cast here, once, to
    the int32 the device side takes.  Returns (is_det, past, fut, feat)."""
    n = g.n
    idx = np.arange(cap, dtype=np.int32)
    is_det = np.zeros(cap, bool)
    is_det[:n] = g.ts != -1
    past = idx.copy()
    fut = idx.copy()
    er = np.where(g.ts == -1)[0]
    past[er] = g.past[er]
    fut[er] = g.fut[er]
    feat = np.zeros((cap, X.shape[1]), np.float32)
    dr = np.where(g.ts != -1)[0]
    feat[dr] = X[g.det_id[dr]]
    return is_det, past, fut, feat


def make_view(g, X: np.ndarray, n_new: int, cap: int, device) -> GraphView:
    """The Tracker's view of a RollingGraph: slots padded to `cap`, the
    last `n_new` live rows marked new, every field on `device`, and the
    incidence built there where the kernel reads it (mp.kernel_incidence)."""
    is_det, past, fut, feat = pack_slots(g, X, cap)
    idx = np.arange(cap)
    live = idx < g.n
    new = (idx >= g.n - n_new) & live
    put = lambda a: torch.from_numpy(a).to(device)
    past, fut = put(past), put(fut)
    return GraphView(is_det=put(is_det), past=past, fut=fut, live=put(live), new=put(new),
                     feat=put(feat), inc=mp.kernel_incidence(past, fut, cap))
