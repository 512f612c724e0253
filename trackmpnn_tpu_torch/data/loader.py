"""Prefetching loader: overlap host-side chunk building with device compute
(the counterpart of trackmpnn_tpu/data/loader.py).

The reference iterates its Dataset synchronously (DataLoader workers=0,
train.py:22-23), so file parsing, IoU assignment, and graph building stall
the accelerator.  This loader runs `build_fn(index)` in a small thread pool
a fixed depth ahead of consumption, preserving order.  NumPy/file-IO
dominate the build functions and release the GIL, so threads suffice; the device
step overlaps with the next chunks' host work.

With more than one worker, build functions that draw from one shared random
stream (a train split with random_transforms) draw in whatever order the
threads run, so such a run does not repeat itself; the JAX package's
loader behaves the same, and the training CLI keeps its two workers.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Sequence


class PrefetchLoader:
    def __init__(self, build_fn: Callable[[int], object], order: Sequence[int],
                 depth: int = 4, workers: int = 2):
        self.build_fn = build_fn
        self.order = list(order)
        self.depth = max(depth, 1)
        self.workers = max(workers, 1)

    def __len__(self):
        return len(self.order)

    def __iter__(self) -> Iterator:
        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            futures = {}
            n = len(self.order)
            ahead = min(self.depth, n)
            for i in range(ahead):
                futures[i] = pool.submit(self.build_fn, self.order[i])
            for i in range(n):
                nxt = i + ahead
                if nxt < n:
                    futures[nxt] = pool.submit(self.build_fn, self.order[nxt])
                yield futures.pop(i).result()
