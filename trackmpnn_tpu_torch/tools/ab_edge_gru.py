"""Time kernel #3, fused_edge_gru, as built from several source trees, in one
process on one card, on the same seeded inputs.

    python -m trackmpnn_tpu_torch.tools.ab_edge_gru NAME=DIR [NAME=DIR ...]
        [--hidden 16 32 64 128] [--rows 16384] [--edges 11269] [--rounds 6]
        [--json PATH]

DIR is a directory holding trackmpnn_tpu_torch/csrc/mp_kernels.cu and the
headers it includes: a checkout's root, the parent's from `git archive`, or a
variant of the source.  Each tree's mp_kernels.cu is built with this
checkout's nvcc flags (one nvcc a tree, all at once) and loaded with ctypes;
its tm_fused_edge_gru_setup and tm_fused_edge_gru are called directly (the C
interface has not changed since the kernel took any width).  The defaults
are the serving window of chip_smoke.py's phase 2: 16,384 rows, 11,269 of
them edges (random endpoints here).  Every tree's output is held against the
plain version evaluated in f64 (atol 1e-5) and must be bitwise the same on a
second launch.  Each round times every tree in turn, the order reversed
every other round: 64 launches back to back behind a device-side sleep,
between CUDA events (device time).  Prints each tree's µs a launch in every
round and their median, and writes them to --json.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

from trackmpnn_tpu_torch.ops import _build, mp

ATOL = 1e-5
ITERS = 64


def build_trees(trees: dict, out_dir: str) -> dict:
    """{name: ctypes library} for {name: tree}, one nvcc a tree, all at once."""
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for name, tree in trees.items():
        source = os.path.join(tree, "trackmpnn_tpu_torch", "csrc", "mp_kernels.cu")
        library = os.path.join(out_dir, f"libtm_mp_{name}.so")
        jobs[name] = (library, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", library, source],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (library, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed on tree {name}:\n{err}")
        lib = ctypes.CDLL(library)
        entries = _build.LIBRARIES["mp"][2]
        for entry in ("tm_fused_edge_gru_setup", "tm_fused_edge_gru"):
            getattr(lib, entry).argtypes = entries[entry]
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def inputs(rows: int, edges: int, H: int, seed: int = 0):
    """h, past, fut, edge mask, w_ih, w_hh, b_ih, b_hh on the card."""
    gen = torch.Generator().manual_seed(seed)
    h = torch.randn(rows, H, generator=gen)
    past = torch.randint(0, rows, (rows,), generator=gen, dtype=torch.int32)
    fut = torch.randint(0, rows, (rows,), generator=gen, dtype=torch.int32)
    mask = torch.zeros(rows, dtype=torch.bool)
    mask[torch.randperm(rows, generator=gen)[:edges]] = True
    w = [torch.randn(H, 3 * H, generator=gen) * H ** -0.5 for _ in range(2)]
    b = [torch.randn(3 * H, generator=gen) * 0.3 for _ in range(2)]
    return [t.cuda() for t in (h, past, fut, mask, *w, *b)]


def launcher(lib, args):
    """A function launching the tree's kernel once on `args` into a fresh output."""
    h = args[0]
    N, H = h.shape
    cap = ctypes.c_int(0)
    rc = lib.tm_fused_edge_gru_setup(H, ctypes.addressof(cap))
    if rc != 0:
        raise RuntimeError(f"setup failed: CUDA error {rc}")
    ptrs = [a.data_ptr() for a in args]

    def run():
        out = torch.empty_like(h)
        rc = lib.tm_fused_edge_gru(*ptrs, out.data_ptr(), N, H, cap.value,
                                   torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return out
    return run


def device_us(fn) -> float:
    """Mean device µs a call of `fn` over ITERS calls queued behind a sleep."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    cycles = 50_000_000
    while True:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(ITERS):
            fn()
        end.record()
        ahead = not start.query()
        end.synchronize()
        if ahead:
            return start.elapsed_time(end) / ITERS * 1e3
        cycles *= 4  # the device woke before every call was queued


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="NAME=DIR")
    ap.add_argument("--hidden", type=int, nargs="+", default=[16, 32, 64, 128])
    ap.add_argument("--rows", type=int, default=16384)
    ap.add_argument("--edges", type=int, default=11269)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    trees = dict(t.split("=", 1) for t in args.trees)
    libs = build_trees(trees, os.path.join(_build.BUILD_DIR, "ab_edge_gru"))
    result = {"card": torch.cuda.get_device_name(0), "rows": args.rows, "edges": args.edges,
              "us": {}}
    with torch.inference_mode():
        for H in args.hidden:
            x = inputs(args.rows, args.edges, H)
            want = mp.edge_gru_reference(*(a.double() if a.is_floating_point() else a
                                           for a in x)).float()
            runs = {name: launcher(lib, x) for name, lib in libs.items()}
            for name, run in runs.items():
                got, again = run(), run()
                err = float((got - want).abs().max())
                if err > ATOL or not torch.equal(got, again):
                    sys.exit(f"tree {name} at H {H}: max abs err {err} (atol {ATOL}), "
                             f"bitwise on a second launch: {torch.equal(got, again)}")
            times = {name: [] for name in runs}
            order = list(runs)
            for r in range(args.rounds):
                for name in (order if r % 2 == 0 else order[::-1]):
                    times[name].append(device_us(runs[name]))
            result["us"][H] = {name: {"rounds": t, "median": statistics.median(t)}
                               for name, t in times.items()}
            for name, t in times.items():
                print(f"H {H} {name}: median {statistics.median(t):.2f} us, rounds "
                      + " ".join(f"{v:.2f}" for v in t))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
