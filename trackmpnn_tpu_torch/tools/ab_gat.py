"""Time the attention kernels (#8-#12), as built from several source trees, in
one process on one card, on the same seeded inputs.

    python -m trackmpnn_tpu_torch.tools.ab_gat NAME=DIR [NAME=DIR ...]
        [--blocks 120] [--rows 24] [--cols 24] [--hidden 64] [--heads 1 3]
        [--rounds 6] [--json PATH]

DIR is a directory holding trackmpnn_tpu_torch/csrc/gat_kernels.cu: a
checkout's root, or the parent's from `git archive`.  Each tree's source is
built with this checkout's nvcc flags (one nvcc a tree, all at once) and
loaded with ctypes; its entry points are called directly, through either C
interface: the one with scratch pointers (tm_gat_scratch_floats says how
much) or the first design's (a partials buffer [P, nh*H] in the score
backward, nothing else).  The defaults are the widest round of
chip_smoke.py's phases 7 and 19 (P 120 blocks of 24 x 24 cells, H 64), with
a rectangular live part of seeded size in each block and dropout keep masks
at 0.5.  Every tree's outputs are held against this checkout's plain
versions (ops/gat.py; forwards rtol and atol 1e-5, backwards rtol 1e-4 with
atol 1e-5 x each output's scale) and must be bitwise the same on a second
launch.  Each round times every tree in turn, the order reversed every
other round: 64 launches back to back behind a device-side sleep, between
CUDA events (device time).  The stacked kernels run at every --heads; the
single-head ones (gat1_*, gat0_*) at one head.  Prints each tree's µs a
launch in every round and their median, and writes them to --json.
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

from trackmpnn_tpu_torch.ops import _build, gat

ALPHA, KEEP = 0.2, 0.5
ITERS = 64


def build_trees(trees: dict, out_dir: str) -> dict:
    """{name: ctypes library} for {name: tree}, one nvcc a tree, all at once."""
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for name, tree in trees.items():
        source = os.path.join(tree, "trackmpnn_tpu_torch", "csrc", "gat_kernels.cu")
        library = os.path.join(out_dir, f"libtm_gat_{name}.so")
        jobs[name] = (library, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", library, source],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (library, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed on tree {name}:\n{err}")
        lib = ctypes.CDLL(library)
        lib.scratch = hasattr(lib, "tm_gat_scratch_floats")
        if lib.scratch:
            lib.tm_gat_scratch_floats.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
        libs[name] = lib
    return libs


def problem(P, na, nt, H, nh, seed=0):
    """Seeded inputs of every entry point at nh heads, on the card: each
    block's live part a rectangle of seeded size; keep masks at KEEP."""
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g)
    blk_na = torch.randint(1, na + 1, (P,), generator=g)
    blk_nt = torch.randint(1, nt + 1, (P,), generator=g)
    m = ((torch.arange(na)[None, :, None] < blk_na[:, None, None])
         & (torch.arange(nt)[None, None, :] < blk_nt[:, None, None])).float()
    ha, hn = rnd(P, na, nh * H), rnd(P, nt, nh * H)
    e = rnd(nh, P, na, nt) * m
    keep = lambda: (torch.rand(nh, P, na, nt, generator=g) < KEEP).float()
    x = {"scores": [ha, hn, 0.3 * rnd(nh * H, 1), m],
         "scores_cot": [rnd(nh, P, na, nt), rnd(nh, P, na), rnd(nh, P, nt)],
         "agg": [e, e.amax(3) + torch.rand(nh, P, na, generator=g),
                 e.amax(2) + torch.rand(nh, P, nt, generator=g),
                 1 + 2 * torch.rand(nh, P, na, generator=g),
                 1 + 2 * torch.rand(nh, P, nt, generator=g), rnd(P, na, nt, H) * m[..., None],
                 m, keep(), keep()],
         "agg_cot": [rnd(P, na, H), rnd(P, nt, H)]}
    return {k: [t.cuda().contiguous() for t in v] for k, v in x.items()}


def calls(x, nh, single):
    """{kernel: (C entry, input tensors, output shapes, plain version and its
    arguments, is a forward, scratch (kind, backward, stats), ints)} at nh
    heads; single: the single-head entry points (nh = 1)."""
    ha, hn, a, m = x["scores"]
    ge, gsal, gsbl = x["scores_cot"]
    e, mr, mc, zr, zc, he, m3, ka, kn = x["agg"]
    g_rs, g_cs = x["agg_cot"]
    P, na, nt, H = he.shape
    st = [(nh, P, na, nt), (nh, P, na), (nh, P, nt), (nh, P, na), (nh, P, nt)]
    agg_b = [tuple(t.shape) for t in (e, mr, mc, zr, zc, he)]
    if not single:
        return {
            "gat_scores_fwd": ("tm_gat_scores_fwd", [ha, hn, a, m], st,
                               (gat.gat_scores_stats_reference, (ha, hn, a, m, ALPHA, nh)),
                               True, (0, 0, 1), [P, na, nt, nh, H]),
            "gat_scores_bwd": ("tm_gat_scores_bwd", [ha, hn, a, m, ge, gsal, gsbl],
                               [ha.shape, hn.shape, (nh * H, 1)],
                               (gat.gat_scores_stats_backward_reference,
                                (ha, hn, a, m, ALPHA, nh, ge, gsal, gsbl)),
                               False, (0, 1, 1), [P, na, nt, nh, H]),
            "gat_aggregate_fwd": ("tm_gat_aggregate_fwd", [e, mr, mc, zr, zc, he, m3, ka, kn],
                                  [(P, na, H), (P, nt, H)],
                                  (gat.gat_aggregate_reference,
                                   (e, mr, mc, zr, zc, he, m3, ka, kn, KEEP)),
                                  True, (1, 0, 1), [P, na, nt, nh, H, nh]),
            "gat_aggregate_bwd": ("tm_gat_aggregate_bwd",
                                  [e, mr, mc, zr, zc, he, m3, ka, kn, g_rs, g_cs], agg_b,
                                  (gat.gat_aggregate_backward_reference,
                                   (e, mr, mc, zr, zc, he, m3, ka, kn, KEEP, g_rs, g_cs)),
                                  False, (1, 1, 1), [P, na, nt, nh, H, nh]),
        }
    one = [t[0] for t in (e, mr, mc, zr, zc)]
    sc = (ge[0], gsal[0], gsbl[0])
    return {
        "gat1_scores_fwd": ("tm_gat1_scores_fwd", [ha, hn, a, m], [s[1:] for s in st],
                            (gat.gat_scores_stats_1h_reference, (ha, hn, a, m, ALPHA)),
                            True, (0, 0, 1), [P, na, nt, H]),
        "gat1_scores_bwd": ("tm_gat1_scores_bwd", [ha, hn, a, m, *sc],
                            [ha.shape, hn.shape, (H, 1)],
                            (gat.gat_scores_stats_1h_backward_reference,
                             (ha, hn, a, m, ALPHA, *sc)),
                            False, (0, 1, 1), [P, na, nt, H]),
        "gat1_aggregate_fwd": ("tm_gat1_aggregate_fwd", [*one, he, m3, ka[0], kn[0]],
                               [(P, na, H), (P, nt, H)],
                               (gat.gat_aggregate_1h_reference,
                                (*one, he, m3, ka[0], kn[0], KEEP)),
                               True, (1, 0, 1), [P, na, nt, H]),
        "gat1_aggregate_bwd": ("tm_gat1_aggregate_bwd", [*one, he, m3, ka[0], kn[0], g_rs, g_cs],
                               [(P, na, nt), (P, na), (P, nt), (P, na), (P, nt), tuple(he.shape)],
                               (gat.gat_aggregate_1h_backward_reference,
                                (*one, he, m3, ka[0], kn[0], KEEP, g_rs, g_cs)),
                               False, (1, 1, 1), [P, na, nt, H]),
        "gat0_scores_fwd": ("tm_gat0_scores_fwd", [ha, hn, a, m], [(P, na, nt)],
                            (lambda *y: (gat.gat_scores_reference(*y),), (ha, hn, a, m, ALPHA)),
                            True, None, [P, na, nt, H]),
        "gat0_scores_bwd": ("tm_gat0_scores_bwd", [ha, hn, a, m, ge[0]],
                            [ha.shape, hn.shape, (H, 1)],
                            (gat.gat_scores_backward_reference, (ha, hn, a, m, ALPHA, ge[0])),
                            False, (0, 1, 0), [P, na, nt, H]),
    }


def launcher(lib, name, spec):
    """A function launching the tree's kernel once into preallocated outputs
    (returned), through the tree's C interface."""
    entry, ins, out_shapes, _, _, scratch, ints = spec
    P, na, nt = ints[:3]
    nh = ints[3] if len(ints) > 4 else 1
    H = ints[4] if len(ints) > 4 else ints[3]
    outs = [torch.empty(s, dtype=torch.float32, device="cuda") for s in out_shapes]
    ptrs = [t.data_ptr() for t in ins]
    extra = []
    if lib.scratch and scratch is not None and name != "gat0_scores_fwd":
        n = ctypes.c_int64(0)
        lib.tm_gat_scratch_floats(scratch[0], P, na, nt, nh, H, scratch[1], scratch[2],
                                  ctypes.addressof(n))
        extra = [torch.empty(max(n.value, 1), device="cuda")]
    elif name.endswith("scores_bwd"):  # the first design's d a partials
        extra = [torch.empty(P, nh * H, device="cuda")]
    if name.endswith("scores_bwd"):  # (..., d ha, d hn, scratch, d a, ...)
        out_ptrs = [outs[0].data_ptr(), outs[1].data_ptr(), extra[0].data_ptr(),
                    outs[2].data_ptr()]
    else:
        out_ptrs = [t.data_ptr() for t in outs] + [t.data_ptr() for t in extra]
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    tail = [ctypes.c_int(v) for v in ints] + [ctypes.c_float(KEEP if "aggregate" in name
                                                           else ALPHA)]
    args = [ctypes.c_void_p(p) for p in ptrs + out_ptrs]

    def run():
        rc = fn(*args, *tail, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
        return outs
    run.scratch = extra  # alive as long as the launcher
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


def kernel_us(fn, calls=20):
    """{CUDA kernel name: mean device µs a launch} over `calls` calls of fn,
    by torch.profiler (the split of a call between its kernels)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        total = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0)
        if total > 0 and evt.count > 0:
            out[evt.key[:60]] = total / evt.count
    return out


def check(tree, name, got, again, want, forward):
    for k, (x, w) in enumerate(zip(got, want)):
        w = w.reshape(x.shape)
        if forward:
            ok = torch.allclose(x, w, rtol=1e-5, atol=1e-5)
        else:
            ok = torch.allclose(x, w, rtol=1e-4, atol=1e-5 * max(float(w.abs().max()), 1e-30))
        if not ok:
            sys.exit(f"tree {tree}, {name} output {k}: max abs err "
                     f"{float((x - w).abs().max())}")
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        sys.exit(f"tree {tree}, {name}: not bitwise the same on a second launch")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="NAME=DIR")
    ap.add_argument("--blocks", type=int, default=120)
    ap.add_argument("--rows", type=int, default=24)
    ap.add_argument("--cols", type=int, default=24)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--heads", type=int, nargs="+", default=[1, 3])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--profile", action="store_true",
                    help="also print each tree's kernels' device µs by torch.profiler")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    trees = dict(t.split("=", 1) for t in args.trees)
    libs = build_trees(trees, os.path.join(_build.BUILD_DIR, "ab_gat"))
    result = {"card": torch.cuda.get_device_name(0), "blocks": args.blocks, "rows": args.rows,
              "cols": args.cols, "hidden": args.hidden, "us": {}}
    with torch.inference_mode():
        for nh in args.heads:
            x = problem(args.blocks, args.rows, args.cols, args.hidden, nh, seed=nh)
            live = int((x["scores"][3] != 0).sum())
            specs = calls(x, nh, False)
            if nh == 1:
                specs.update(calls(x, nh, True))
            for name, spec in specs.items():
                plain, plain_args = spec[3]
                want = plain(*plain_args)
                runs = {tree: launcher(lib, name, spec) for tree, lib in libs.items()}
                for tree, run in runs.items():
                    got = [t.clone() for t in run()]
                    again = run()
                    torch.cuda.synchronize()
                    check(tree, name, got, again, want, spec[4])
                times = {tree: [] for tree in runs}
                order = list(runs)
                for r in range(args.rounds):
                    for tree in (order if r % 2 == 0 else order[::-1]):
                        times[tree].append(device_us(runs[tree]))
                key = f"{name} nh {nh}"
                result["us"][key] = {tree: {"rounds": t, "median": statistics.median(t)}
                                     for tree, t in times.items()}
                result["us"][key]["live_cells"] = live
                for tree, t in times.items():
                    print(f"{key} {tree}: median {statistics.median(t):.2f} us, rounds "
                          + " ".join(f"{v:.2f}" for v in t), flush=True)
                if args.profile:
                    for tree, run in runs.items():
                        split = kernel_us(run)
                        result["us"][key][tree]["kernels"] = split
                        print(f"  {tree} kernels: " + ", ".join(
                            f"{k.split('(')[0][-40:]} {v:.2f}" for k, v in split.items()))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
