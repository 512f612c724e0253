"""Time kernel #1, gather_diff (and, where a tree has it, its concat mode
gather_concat), as built from several source trees, in one process on one
card, on the same inputs.

    python -m trackmpnn_tpu_torch.tools.ab_gather NAME=DIR [NAME=DIR ...]
        [--rounds 6] [--step] [--json PATH]

DIR is a directory holding trackmpnn_tpu_torch/csrc/mp_kernels.cu and the
headers it includes: a checkout's root, the parent's from `git archive`, or a
variant of the source.  Each tree's mp_kernels.cu is built with this
checkout's nvcc flags (one nvcc a tree, all at once) and loaded with ctypes;
its tm_gather_diff (and tm_gather_concat) are called directly: the C
interface of tm_gather_diff has not changed since the first design.

The inputs are chip_smoke.py's, at its three shapes (H 64): the serving
window of phase 2 (the largest window of a 30-track sequence, capacity
16,384, a seeded h), and the widest gather_diff inputs of one batch-1 step
(phase 10: the first window at capacity 4,096) and of one unfused packed
step (phase 11: 8 windows, 32,768 slots), each as a forward (h) and as
signed_segment_sum's backward (its cotangent), recorded by chip_smoke's
record_mp_widest from steps of this checkout's package on the card with
seeded weights.  Every tree's output is held bitwise against the plain
version and must be bitwise the same on a second launch.  Each round times
every tree in turn, the order reversed every other round: 64 launches back
to back behind a device-side sleep, between CUDA events (device time).
Prints each tree's µs a launch in every round and their median, and writes
them to --json.

--step also runs, for each tree in a process of its own with that tree's
package on the path, chip_smoke.py's phase 10 step (train/step.py's batch-1
step on the first window, H 64): 3 warm-up steps, 20 between CUDA events,
one profiled step (chip_smoke.py's device_profile: device busy ms and the
gather kernels' device ms).  Trees run in the order given, then reversed.
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

ITERS = 64
ENTRIES = ("tm_gather_diff", "tm_gather_concat")


def build_trees(trees: dict, out_dir: str) -> dict:
    """{name: ctypes library} for {name: tree}, one nvcc a tree, all at once;
    lib.modes lists the gather modes the tree has."""
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
        lib.modes = []
        for entry in ENTRIES:
            if hasattr(lib, entry):
                getattr(lib, entry).argtypes = _build.LIBRARIES["mp"][2][entry]
                getattr(lib, entry).restype = ctypes.c_int
                lib.modes.append(entry[3:])
        libs[name] = lib
    return libs


def recorded_inputs() -> dict:
    """{where: (h, past, fut, mask)}: chip_smoke.py's serving window and the
    widest gather_diff inputs of one batch-1 and one unfused packed step,
    as forwards and as signed_segment_sum's backward."""
    import numpy as np

    import chip_smoke as cs
    from trackmpnn_tpu_torch.decode import tracker as tracker_mod
    from trackmpnn_tpu_torch.graph import view as view_mod
    from trackmpnn_tpu_torch.train import block as train_block
    from trackmpnn_tpu_torch.train import optim, packed
    from trackmpnn_tpu_torch.train import step as train_step

    X, g, n_new = cs.peak_window(cs.SERVE_SEEDS[0])
    cap = tracker_mod._bucketed(g.n, tracker_mod.TrackerConfig().bucket)
    view = view_mod.make_view(g, X, n_new, cap, "cuda")
    h = torch.randn(cap, cs.HIDDEN, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(0))
    out = {"serving": (h, view.past, view.fut, view.edge_mask())}
    schedules, cap, t_cap, _ = cs.packed_workload(np)
    cfg, params0, stats0 = cs.row_model(torch)
    for where, batch, make in (
            ("batch 1", train_step.schedule_to_device(schedules[0], device="cuda"),
             train_step.make_train_step),
            ("packed", packed.pack_schedules(schedules, cap, t_cap, device="cuda"),
             packed.make_packed_train_step)):
        params = train_block.trainable(cs.to_device(params0, "cuda"))
        opt = optim.make_optimizer(train_block.param_leaves(params), cs.TRAIN_LR, cs.TRAIN_WD)
        keep = {}
        with cs.record_mp_widest(mp, keep):
            make(cfg, tp_classifier=False)(params, cs.to_device(stats0, "cuda"), opt, batch)
        torch.cuda.synchronize()
        for role in ("forward", "backward"):
            hh, past, fut, em = keep[("gather_diff", role)][:4]
            out[f"{where}, {role}"] = (hh.detach(), past, fut, em)
    return out


def launcher(lib, mode, args):
    """A function launching the tree's kernel in `mode` once on `args` into a
    fresh output."""
    h, past, fut, em = args
    N, H = h.shape
    width = 2 * H if mode == "gather_concat" else H
    entry = getattr(lib, f"tm_{mode}")
    ptrs = [a.data_ptr() for a in args]

    def run():
        out = torch.empty(N, width, device="cuda")
        rc = entry(*ptrs, out.data_ptr(), N, H, torch.cuda.current_stream().cuda_stream)
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


# ------------------------------------------------------------ the batch-1 step ----
STEP_WARMUP, STEP_STEPS = 3, 20


def step_worker() -> dict:
    """chip_smoke.py's phase 10 step (train/step.py's batch-1 step on the
    first window, H 64) of the tree whose package is on the path."""
    import time

    import numpy as np

    import chip_smoke as cs
    from trackmpnn_tpu_torch.train import block as train_block
    from trackmpnn_tpu_torch.train import optim
    from trackmpnn_tpu_torch.train import step as train_step

    schedules, _, _, _ = cs.packed_workload(np)
    sb = train_step.schedule_to_device(schedules[0], device="cuda")
    cfg, params, stats = cs.row_model(torch)
    params = train_block.trainable(cs.to_device(params, "cuda"))
    stats = cs.to_device(stats, "cuda")
    opt = optim.make_optimizer(train_block.param_leaves(params), cs.TRAIN_LR, cs.TRAIN_WD)
    step = train_step.make_train_step(cfg, tp_classifier=False)

    def run():
        nonlocal stats
        _, stats, loss, _ = step(params, stats, opt, sb)
        return loss

    for _ in range(STEP_WARMUP):
        run()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(STEP_STEPS):
        loss = run()
    end.record()
    end.synchronize()
    wall = (time.perf_counter() - t0) / STEP_STEPS
    prof = cs.device_profile(torch, run, wall, match="::gather_")  # #1's kernel in any tree
    return {"ms_per_step_events": start.elapsed_time(end) / STEP_STEPS,
            "ms_per_step_wall": wall * 1e3, "device_busy_ms": prof["device_busy_ms"],
            "gather_kernels_ms": prof["matched_ms"], "loss": float(loss)}


def run_step(tree: str) -> dict:
    """step_worker() in a process of its own with `tree`'s package first on
    the path (and its own build directory)."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--step-worker"],
                          cwd=os.path.abspath(tree), env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"the batch-1 step of tree {tree} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", help="NAME=DIR")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--step", action="store_true",
                    help="also time each tree's batch-1 step (chip_smoke.py phase 10)")
    ap.add_argument("--json", default=None)
    ap.add_argument("--step-worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    if args.step_worker:
        print(json.dumps(step_worker()))
        return 0
    trees = dict(t.split("=", 1) for t in args.trees)
    libs = build_trees(trees, os.path.join(_build.BUILD_DIR, "ab_gather"))
    result = {"card": torch.cuda.get_device_name(0), "us": {}, "step": {}}
    inputs = recorded_inputs()
    plain = {"gather_diff": mp.gather_diff_reference, "gather_concat": mp.gather_concat_reference}
    with torch.inference_mode():
        for where, x in inputs.items():
            N, H = x[0].shape
            shape = f"N {N}, H {H}, edge rows {int(x[3].sum())}"
            for mode in plain:
                runs = {name: launcher(lib, mode, x) for name, lib in libs.items()
                        if mode in lib.modes}
                if not runs:
                    continue
                want = plain[mode](*x)
                for name, run in runs.items():
                    got, again = run(), run()
                    if not (torch.equal(got, want) and torch.equal(got, again)):
                        sys.exit(f"tree {name}, {mode} ({where}): not bitwise its plain "
                                 f"version ({torch.equal(got, want)}) or a second launch "
                                 f"({torch.equal(got, again)})")
                times = {name: [] for name in runs}
                order = list(runs)
                for r in range(args.rounds):
                    for name in (order if r % 2 == 0 else order[::-1]):
                        times[name].append(device_us(runs[name]))
                result["us"][f"{mode} ({where})"] = {
                    "shape": shape, **{name: {"rounds": t, "median": statistics.median(t)}
                                       for name, t in times.items()}}
                for name, t in times.items():
                    print(f"{mode} ({where}; {shape}) {name}: median {statistics.median(t):.2f} "
                          "us, rounds " + " ".join(f"{v:.2f}" for v in t), flush=True)
    if args.step:
        order = list(trees)
        for tree in order + order[::-1]:
            r = run_step(trees[tree])
            result["step"].setdefault(tree, []).append(r)
            print(f"step {tree}: {r['ms_per_step_events']:.3f} ms/step (events), "
                  f"{r['ms_per_step_wall']:.3f} (host wall), device busy "
                  f"{r['device_busy_ms']:.3f} ms, gather kernels {r['gather_kernels_ms']:.3f} ms, "
                  f"loss {r['loss']:.6g}", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
