"""Time the fused edge losses' kernels (#13: edge_loss_l1, edge_loss_l2,
edge_loss_bwd), as built from several source trees, in one process on one
card, on the same seeded inputs; optionally also each tree's block step with
fused_loss.

    python -m trackmpnn_tpu_torch.tools.ab_loss NAME=DIR [NAME=DIR ...]
        [--rounds 6] [--profile] [--step] [--json PATH]

DIR is a directory holding trackmpnn_tpu_torch/csrc/loss_kernels.cu: a
checkout's root, or the parent's from `git archive`.  Each tree's source is
built with this checkout's nvcc flags (one nvcc a tree, all at once) and
loaded with ctypes; its entry points are called directly, through either C
interface: the current one (L2 with an f64 scratch for its column tiles,
the backward's scratch of column statistics and per-tile partials, sized by
tm_edge_loss_l2_tiles / tm_edge_loss_bwd_scratch_floats) or the first
design's (no L2 scratch, a partials row per block).

The inputs are tests/torch_port_util.py::edge_loss_inputs' (numpy, seeded;
each block's live rows and columns a random prefix, a quarter of the live
labels positive, 2,048 detections), at the widest round of the block
step's fused_loss path (P 120, na = nt = 24; chip_smoke.py phases 13-14 and
18) with the head width of one branch (K 64) and of three (K 192), and at
P 4, na = nt = 128, K 192 (a width whose block the first design held whole
in shared memory).  The glue between L1 and L2 and the spread weight of the
backward come from the plain versions.  Every tree's outputs are held
against this checkout's plain versions, the logits and the backward
evaluated in f64, L1's row statistics those of the tree's own logits in
f64 (L1 and L2 within atol 1e-5, L2's counts exact, the backward rtol 1e-4
with atol 1e-5 x each output's scale), and must be bitwise the same on a
second launch.  Each
round times every tree's three kernels in turn, the order of the trees
reversed every other round: 32 calls back to back behind a device-side
sleep, between CUDA events (device time).  Prints each tree's µs a call in
every round and their median; --profile also splits each call between its
launches by torch.profiler.

--step also runs, for each tree in a process of its own with that tree's
package on the path, the block train step with fused_loss on chip_smoke.py's
workloads: phase 13 (b) (one branch, features 2d, es_kernel and fused_loss)
and phase 18's fused_loss composition (three branches, 2d+temp+vis): 3
warm-up steps, 10 steps between CUDA events (ms/step), one profiled step
(chip_smoke.py's device_profile: device busy ms, the union of the device
intervals, and the edge_loss kernels' device ms).  Trees run in the order
given, then reversed.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

from trackmpnn_tpu_torch.ops import _build
from trackmpnn_tpu_torch.ops import loss as loss_ops
from trackmpnn_tpu_torch.tools.ab_round import device_us, kernel_us

KERNELS = ("edge_loss_l1", "edge_loss_l2", "edge_loss_bwd")
COUNTS = [3, 4, 5, 6]  # bce_count, tp, fp, fn: exact
# name: (seed, shape); the seeds give detections with live rows and no positive edge
SHAPES = {"K 64": (0, dict(P=120, na=24, nt=24, K=64)),
          "K 192": (0, dict(P=120, na=24, nt=24, K=192)),
          "wide K 192": (4, dict(P=4, na=128, nt=128, K=192))}
_P, _I = ctypes.c_void_p, ctypes.c_int
FIRST_DESIGN = {"tm_edge_loss_l1": [_P] * 10 + [_I] * 4 + [_P],
                "tm_edge_loss_l2": [_P] * 9 + [_I] * 3 + [_P],
                "tm_edge_loss_bwd": [_P] * 15 + [_I] * 4 + [_P]}


def build_trees(trees: dict, out_dir: str) -> dict:
    """{name: ctypes library} for {name: tree}, one nvcc a tree, all at once;
    lib.current tells the C interface."""
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for name, tree in trees.items():
        source = os.path.join(tree, "trackmpnn_tpu_torch", "csrc", "loss_kernels.cu")
        library = os.path.join(out_dir, f"libtm_loss_{name}.so")
        jobs[name] = (library, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", library, source],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (library, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed on tree {name}:\n{err}")
        lib = ctypes.CDLL(library)
        lib.current = hasattr(lib, "tm_edge_loss_l2_tiles")
        for entry, argtypes in (_build.LIBRARIES["loss"][2] if lib.current
                                else FIRST_DESIGN).items():
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def problem(seed, P, na, nt, K, nD=2048):
    """tests/torch_port_util.py::edge_loss_inputs on the card, as the
    kernels' arguments {kernel: args}, with the glue and the spread weight
    from the plain versions."""
    sys.path.insert(0, os.path.join(os.path.dirname(_build._PKG), "tests"))
    from torch_port_util import EDGE_LOSS_KEYS, edge_loss_inputs

    x, d_part = edge_loss_inputs(seed, P=P, na=na, nt=nt, K=K, nD=nD)
    h_eo, w_e, b_e, lbl, m3, ebnt, bna, act, act_m = (
        torch.from_numpy(np.ascontiguousarray(x[k])).cuda() for k in EDGE_LOSS_KEYS[:9])
    d_part = torch.from_numpy(d_part).cuda()
    l1 = (h_eo, w_e, b_e, lbl, m3, ebnt)
    logits, r_min, m_r, s_r = loss_ops.edge_loss_l1_reference(*l1)
    glue = loss_ops.edge_loss_glue(r_min, m_r, s_r, m3, ebnt, act, act_m, nD)
    wg = loss_ops.edge_loss_spread(r_min, glue[0], glue[2], d_part, act, act_m, nD)
    return {"edge_loss_l1": l1,
            "edge_loss_l2": (logits, lbl, m3, ebnt, bna, *glue),
            "edge_loss_bwd": (h_eo, w_e, logits, lbl, m3, ebnt, bna, *glue, wg.contiguous(),
                              d_part)}


def plain_versions(args):
    """The three plain versions' outputs: L1 and the backward evaluated in
    f64 and rounded to f32 (L1's row statistics are replaced by those of
    each tree's own logits: at nt 128 an f32 logit's rounding alone moves
    s_r by ~1e-5); L2 as it is (it sums in f64 the f32 terms the kernel
    forms; in f64 the terms would move a block's BCE sum by ulps of its f32
    result)."""
    wide = lambda a: tuple(t.double() if t.is_floating_point() else t for t in a)
    as_list = lambda out: [t.float() for t in (out if isinstance(out, (tuple, list)) else [out])]
    return {"edge_loss_l1": as_list(loss_ops.edge_loss_l1_reference(*wide(args["edge_loss_l1"]))),
            "edge_loss_l2": as_list(loss_ops.edge_loss_l2_reference(*args["edge_loss_l2"])),
            "edge_loss_bwd": as_list(loss_ops.edge_loss_bwd_reference(
                *wide(args["edge_loss_bwd"])))}


def launchers(lib, args):
    """{kernel: fn}: each launches the tree's kernel once into preallocated
    outputs (and scratch) and returns them."""
    h_eo, w_e, b_e, lbl, m3, ebnt = args["edge_loss_l1"]
    logits, _, _, _, bna, sel1g, lsedg, sizedg = args["edge_loss_l2"]
    wg, d_part = args["edge_loss_bwd"][-2:]
    P, na, nt, K = h_eo.shape
    ptr = lambda t: t.data_ptr()
    stream = lambda: torch.cuda.current_stream().cuda_stream
    lg, rmin, mr, sr = (torch.empty(P, na, nt, device="cuda"),
                        *(torch.empty(P, na, device="cuda") for _ in range(3)))
    out = torch.empty(P, 8, device="cuda")
    dheo, dw = torch.empty_like(h_eo), torch.empty(K + 1, device="cuda")
    if lib.current:
        scratch = torch.empty(max(P * lib.tm_edge_loss_l2_tiles(nt) * 8, 1),
                              dtype=torch.float64, device="cuda")
        l2_extra = [ptr(scratch)]
        partials = torch.empty(lib.tm_edge_loss_bwd_scratch_floats(P, na, nt, K), device="cuda")
    else:
        scratch, l2_extra = None, []
        partials = torch.empty(P, K + 1, device="cuda")
    l1f = lambda: lib.tm_edge_loss_l1(*map(ptr, (h_eo, w_e, b_e, lbl, m3, ebnt, lg, rmin, mr,
                                                 sr)), P, na, nt, K, stream())
    l2f = lambda: lib.tm_edge_loss_l2(*map(ptr, (logits, lbl, m3, ebnt, bna, sel1g, lsedg, sizedg,
                                                 out)), *l2_extra, P, na, nt, stream())
    bwdf = lambda: lib.tm_edge_loss_bwd(*map(ptr, (h_eo, w_e, logits, lbl, m3, ebnt, bna, sel1g,
                                                   lsedg, sizedg, wg, d_part, dheo, partials,
                                                   dw)), P, na, nt, K, stream())

    def run(call, outs):
        def fn():
            rc = call()
            if rc != 0:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
            return outs
        fn.scratch = (scratch, partials)
        return fn
    return {"edge_loss_l1": run(l1f, [lg, rmin, mr, sr]), "edge_loss_l2": run(l2f, [out]),
            "edge_loss_bwd": run(bwdf, [dheo, dw[:K].view(K, 1), dw[K:].view(1, 1)])}


def hold(tree, name, got, again, want):
    for k, (a, w) in enumerate(zip(got, want)):
        err = float((a - w).abs().max())
        ok = (err <= 1e-5 if name != "edge_loss_bwd" else
              torch.allclose(a, w, rtol=1e-4, atol=1e-5 * max(float(w.abs().max()), 1e-30)))
        if not ok:
            sys.exit(f"tree {tree}, {name} output {k}: max abs err {err:.3g}")
    if name == "edge_loss_l2" and not torch.equal(got[0][:, COUNTS], want[0][:, COUNTS]):
        sys.exit(f"tree {tree}, edge_loss_l2: the counts differ from the plain version's")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        sys.exit(f"tree {tree}, {name}: not bitwise the same on a second launch")


# ------------------------------------------------------------ the block step ----
STEP_WARMUP, STEP_STEPS = 3, 10
STEP_CASES = {"one_branch": ("2d", dict(es_kernel=True, fused_loss=True)),
              "three_branches": ("2d+temp+vis", dict(fused_loss=True))}


def step_worker() -> dict:
    """The block step with fused_loss (STEP_CASES) of the tree whose package
    is on the path, on chip_smoke.py's workloads."""
    import time

    import chip_smoke as cs
    from trackmpnn_tpu_torch.models import mpnn
    from trackmpnn_tpu_torch.train import block as train_block
    from trackmpnn_tpu_torch.train import optim

    out = {}
    for key, (features, flags) in STEP_CASES.items():
        workload = (cs.training_workload(np) if features == "2d"
                    else cs.default_training_workload(torch, np))
        schedules, t_cap, _ = workload
        bb = train_block.build_block_batch(schedules, t_cap, device="cuda")
        cfg = mpnn.ModelConfig(features=features, ncategories=3, nhidden=cs.HIDDEN,
                               msg_type="diff", nattheads=0)
        params = train_block.trainable(cs.to_device(
            mpnn.init_params(torch.Generator().manual_seed(0), cfg), "cuda"))
        stats = cs.to_device(mpnn.init_batch_stats(cfg), "cuda")
        opt = optim.make_optimizer(train_block.param_leaves(params), cs.TRAIN_LR, cs.TRAIN_WD)
        step = train_block.make_block_train_step(cfg, tp_classifier=False, **flags)
        for _ in range(STEP_WARMUP):
            params, stats, _, _ = step(params, stats, opt, bb)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(STEP_STEPS):
            params, stats, loss, _ = step(params, stats, opt, bb)
        end.record()
        end.synchronize()
        wall = (time.perf_counter() - t0) / STEP_STEPS
        prof = cs.device_profile(torch, lambda: step(params, stats, opt, bb), wall,
                                 match="edge_loss")
        out[key] = {"ms_per_step_events": start.elapsed_time(end) / STEP_STEPS,
                    "ms_per_step_wall": wall * 1e3, "device_busy_ms": prof["device_busy_ms"],
                    "edge_loss_kernels_ms": prof["matched_ms"], "loss": float(loss)}
        del bb, params, stats, opt, step
        torch.cuda.empty_cache()
    return out


def run_step(tree: str) -> dict:
    """step_worker() in a process of its own with `tree`'s package first on
    the path (and its own build directory)."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--step-worker"],
                          cwd=os.path.abspath(tree), env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"the block step of tree {tree} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", help="NAME=DIR")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--profile", action="store_true",
                    help="also split each call between its launches by torch.profiler")
    ap.add_argument("--step", action="store_true",
                    help="also time each tree's block step with fused_loss")
    ap.add_argument("--json", default=None)
    ap.add_argument("--step-worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    if args.step_worker:
        print(json.dumps(step_worker()))
        return 0
    trees = dict(t.split("=", 1) for t in args.trees)
    libs = build_trees(trees, os.path.join(_build.BUILD_DIR, "ab_loss"))
    result = {"card": torch.cuda.get_device_name(0), "us": {}, "step": {}}
    with torch.inference_mode():
        for shape_name, (seed, shape) in SHAPES.items():
            x = problem(seed, **shape)
            want = plain_versions(x)
            runs = {name: launchers(lib, x) for name, lib in libs.items()}
            for name, fns in runs.items():
                for k in KERNELS:
                    got = [t.clone() for t in fns[k]()]
                    again = fns[k]()
                    torch.cuda.synchronize()
                    if k == "edge_loss_l1":  # the row statistics of the tree's own logits
                        want[k][1:] = [t.float() for t in loss_ops.edge_loss_row_stats(
                            got[0].double(), *(t.double() for t in x[k][3:]))]
                    hold(name, k, got, again, want[k])
            m3 = x["edge_loss_l1"][4]
            desc = (f"P {shape['P']}, na {shape['na']}, nt {shape['nt']}, K {shape['K']}, "
                    f"live cells {int((m3 != 0).sum())}")
            print(f"{shape_name}: {desc}; trees {list(runs)} hold their plain versions and are "
                  f"bitwise on a second launch", flush=True)
            for k in KERNELS:
                times = {name: [] for name in runs}
                order = list(runs)
                for r in range(args.rounds):
                    for name in (order if r % 2 == 0 else order[::-1]):
                        times[name].append(device_us(runs[name][k]))
                key = f"{k} {shape_name}"
                result["us"][key] = {"shape": desc, **{
                    name: {"rounds": t, "median": statistics.median(t)}
                    for name, t in times.items()}}
                for name, t in times.items():
                    print(f"{key} {name}: median {statistics.median(t):.2f} us, rounds "
                          + " ".join(f"{v:.2f}" for v in t), flush=True)
                if args.profile:
                    for name, fns in runs.items():
                        split = kernel_us(fns[k])
                        result["us"][key][name]["kernels"] = split
                        print(f"  {name} kernels: " + ", ".join(
                            f"{n.split('(')[0][-40:]} {v:.2f}" for n, v in split.items()),
                              flush=True)
            del runs, x, want
            torch.cuda.empty_cache()
    if args.step:
        order = list(trees)
        for tree in order + order[::-1]:
            r = run_step(trees[tree])
            result["step"].setdefault(tree, []).append(r)
            for key, v in r.items():
                print(f"step {key} {tree}: {v['ms_per_step_events']:.3f} ms/step (events), "
                      f"{v['ms_per_step_wall']:.3f} (host wall), device busy "
                      f"{v['device_busy_ms']:.3f} ms, edge_loss kernels "
                      f"{v['edge_loss_kernels_ms']:.3f} ms, loss {v['loss']:.6g}", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
