"""Time the fused round's kernels (#14: round_fwd, round_bwd_gru, round_bwd_dw,
round_bwd_dh), as built from several source trees, in one process on one
card, on the same inputs.

    python -m trackmpnn_tpu_torch.tools.ab_round NAME=DIR [NAME=DIR ...]
        [--hidden 64 128] [--rounds 6] [--profile] [--step] [--json PATH]

DIR is a directory holding trackmpnn_tpu_torch/csrc/round_kernels.cu and the
headers it includes: a checkout's root, or the parent's from `git archive`.
Each tree's source is built with this checkout's nvcc flags (one nvcc a
tree, all at once) and loaded with ctypes; its entry points are called
directly, through either C interface: the current one (per-kind row lists
in a scratch that tm_round_rows_ints sizes, d W in the slices
tm_round_dw_slices picks) or the first design's (a transposed-weights
scratch for the GRU backward, d W partials of tm_round_dw_chunks chunks; H
16, 32 and 64 only, so it is skipped at other widths).

The inputs are chip_smoke.py's phase 11 widest round: bench.py's workload
(8 windows packed at 4,096 slots each) run forward once on the card through
packed_window_forward(fused_round=True) at each hidden width, with the
model's seeded weights; the round with the most live rows is recorded (its
h, idxw, incidence and GRU weights), its cotangent g is seeded, and the
backward kernels' other inputs come from the plain versions.  Every tree's
outputs are held against this checkout's plain versions evaluated in f64
(the forward within atol 1e-5, the backward rtol 1e-4 with atol 1e-5 x each
output's scale) and must be bitwise the same on a second launch; d h is
also compared bitwise across the trees (round_bwd_dh keeps one summation
order).  Each round
times every tree's four kernels in turn, the order of the trees reversed
every other round: 32 calls back to back behind a device-side sleep,
between CUDA events (device time).  Prints each tree's µs a call in every
round and their median, and writes them to --json; --profile also splits
each tree's call between its launches by torch.profiler.

--step also runs, for each tree in a process of its own with that tree's
package on the path, chip_smoke.py's phase 11 step (the packed fused step at
H 64): 3 warm-up steps, 10 between CUDA events, one profiled step
(chip_smoke.py's device_profile: device busy ms and the round kernels'
device ms).  Trees run in the order given, then reversed.
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

from trackmpnn_tpu_torch.ops import _build
from trackmpnn_tpu_torch.ops import round as rnd

ITERS = 32
KERNELS = ("round_fwd", "round_bwd_gru", "round_bwd_dw", "round_bwd_dh")
_P, _I = ctypes.c_void_p, ctypes.c_int
FIRST_DESIGN = {"tm_round_fwd": [_P] * 4 + [_I] + [_P] * 10 + [_I] * 3 + [_P],
                "tm_round_bwd_gru": [_P] * 16 + [_I] * 3 + [_P],
                "tm_round_dw_chunks": [_I],
                "tm_round_bwd_dw": [_P] * 6 + [_I] * 2 + [_P],
                "tm_round_bwd_dh": [_P] * 3 + [_I] + [_P] * 3 + [_I] * 3 + [_P]}
FIRST_DESIGN_WIDTHS = (16, 32, 64)


def build_trees(trees: dict, out_dir: str) -> dict:
    """{name: ctypes library} for {name: tree}, one nvcc a tree, all at once;
    lib.current tells the C interface."""
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for name, tree in trees.items():
        source = os.path.join(tree, "trackmpnn_tpu_torch", "csrc", "round_kernels.cu")
        library = os.path.join(out_dir, f"libtm_round_{name}.so")
        jobs[name] = (library, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", library, source],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (library, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed on tree {name}:\n{err}")
        lib = ctypes.CDLL(library)
        lib.current = hasattr(lib, "tm_round_rows_ints")
        for entry, argtypes in (_build.LIBRARIES["round"][2] if lib.current
                                else FIRST_DESIGN).items():
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def widest_round(H: int):
    """(h, idxw, inc_ptr, inc_idx, we, wn) of the round with the most live
    rows in one fused packed forward of chip_smoke.py's phase 11 workload
    at hidden width H, on the card."""
    import numpy as np

    import chip_smoke
    from trackmpnn_tpu_torch.train import packed

    schedules, cap, t_cap, _ = chip_smoke.packed_workload(np)
    pb = packed.pack_schedules(schedules, cap, t_cap, device="cuda")
    cfg, params, stats = chip_smoke.row_model(torch, H)
    keep = {}
    real = rnd._round_fwd_cuda

    def record(h, idxw, ip, ii, we, wn):
        live = chip_smoke.live_rows(idxw)
        if live > keep.get("live", -1):
            keep.update(live=live, args=(h.clone(), idxw.clone(), ip, ii, we, wn))
        return real(h, idxw, ip, ii, we, wn)

    rnd._round_fwd_cuda = record
    try:
        with torch.no_grad():
            packed.packed_window_forward(chip_smoke.to_device(params, "cuda"),
                                         chip_smoke.to_device(stats, "cuda"), cfg, pb, False,
                                         fused_round=True)
    finally:
        rnd._round_fwd_cuda = real
    return keep["args"], keep["live"]


def launchers(lib, args, g, xin, d4, dxin, ddir):
    """{kernel: fn}: each launches the tree's kernel once into preallocated
    outputs (and scratch) and returns them."""
    h, idxw, ip, ii, we, wn = args
    B, cap, H = h.shape
    n = B * cap
    P = lambda t: t.data_ptr()
    w = [P(x[k]) for x in (we, wn) for k in rnd._WEIGHTS]
    stream = lambda: torch.cuda.current_stream().cuda_stream
    out, xo = torch.empty_like(h), torch.empty_like(h)
    d4o, dxo, ddo = torch.empty_like(d4), torch.empty_like(h), torch.empty_like(h)
    width = 2 * H * 3 * H + 2 * 3 * H
    dw = torch.empty(2, width, device="cuda")
    dh = torch.empty_like(h)
    if lib.current:
        rows = torch.empty(lib.tm_round_rows_ints(n), dtype=torch.int32, device="cuda")
        slices = lib.tm_round_dw_slices(n, H)
        part = torch.empty(slices * width + 1, device="cuda")
        fwd = lambda: lib.tm_round_fwd(P(h), P(idxw), P(ip), P(ii), ii.numel(), *w, P(out),
                                       P(xo), P(rows), B, cap, H, stream())
        gru = lambda: lib.tm_round_bwd_gru(P(h), P(idxw), P(xin), P(g), *w, P(d4o), P(dxo),
                                           P(ddo), P(rows), B, cap, H, stream())
        dwf = lambda: lib.tm_round_bwd_dw(P(h), P(idxw), P(xin), P(d4), P(rows), P(part), P(dw),
                                          n, H, slices, stream())
        scratch = (rows, part)
    else:
        wt = torch.empty(4, 3 * H, H, device="cuda")
        part = torch.empty(lib.tm_round_dw_chunks(n), 2, width, device="cuda")
        fwd = lambda: lib.tm_round_fwd(P(h), P(idxw), P(ip), P(ii), ii.numel(), *w, P(out),
                                       P(xo), B, cap, H, stream())
        gru = lambda: lib.tm_round_bwd_gru(P(h), P(idxw), P(xin), P(g), *w, P(wt), P(d4o),
                                           P(dxo), P(ddo), B, cap, H, stream())
        dwf = lambda: lib.tm_round_bwd_dw(P(h), P(idxw), P(xin), P(d4), P(part), P(dw), n, H,
                                          stream())
        scratch = (wt, part)
    dhf = lambda: lib.tm_round_bwd_dh(P(idxw), P(ip), P(ii), ii.numel(), P(dxin), P(ddir),
                                      P(dh), B, cap, H, stream())

    def run(call, outs):
        def fn():
            rc = call()
            if rc != 0:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
            return outs
        fn.scratch = scratch
        return fn
    return {"round_fwd": run(fwd, [out, xo]), "round_bwd_gru": run(gru, [d4o, dxo, ddo]),
            "round_bwd_dw": run(dwf, [dw]), "round_bwd_dh": run(dhf, [dh])}


def plain_f64(args, g, xin, d4, dxin, ddir):
    """The four plain versions evaluated in f64, rounded to f32 (d W as the
    kernels' [2, width] rows)."""
    h, idxw, _, _, we, wn = args
    w64 = lambda w: {k: v.double() for k, v in w.items()}
    row = lambda d: torch.cat([d[k].reshape(-1) for k in rnd._WEIGHTS])
    dwe, dwn = rnd.round_bwd_dw_reference(h.double(), idxw, xin.double(), d4.double())
    return {"round_fwd": [t.float() for t in rnd.round_fwd_reference(h.double(), idxw, w64(we),
                                                                      w64(wn))],
            "round_bwd_gru": [t.float() for t in rnd.round_bwd_gru_reference(
                h.double(), idxw, xin.double(), g.double(), w64(we), w64(wn))],
            "round_bwd_dw": [torch.stack([row(dwe), row(dwn)]).float()],
            "round_bwd_dh": [rnd.round_bwd_dh_reference(idxw, dxin.double(),
                                                        ddir.double()).float()]}


def hold(tree, name, got, again, want):
    for k, (a, w) in enumerate(zip(got, want)):
        err = float((a - w).abs().max())
        ok = (err <= 1e-5 if name == "round_fwd" else
              torch.allclose(a, w, rtol=1e-4, atol=1e-5 * max(float(w.abs().max()), 1e-30)))
        if not ok:
            sys.exit(f"tree {tree}, {name} output {k}: max abs err {err:.3g}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        sys.exit(f"tree {tree}, {name}: not bitwise the same on a second launch")


def device_us(fn) -> float:
    """Mean device µs a call of `fn` over ITERS calls queued behind a sleep."""
    for _ in range(3):
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


def kernel_us(fn, calls=5):
    """{device kernel name: mean device µs a call} over `calls` calls of fn."""
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
        if total > 0:
            out[evt.key[:60]] = total / calls
    return out


# ------------------------------------------------------------ the packed step ----
STEP_WARMUP, STEP_STEPS = 3, 10


def step_worker() -> dict:
    """chip_smoke.py's phase 11 step (packed_window_forward(fused_round=True),
    its backward and Adam, H 64) of the tree whose package is on the path."""
    import time

    import numpy as np

    import chip_smoke as cs
    from trackmpnn_tpu_torch.train import block as train_block
    from trackmpnn_tpu_torch.train import optim, packed

    schedules, cap, t_cap, _ = cs.packed_workload(np)
    pb = packed.pack_schedules(schedules, cap, t_cap, device="cuda")
    cfg, params, stats = cs.row_model(torch)
    params = train_block.trainable(cs.to_device(params, "cuda"))
    stats = cs.to_device(stats, "cuda")
    opt = optim.make_optimizer(train_block.param_leaves(params), cs.TRAIN_LR, cs.TRAIN_WD)

    def step():
        nonlocal stats
        opt.zero_grad(set_to_none=True)
        loss, aux = packed.packed_window_forward(params, stats, cfg, pb, False,
                                                 fused_round=True)
        loss.backward()
        opt.step()
        stats = aux["batch_stats"]
        return loss.detach()

    for _ in range(STEP_WARMUP):
        step()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(STEP_STEPS):
        loss = step()
    end.record()
    end.synchronize()
    wall = (time.perf_counter() - t0) / STEP_STEPS
    prof = cs.device_profile(torch, step, wall, match="round_")
    return {"ms_per_step_events": start.elapsed_time(end) / STEP_STEPS,
            "ms_per_step_wall": wall * 1e3, "device_busy_ms": prof["device_busy_ms"],
            "round_kernels_ms": prof["matched_ms"], "loss": float(loss)}


def run_step(tree: str) -> dict:
    """step_worker() in a process of its own with `tree`'s package first on
    the path (and its own build directory)."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--step-worker"],
                          cwd=os.path.abspath(tree), env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"the packed step of tree {tree} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", help="NAME=DIR")
    ap.add_argument("--hidden", type=int, nargs="+", default=[64, 128])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--profile", action="store_true",
                    help="also split each call between its launches by torch.profiler")
    ap.add_argument("--step", action="store_true",
                    help="also time each tree's packed fused step (chip_smoke.py phase 11)")
    ap.add_argument("--json", default=None)
    ap.add_argument("--step-worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    if args.step_worker:
        print(json.dumps(step_worker()))
        return 0
    trees = dict(t.split("=", 1) for t in args.trees)
    libs = build_trees(trees, os.path.join(_build.BUILD_DIR, "ab_round"))
    result = {"card": torch.cuda.get_device_name(0), "us": {}, "step": {}}
    with torch.inference_mode():
        for H in args.hidden:
            rargs, live = widest_round(H)
            h, idxw, _, _, we, wn = rargs
            g = torch.randn(h.shape, generator=torch.Generator().manual_seed(H)).cuda()
            xin = rnd.round_fwd_reference(h, idxw, we, wn)[1]
            d4, dxin, ddir = rnd.round_bwd_gru_reference(h, idxw, xin, g, we, wn)
            want = plain_f64(rargs, g, xin, d4, dxin, ddir)
            usable = {name: lib for name, lib in libs.items()
                      if lib.current or H in FIRST_DESIGN_WIDTHS}
            runs = {name: launchers(lib, rargs, g, xin, d4, dxin, ddir)
                    for name, lib in usable.items()}
            first_dh = None
            for name, fns in runs.items():
                for k in KERNELS:
                    got = [t.clone() for t in fns[k]()]
                    again = fns[k]()
                    torch.cuda.synchronize()
                    hold(name, k, got, again, want[k])
                    if k == "round_bwd_dh":  # one summation order in every tree
                        first_dh = first_dh or (name, got[0])
                        same = torch.equal(got[0], first_dh[1])
                        result.setdefault("dh_bitwise", {})[f"H {H} {name}"] = same
                        print(f"round_bwd_dh H {H} {name}: d h bitwise equal to "
                              f"{first_dh[0]}'s: {same}", flush=True)
            shape = f"B {h.shape[0]}, cap {h.shape[1]}, H {H}, live rows {live}"
            print(f"H {H}: {shape}; trees {list(runs)} hold their plain versions (f64) and are "
                  f"bitwise on a second launch", flush=True)
            for k in KERNELS:
                times = {name: [] for name in runs}
                order = list(runs)
                for r in range(args.rounds):
                    for name in (order if r % 2 == 0 else order[::-1]):
                        times[name].append(device_us(runs[name][k]))
                result["us"][f"{k} H {H}"] = {
                    "shape": shape, **{name: {"rounds": t, "median": statistics.median(t)}
                                       for name, t in times.items()}}
                for name, t in times.items():
                    print(f"{k} H {H} {name}: median {statistics.median(t):.2f} us, rounds "
                          + " ".join(f"{v:.2f}" for v in t), flush=True)
                if args.profile:
                    for name, fns in runs.items():
                        split = kernel_us(fns[k])
                        result["us"][f"{k} H {H}"][name]["kernels"] = split
                        print(f"  {name} kernels: " + ", ".join(
                            f"{key.split('(')[0][-40:]} {v:.2f}" for key, v in split.items()),
                              flush=True)
            del runs, rargs, h, idxw, g, xin, d4, dxin, ddir, want
            torch.cuda.empty_cache()
    if args.step:
        order = list(trees)
        for tree in order + order[::-1]:
            r = run_step(trees[tree])
            result["step"].setdefault(tree, []).append(r)
            print(f"step {tree}: {r['ms_per_step_events']:.3f} ms/step (events), "
                  f"{r['ms_per_step_wall']:.3f} (host wall), device busy "
                  f"{r['device_busy_ms']:.3f} ms, round kernels {r['round_kernels_ms']:.3f} ms, "
                  f"loss {r['loss']:.6g}", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
