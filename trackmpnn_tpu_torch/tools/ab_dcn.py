"""Time the bounded deformable convolution's kernels (#15 dcn_fwd, #15b
dcn_bwd_sample, #15c dcn_bwd_dx), as built from several source trees, in one
process on one card, on the same seeded inputs; optionally also the bounded
DLA-34 embedding step of each tree.

    python -m trackmpnn_tpu_torch.tools.ab_dcn NAME=DIR [NAME=DIR ...]
        [--rounds 6] [--step] [--profile] [--json PATH]

DIR is a directory holding trackmpnn_tpu_torch/csrc/dcn_kernels.cu: a
checkout's root, or the parent's from `git archive`.  Each tree's source is
built with this checkout's nvcc flags (one nvcc a tree, all at once) and
loaded with ctypes; its entry points are called directly, through either C
interface: the fused one (d weight from the sampling kernel, scratch that
tm_dcn_*_scratch_floats asks for) or the first design's (the sampling
kernel writes the columns, and d weight is `cols.t() @ g`, a cuBLAS product
timed as part of that tree's backward).  The shapes are the bounded DLA-34
step's widest deform block (N 8, 96 x 320, C = O = 64) and its widest
projection (N 8, 12 x 40, C 512, O 256), max_offset 2, seeded inputs with
fractional offsets up to 1.5 past the bound (about 43% beyond it).  Every
tree's outputs are held against this checkout's plain versions (ops/dcn.py)
evaluated in f64 (the forward within atol 1e-5 x the output's scale, d
weight, d offset, d mask and d x rtol 1e-4 with atol 1e-5 x each output's
scale) and must be bitwise the same on a second launch; d x (whose C
interface has not changed) is also compared bitwise across the trees, as
the kernels keep one summation order.  Each round times every tree in turn,
the order reversed every other round: 16 calls back to back behind a
device-side sleep, between CUDA events (device time).  Prints each tree's
µs a call in every round and their median.

--step also runs, for each tree in a process of its own with that tree's
package on the path, EmbedTrainer(arch="dla34", dcn_max_offset=2.0) at 8 x
384 x 1280 (seeded weights, offset convs calibrated as chip_smoke.py's phase
15 does, seeded noise frames): 2 warm-up steps, 10 steps between CUDA events
(ms/step), then one step under torch.profiler: the device ms inside the
DCN autograd Function's forward and backward (user ranges around
DeformConvShift, summed over the 16 blocks) and the device ms of the
dcn_* kernels.  Trees run in the order given, then reversed.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

from trackmpnn_tpu_torch.ops import _build, dcn

ITERS = 16
BOUND = 2.0
SHAPES = {"widest": (8, 96, 320, 64, 64), "proj512": (8, 12, 40, 512, 256)}


def build_trees(trees: dict, out_dir: str) -> dict:
    """{name: ctypes library} for {name: tree}, one nvcc a tree, all at once."""
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for name, tree in trees.items():
        source = os.path.join(tree, "trackmpnn_tpu_torch", "csrc", "dcn_kernels.cu")
        library = os.path.join(out_dir, f"libtm_dcn_{name}.so")
        jobs[name] = (library, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", library, source],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (library, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed on tree {name}:\n{err}")
        lib = ctypes.CDLL(library)
        lib.fused = hasattr(lib, "tm_dcn_bwd_sample_scratch_floats")
        libs[name] = lib
    return libs


def problem(N, H, W, C, O, seed=0):
    """Seeded inputs on the card: x, weight, bias, offset, mask, g and the
    columns' cotangent dcols = g @ weight^T."""
    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=gen)
    frac = (torch.rand(N, H, W, 18, generator=gen) * 2 - 1) * (BOUND + 1.5)
    frac = torch.where((frac - frac.round()).abs() < 0.05, frac + 0.1, frac)  # off integers
    x = {"x": rnd(N, H, W, C), "weight": rnd(9 * C, O) / (9 * C) ** 0.5, "bias": rnd(O),
         "offset": frac, "mask": 0.05 + 0.95 * torch.rand(N, H, W, 9, generator=gen),
         "g": rnd(N, H, W, O)}
    x = {k: v.cuda().contiguous() for k, v in x.items()}
    x["dcols"] = (x["g"].reshape(-1, O) @ x["weight"].t()).reshape(N, H, W, 9 * C)
    return x


def _scratch(lib, entry, dims):
    n = ctypes.c_int64(0)
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    rc = fn(*[ctypes.c_int(v) for v in dims], ctypes.c_void_p(ctypes.addressof(n)))
    if rc != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {rc}")
    return torch.empty(max(n.value, 1), device="cuda")


def launchers(lib, x):
    """{"fwd": fn, "bwd": fn}: each launches the tree's kernels once into
    preallocated outputs and returns them (bwd: d weight, d offset, d
    mask)."""
    N, H, W, C = x["x"].shape
    O = x["weight"].shape[1]
    dims = [N, H, W, C, O]
    P = lambda t: ctypes.c_void_p(t.data_ptr())
    tail = [ctypes.c_float(BOUND)]
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    out = torch.empty(N, H, W, O, device="cuda")
    dweight = torch.empty(9 * C, O, device="cuda")
    doff, dmask = torch.empty_like(x["offset"]), torch.empty_like(x["mask"])
    fwd_in = [P(x[k]) for k in ("x", "weight", "bias", "offset", "mask")]
    lib.tm_dcn_fwd.restype = lib.tm_dcn_bwd_sample.restype = lib.tm_dcn_bwd_dx.restype = ctypes.c_int
    if lib.fused:
        fs = _scratch(lib, "tm_dcn_fwd_scratch_floats", dims)
        bs = _scratch(lib, "tm_dcn_bwd_sample_scratch_floats", dims)

        def fwd():
            check(lib.tm_dcn_fwd(*fwd_in, P(out), P(fs), *map(ctypes.c_int, dims), *tail,
                                 stream()))
            return [out]

        def bwd():
            check(lib.tm_dcn_bwd_sample(
                *(P(x[k]) for k in ("x", "offset", "mask", "dcols", "g")), P(dweight), P(doff),
                P(dmask), P(bs), *map(ctypes.c_int, dims), *tail, stream()))
            return [dweight, doff, dmask]
        keep = (fs, bs)
    else:
        cols = torch.empty_like(x["dcols"])
        g2 = x["g"].reshape(-1, O)

        def fwd():
            check(lib.tm_dcn_fwd(*fwd_in, P(out), *map(ctypes.c_int, dims), *tail, stream()))
            return [out]

        def bwd():
            check(lib.tm_dcn_bwd_sample(
                *(P(x[k]) for k in ("x", "offset", "mask", "dcols")), P(cols), P(doff), P(dmask),
                *map(ctypes.c_int, dims[:4]), *tail, stream()))
            torch.matmul(cols.reshape(-1, 9 * C).t(), g2, out=dweight)
            return [dweight, doff, dmask]
        keep = (cols,)
    dx = torch.empty_like(x["x"])

    def dxf():
        check(lib.tm_dcn_bwd_dx(P(x["offset"]), P(x["mask"]), P(x["dcols"]), P(dx),
                                *map(ctypes.c_int, dims[:4]), ctypes.c_int(dcn.reach(BOUND)),
                                *tail, stream()))
        return [dx]
    fwd.keep = bwd.keep = keep  # scratch alive as long as the launchers
    return {"fwd": fwd, "bwd": bwd, "dx": dxf}


def check(rc):
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")


def plain_f64(x):
    """The plain versions' forward and sampling backward in f64, rounded to f32."""
    d = {k: v.double() for k, v in x.items()}
    fwd = dcn.dcn_forward_reference(d["x"], d["weight"], d["bias"], d["offset"], d["mask"], BOUND)
    bwd = dcn.dcn_sample_backward_reference(d["x"], d["offset"], d["mask"], d["dcols"], d["g"],
                                            BOUND)
    dx = dcn.dcn_dx_reference(d["offset"], d["mask"], d["dcols"], BOUND)
    return {"fwd": [fwd.float()], "bwd": [t.float() for t in bwd], "dx": [dx.float()]}


def hold(tree, name, got, again, want):
    for k, (a, w) in enumerate(zip(got, want)):
        scale = max(float(w.abs().max()), 1e-30)
        err = float((a - w).abs().max())
        ok = (err <= 1e-5 * scale if name == "fwd"
              else torch.allclose(a, w, rtol=1e-4, atol=1e-5 * scale))
        if not ok:
            sys.exit(f"tree {tree}, {name} output {k}: max abs err {err:.3g} (scale {scale:.3g})")
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


# ----------------------------------------------------------- the DLA-34 step ----
STEP_HW, STEP_T, STEP_WARMUP, STEP_STEPS = (384, 1280), 8, 2, 10


@contextlib.contextmanager
def dcn_ranges(dcn_mod):
    """DeformConvShift's forward and backward inside torch.profiler user
    ranges named dcn_forward / dcn_backward."""
    from torch.profiler import record_function

    fn = dcn_mod.DeformConvShift
    fwd, bwd = fn.forward, fn.backward

    def forward(ctx, *args):
        with record_function("dcn_forward"):
            return fwd(ctx, *args)

    def backward(ctx, *args):
        with record_function("dcn_backward"):
            return bwd(ctx, *args)
    fn.forward, fn.backward = staticmethod(forward), staticmethod(backward)
    try:
        yield
    finally:
        fn.forward, fn.backward = staticmethod(fwd), staticmethod(bwd)


def step_worker() -> dict:
    """The bounded DLA-34 step of the tree whose package is on the path."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from trackmpnn_tpu_torch.ops import dcn as dcn_mod
    from trackmpnn_tpu_torch.train.embed import EmbedTrainer

    sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
    from torch_port_util import calibrate_dcn_offsets

    tr = EmbedTrainer(input_hw=STEP_HW, device="cuda", arch="dla34", dcn_max_offset=BOUND)
    rng = np.random.default_rng(0)
    probe = torch.from_numpy(rng.normal(size=(2, 3, 96, 320)).astype(np.float32)).cuda()
    calibrate_dcn_offsets(tr.net, probe, 0)
    counts = rng.integers(8, 17, STEP_T)
    n = int(counts.sum())
    hw = (STEP_HW[0] // tr.down_ratio, STEP_HW[1] // tr.down_ratio)
    pad = lambda a: np.concatenate([a, np.zeros(256 - n, a.dtype)])
    tids = rng.integers(0, 40, n).astype(np.int32)
    tids[rng.random(n) < 1 / 6] = -1
    chunk = [rng.normal(size=(STEP_T, *STEP_HW, 3)).astype(np.float32),
             pad(np.repeat(np.arange(STEP_T), counts).astype(np.int32)),
             pad(rng.integers(0, hw[0], n).astype(np.int32)),
             pad(rng.integers(0, hw[1], n).astype(np.int32)),
             np.concatenate([tids, -np.ones(256 - n, np.int32)]), np.arange(256) < n]
    chunk = [torch.from_numpy(a).cuda() for a in chunk]
    for _ in range(STEP_WARMUP):
        tr.step(*chunk)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(STEP_STEPS):
        tr.step(*chunk)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / STEP_STEPS
    with dcn_ranges(dcn_mod), profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA]) as prof:
        tr.step(*chunk)
        torch.cuda.synchronize()
    ranges = {"dcn_forward": 0.0, "dcn_backward": 0.0}
    kernels = 0.0
    for e in prof.events():
        span = (e.time_range.end - e.time_range.start) / 1e3
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name in ranges:
                ranges[e.name] += span
            elif "dcn_" in e.name:
                kernels += span
    return {"ms_per_step": ms, "dcn_range_ms": ranges,
            "dcn_range_ms_total": sum(ranges.values()), "dcn_kernels_ms": kernels}


def run_step(tree: str) -> dict:
    """step_worker() in a process of its own with `tree`'s package first on
    the path (and its own build directory)."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--step-worker"],
                          cwd=os.path.abspath(tree), env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"the DLA-34 step of tree {tree} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", help="NAME=DIR")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--step", action="store_true",
                    help="also time each tree's bounded DLA-34 embedding step")
    ap.add_argument("--profile", action="store_true",
                    help="also print each tree's kernels' device µs by torch.profiler")
    ap.add_argument("--json", default=None)
    ap.add_argument("--step-worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    if args.step_worker:
        print(json.dumps(step_worker()))
        return 0
    trees = dict(t.split("=", 1) for t in args.trees)
    libs = build_trees(trees, os.path.join(_build.BUILD_DIR, "ab_dcn"))
    result = {"card": torch.cuda.get_device_name(0), "us": {}, "step": {}}
    with torch.inference_mode():
        for shape_name, shape in SHAPES.items():
            x = problem(*shape)
            want = plain_f64(x)
            runs = {tree: launchers(lib, x) for tree, lib in libs.items()}
            for kind in ("fwd", "bwd", "dx"):
                first = None
                for tree, run in runs.items():
                    got = [t.clone() for t in run[kind]()]
                    again = run[kind]()
                    torch.cuda.synchronize()
                    hold(tree, kind, got, again, want[kind])
                    if kind == "dx":
                        first = first or (tree, got)
                        same = all(torch.equal(a, b) for a, b in zip(got, first[1]))
                        result.setdefault("dx_bitwise", {})[f"{shape_name} {tree}"] = same
                        print(f"dx {shape_name} {tree}: bitwise equal to {first[0]}'s: {same}",
                              flush=True)
                times = {tree: [] for tree in runs}
                order = list(runs)
                for r in range(args.rounds):
                    for tree in (order if r % 2 == 0 else order[::-1]):
                        times[tree].append(device_us(runs[tree][kind]))
                key = f"{kind} {shape_name}"
                result["us"][key] = {tree: {"rounds": t, "median": statistics.median(t)}
                                     for tree, t in times.items()}
                for tree, t in times.items():
                    print(f"{key} {tree}: median {statistics.median(t):.2f} us, rounds "
                          + " ".join(f"{v:.2f}" for v in t), flush=True)
                if args.profile:
                    for tree, run in runs.items():
                        split = kernel_us(run[kind])
                        result["us"][key][tree]["kernels"] = split
                        print(f"  {tree} kernels: " + ", ".join(
                            f"{k.split('(')[0][-40:]} {v:.2f}" for k, v in split.items()))
            del runs, x, want
            torch.cuda.empty_cache()
    if args.step:
        order = list(trees)
        for tree in order + order[::-1]:
            r = run_step(trees[tree])
            result["step"].setdefault(tree, []).append(r)
            print(f"step {tree}: {r['ms_per_step']:.3f} ms/step, DCN device ms in the profiled "
                  f"step {r['dcn_range_ms_total']:.3f} ({r['dcn_range_ms']}), dcn_* kernels "
                  f"{r['dcn_kernels_ms']:.3f}", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
