"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source compiles into its own shared library under build/torch_kernels/
at the root of the checkout, on first use and again whenever the source, or
a header it includes with quotes, is newer than its library:
csrc/mp_kernels.cu -> libtm_mp.so (serving ops, ops/mp.py),
csrc/block_kernels.cu -> libtm_block.so (train-step ops, ops/block.py),
csrc/gat_kernels.cu -> libtm_gat.so (attention heads of the train step,
ops/gat.py), csrc/round_kernels.cu -> libtm_round.so (the fused round of the
packed row layout, ops/round.py), csrc/loss_kernels.cu -> libtm_loss.so (the
fused edge losses of the block step, ops/loss.py), csrc/dcn_kernels.cu ->
libtm_dcn.so (the bounded deformable convolution of the DLA-34 embedding
backbone, ops/dcn.py).  mp_kernels.cu, block_kernels.cu and dcn_kernels.cu
include csrc/tf32_mma.cuh (the split-TF32 tensor-core products).  build() starts
one nvcc per stale source, all at once, and waits for them.  The sources
include no PyTorch header, so a build takes seconds; ctypes loads the
result.  Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# name -> (source, library, {entry point: argtypes}); every entry returns int
LIBRARIES = {
    "mp": (os.path.join(_PKG, "csrc", "mp_kernels.cu"),
           os.path.join(BUILD_DIR, "libtm_mp.so"),
           {"tm_gather_diff": [_P, _P, _P, _P, _P, _I, _I, _P],
            "tm_gather_concat": [_P, _P, _P, _P, _P, _I, _I, _P],
            "tm_signed_segment_sum": [_P] * 6 + [_I, _P, _I, _I, _I, _P],
            "tm_segment_sum_halves": [_P] * 6 + [_I, _P, _I, _I, _I, _P],
            "tm_segment_incidence": [_P] * 5 + [_I, _I, _P],
            "tm_fused_edge_gru_setup": [_I, _P],
            "tm_fused_edge_gru": [_P] * 9 + [_I, _I, _I, _P]}),
    "block": (os.path.join(_PKG, "csrc", "block_kernels.cu"),
              os.path.join(BUILD_DIR, "libtm_block.so"),
              {"tm_block_round_fwd": [_P] * 11 + [_I, _I, _I, _I, _F, _P],
               "tm_block_round_bwd": [_P] * 18 + [_I] * 5 + [_F, _P],
               "tm_block_round_es_fwd": [_P] * 17 + [_I] * 6 + [_F, _P],
               "tm_block_round_es_bwd": [_P] * 24 + [_I] * 7 + [_F, _P],
               "tm_window_scatter": [_P] * 8 + [_I] * 9 + [_P]}),
    "gat": (os.path.join(_PKG, "csrc", "gat_kernels.cu"),
            os.path.join(BUILD_DIR, "libtm_gat.so"),
            {"tm_gat_scratch_floats": [_I] * 8 + [_P],
             "tm_gat_scores_fwd": [_P] * 10 + [_I] * 5 + [_F, _P],
             "tm_gat_scores_bwd": [_P] * 11 + [_I] * 5 + [_F, _P],
             "tm_gat_aggregate_fwd": [_P] * 12 + [_I] * 6 + [_F, _P],
             "tm_gat_aggregate_bwd": [_P] * 18 + [_I] * 6 + [_F, _P],
             "tm_gat1_scores_fwd": [_P] * 10 + [_I] * 4 + [_F, _P],
             "tm_gat1_scores_bwd": [_P] * 11 + [_I] * 4 + [_F, _P],
             "tm_gat1_aggregate_fwd": [_P] * 12 + [_I] * 4 + [_F, _P],
             "tm_gat1_aggregate_bwd": [_P] * 18 + [_I] * 4 + [_F, _P],
             "tm_gat0_scores_fwd": [_P] * 5 + [_I] * 4 + [_F, _P],
             "tm_gat0_scores_bwd": [_P] * 9 + [_I] * 4 + [_F, _P]}),
    "round": (os.path.join(_PKG, "csrc", "round_kernels.cu"),
              os.path.join(BUILD_DIR, "libtm_round.so"),
              {"tm_round_rows_ints": [_I],
               "tm_round_fwd": [_P] * 4 + [_I] + [_P] * 11 + [_I] * 3 + [_P],
               "tm_round_bwd_gru": [_P] * 16 + [_I] * 3 + [_P],
               "tm_round_dw_slices": [_I, _I],
               "tm_round_bwd_dw": [_P] * 7 + [_I] * 3 + [_P],
               "tm_round_bwd_dh": [_P] * 3 + [_I] + [_P] * 3 + [_I] * 3 + [_P]}),
    "loss": (os.path.join(_PKG, "csrc", "loss_kernels.cu"),
             os.path.join(BUILD_DIR, "libtm_loss.so"),
             {"tm_edge_loss_l2_tiles": [_I],
              "tm_edge_loss_bwd_scratch_floats": [_I] * 4,
              "tm_edge_loss_l1": [_P] * 10 + [_I] * 4 + [_P],
              "tm_edge_loss_l2": [_P] * 10 + [_I] * 3 + [_P],
              "tm_edge_loss_bwd": [_P] * 15 + [_I] * 4 + [_P]}),
    "dcn": (os.path.join(_PKG, "csrc", "dcn_kernels.cu"),
            os.path.join(BUILD_DIR, "libtm_dcn.so"),
            {"tm_dcn_fwd_scratch_floats": [_I] * 5 + [_P],
             "tm_dcn_fwd": [_P] * 7 + [_I] * 5 + [_F, _P],
             "tm_dcn_bwd_sample_scratch_floats": [_I] * 5 + [_P],
             "tm_dcn_bwd_sample": [_P] * 9 + [_I] * 5 + [_F, _P],
             "tm_dcn_bwd_dx": [_P] * 4 + [_I] * 5 + [_F, _P]}),
}

_libs: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                           "the CUDA kernels are built from source on first use")
    return found


_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def inputs(source: str) -> list:
    """`source` and every file it includes with quotes, recursively, each
    resolved beside the file that includes it (as nvcc finds them)."""
    seen, todo = [], [os.path.abspath(source)]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        if os.path.exists(path):
            with open(path) as f:
                todo += [os.path.normpath(os.path.join(os.path.dirname(path), inc))
                         for inc in _INCLUDE.findall(f.read())]
    return seen


def is_stale(source: str, library: str) -> bool:
    """Whether `library` is missing or older than `source` or a header it
    includes (a missing header counts as newer: nvcc then says what is
    wrong)."""
    if not os.path.exists(library):
        return True
    built = os.path.getmtime(library)
    return any(not os.path.exists(p) or os.path.getmtime(p) > built for p in inputs(source))


def build(names=None) -> dict:
    """Compile every library of `names` (default: all) that is missing or
    older than its source or one of its headers, one nvcc process per
    source, run concurrently.

    Returns {name: {"built": bool, "seconds": float, "log": compiler output}}."""
    names = list(LIBRARIES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs, out = {}, {}
    for name in names:
        source, library, _ = LIBRARIES[name]
        if not is_stale(source, library):
            out[name] = {"built": False, "seconds": 0.0, "log": ""}
            continue
        tmp = f"{library}.{os.getpid()}.tmp"
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, source],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs[name] = (proc, tmp, time.perf_counter())
    failed = []
    for name, (proc, tmp, t0) in jobs.items():
        stdout, stderr = proc.communicate()
        source, library, _ = LIBRARIES[name]
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {source}:\n{stdout}\n{stderr}")
            continue
        os.replace(tmp, library)  # atomic: a concurrent loader never sees half a file
        out[name] = {"built": True, "seconds": time.perf_counter() - t0,
                     "log": stdout + stderr}
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str = "mp") -> ctypes.CDLL:
    """The loaded library `name`, built first if needed, every entry point typed."""
    if name not in _libs:
        build([name])
        _, library, entries = LIBRARIES[name]
        lib = ctypes.CDLL(library)
        for entry, argtypes in entries.items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return _libs[name]
