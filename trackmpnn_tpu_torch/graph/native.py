"""ctypes bindings for the port's native graph planner
(trackmpnn_tpu_torch/csrc/graph_planner.cpp), the C++ counterpart of the
numpy association and decode planning in graph/engine.py.

The library is built with the host's C++ compiler (`$CXX`, else g++) into
build/torch_kernels/libtm_planner.so at the root of the checkout, on first
use and again whenever the source or the compiler command changes (a hash of
both is kept beside the library).  A failed build raises RuntimeError with
the compiler's output: the engine never drops to numpy by itself.  TM_NATIVE=0
makes the engine take its numpy paths and never load this library.  Nothing
here runs when the module is imported.

The five functions take and mutate a RollingGraph as the engine's numpy
functions do, with the same results (tests/test_torch_native_planner.py
fuzzes them against each other).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import subprocess
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "graph_planner.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
CXXFLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-shared"]
ABI_VERSION = 1

_lib: Optional[ctypes.CDLL] = None

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")


def library_path() -> str:
    return os.path.join(BUILD_DIR, "libtm_planner.so")


def _command(out: str) -> list:
    return shlex.split(os.environ.get("CXX", "g++")) + CXXFLAGS + ["-o", out, SOURCE]


def _key() -> str:
    """Hash of the source and the compiler command that builds it."""
    with open(SOURCE, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(_command("")).encode())
    return h.hexdigest()


def build() -> bool:
    """Compile the library unless the one in BUILD_DIR was built from this
    source with this command.  Returns whether it compiled; raises
    RuntimeError with the compiler's output if the compiler fails or is
    missing."""
    lib, stamp, key = library_path(), library_path() + ".sha256", _key()
    if os.path.exists(lib) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == key:
                return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = _command(tmp)
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"the graph planner's build could not run {cmd[0]!r}: {e} "
                           "(set CXX, or TM_NATIVE=0 for the numpy engine)") from None
    if r.returncode != 0 or not os.path.exists(tmp):
        raise RuntimeError(f"the graph planner's build failed (exit {r.returncode}): "
                           f"{' '.join(cmd)}\n{r.stdout}{r.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    with open(f"{stamp}.{os.getpid()}.tmp", "w") as f:
        f.write(key)
    os.replace(f"{stamp}.{os.getpid()}.tmp", stamp)
    return True


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed, every entry point typed."""
    global _lib
    if _lib is not None:
        return _lib
    build()
    lib = ctypes.CDLL(library_path())
    lib.tm_abi_version.restype = ctypes.c_int
    if lib.tm_abi_version() != ABI_VERSION:
        raise RuntimeError(f"{library_path()} has ABI {lib.tm_abi_version()}, "
                           f"expected {ABI_VERSION}")
    lib.tm_associate_greedy.argtypes = [
        ctypes.c_int64, _i64p, _i64p, _i64p, _i64p, _f32p, _i64p]
    lib.tm_associate_greedy.restype = None
    lib.tm_associate_teacher.argtypes = [
        ctypes.c_int64, _i64p, _i64p, _i64p, _i64p, _i64p, _i64p]
    lib.tm_associate_teacher.restype = ctypes.c_int
    lib.tm_associate_hungarian.argtypes = [
        ctypes.c_int64, _i64p, _i64p, _i64p, _i64p, _f32p, _i64p, ctypes.c_double]
    lib.tm_associate_hungarian.restype = None
    lib.tm_decode_plan.argtypes = [
        ctypes.c_int64, _i64p, _i64p, _i64p, _i64p, _i64p, _f32p,
        ctypes.c_int64, _i64p, ctypes.c_int64, ctypes.c_int64, _i64p]
    lib.tm_decode_plan.restype = ctypes.c_int64
    _lib = lib
    return _lib


def _prep(g):
    return tuple(np.ascontiguousarray(a, dtype=np.int64) for a in (g.ts, g.det_id, g.past, g.fut))


def _column(scores: np.ndarray, k: int) -> np.ndarray:
    return np.ascontiguousarray(scores[:, k], dtype=np.float32)


def associate_greedy(g, scores: np.ndarray) -> None:
    """engine.associate_greedy: sets g.ass_id."""
    ts, det_id, past, fut = _prep(g)
    ass = np.empty(g.n, np.int64)
    load().tm_associate_greedy(g.n, ts, det_id, past, fut, _column(scores, 1), ass)
    g.ass_id = ass


def associate_teacher_forced(g) -> None:
    """engine.associate_teacher_forced: sets g.ass_id."""
    ts, det_id, past, fut = _prep(g)
    ass = np.empty(g.n, np.int64)
    rc = load().tm_associate_teacher(g.n, ts, det_id, past, fut,
                                     np.ascontiguousarray(g.label, dtype=np.int64), ass)
    if rc != 0:
        raise AssertionError("more than one GT edge from same node")
    g.ass_id = ass


def associate_hungarian(g, scores: np.ndarray, threshold: float = 0.5) -> None:
    """engine.associate_hungarian: sets g.ass_id."""
    ts, det_id, past, fut = _prep(g)
    ass = np.empty(g.n, np.int64)
    load().tm_associate_hungarian(g.n, ts, det_id, past, fut, _column(scores, 0), ass,
                                  threshold)
    g.ass_id = ass


def decode_plan(g, scores: np.ndarray, y_out: np.ndarray, t_upto: int,
                ret_win: int) -> np.ndarray:
    """engine._decode_plan_py: the chain walk and deletion plan after
    association; writes the finalised track ids into y_out[:, 1] and
    returns the kept-row indices (the engine applies them)."""
    ts, det_id, past, fut = _prep(g)
    keep = np.empty(max(g.n, 1), np.int64)
    y_c = np.ascontiguousarray(y_out, dtype=np.int64)
    kept = load().tm_decode_plan(g.n, ts, det_id, np.ascontiguousarray(g.ass_id, dtype=np.int64),
                                 past, fut, _column(scores, 1), y_out.shape[0], y_c, t_upto,
                                 ret_win, keep)
    y_out[:] = y_c
    return keep[:kept].copy()
