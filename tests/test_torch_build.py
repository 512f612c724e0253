"""The rule by which ops/_build.py rebuilds a kernel library: a library is
stale when it is missing or older than its source or than any header the
source includes with quotes, directly or through another header.  Needs no
nvcc: only file times are read."""

import os

from trackmpnn_tpu_torch.ops import _build


def write(path, text, mtime):
    with open(path, "w") as f:
        f.write(text)
    os.utime(path, (mtime, mtime))


def test_a_newer_header_makes_the_library_stale(tmp_path):
    cu, top, inner, lib = (str(tmp_path / n) for n in ("k.cu", "top.cuh", "inner.cuh", "libk.so"))
    write(cu, '#include <cuda_runtime.h>\n#include "top.cuh"  // products\n', 100)
    write(top, '#pragma once\n  #  include "inner.cuh"\n// #include "commented.cuh"\n', 100)
    write(inner, "#pragma once\n", 100)
    write(lib, "", 200)
    assert sorted(map(os.path.basename, _build.inputs(cu))) == ["inner.cuh", "k.cu", "top.cuh"]
    assert not _build.is_stale(cu, lib)
    os.utime(inner, (300, 300))  # a header two includes down
    assert _build.is_stale(cu, lib)
    os.utime(lib, (400, 400))
    assert not _build.is_stale(cu, lib)
    os.utime(cu, (500, 500))  # the source itself, as before
    assert _build.is_stale(cu, lib)
    os.utime(lib, (600, 600))
    os.remove(inner)  # a missing header: nvcc is left to report it
    assert _build.is_stale(cu, lib)
    assert _build.is_stale(cu, str(tmp_path / "missing.so"))


def test_both_tensor_core_sources_read_the_shared_header():
    for name in ("mp", "block"):
        source, _, _ = _build.LIBRARIES[name]
        names = [os.path.basename(p) for p in _build.inputs(source)]
        assert names[0] == os.path.basename(source) and "tf32_mma.cuh" in names
        assert all(os.path.exists(p) for p in _build.inputs(source))
