"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points never drop to the CPU on their own."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "trackmpnn_tpu_torch"

torch.set_num_threads(1)


def port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_importing_every_port_module_loads_no_jax():
    mods = port_modules()
    assert "trackmpnn_tpu_torch.ops.mp" in mods and len(mods) > 15
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'optax', 'flax', 'trackmpnn_tpu'))\n"
        "print(repr(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


FORBIDDEN = re.compile(
    r"^\s*(import|from) (jax|optax|flax|trackmpnn_tpu)\b|trackmpnn_tpu\.", re.M)


# chip_smoke.py imports tests/torch_port_util.py on the card, which has no JAX
@pytest.mark.parametrize("path", sorted(str(p.relative_to(REPO)) for p in PORT.rglob("*.py"))
                         + ["chip_smoke.py", "tests/torch_port_util.py"])
def test_no_jax_or_jax_package_in_source(path):
    text = (REPO / path).read_text()
    hits = [m.group(0) for m in FORBIDDEN.finditer(text)]
    assert hits == [], f"{path} names {hits}"


def test_default_device_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal only shows without one")
    from trackmpnn_tpu_torch.decode import Tracker, TrackerConfig
    from trackmpnn_tpu_torch.models import mpnn

    cfg = mpnn.ModelConfig(nhidden=16)
    params = mpnn.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Tracker(params, mpnn.init_batch_stats(cfg), cfg, TrackerConfig())
