"""The port stands alone: importing any of its modules loads neither JAX nor
the JAX package, and its entry points refuse to run without CUDA unless
the caller asks for the CPU.  Each check runs in a fresh interpreter, so
what this test process has already imported does not hide a leak."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in (ROOT / "ompi_tpu_torch").rglob("*.py"))


def _run(code: str) -> str:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout


@pytest.fixture(scope="module")
def leaks():
    """One fresh interpreter imports every module in turn and records what
    of JAX or the JAX package each import brought in."""
    code = f"""
import importlib, json, sys
bad = lambda: {{m for m in sys.modules if m == "jax" or m.startswith("jax.")
               or m == "ompi_tpu" or m.startswith("ompi_tpu.")}}
out = {{}}
for name in {MODULES!r}:
    before = bad()
    importlib.import_module(name)
    out[name] = sorted(bad() - before)
print(json.dumps(out))
"""
    return json.loads(_run(code))


def test_every_module_is_listed():
    assert "ompi_tpu_torch.ops.attention" in MODULES
    assert "ompi_tpu_torch.models.transformer" in MODULES
    assert "ompi_tpu_torch.optim" in MODULES
    for name in ("op", "topo", "parallel.device_plane", "parallel.mesh",
                 "parallel.collectives", "coll.quant", "parallel.overlap",
                 "ops.collective_matmul", "parallel.reshard", "serving",
                 "serving.cache", "serving.engine", "serving.fused",
                 "serving.scheduler", "parallel.simdcn", "serving.fleet",
                 "parallel.hierarchy", "parallel.ulysses",
                 "parallel.pipeline", "moe", "models.moe", "tools.mpisync",
                 "trace", "trace.merge", "trace.analyze", "perf",
                 "perf.model", "perf.goodput", "perf.sentry", "traffic",
                 "traffic.matrix", "traffic.planes", "traffic.sentry",
                 "serving.requests", "trace.critical",
                 "analysis.commgraph", "analysis.lint"):
        assert f"ompi_tpu_torch.{name}" in MODULES


@pytest.mark.parametrize("module", MODULES)
def test_import_loads_no_jax(module, leaks):
    assert leaks[module] == []


def test_entry_points_refuse_without_cuda():
    code = """
import types
import torch
from ompi_tpu_torch import optim
from ompi_tpu_torch.models import transformer as tfm
from ompi_tpu_torch.parallel.device_plane import init_device_plane
from ompi_tpu_torch.parallel.reshard import reshard
from ompi_tpu_torch.serving.engine import ServingEngine
cfg = tfm.Config(vocab=16, d_model=16, n_layers=1, n_heads=2, head_dim=8,
                 d_ff=32, seq=8, dtype=torch.float32, attn="flash")
params = tfm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
assert not torch.cuda.is_available()
# a mesh and a comm on the card, as make_mesh and DeviceComm give them
# under NCCL (no CUDA tensor can be made here)
cuda_mesh = type("CudaMesh", (), {"device_type": "cuda",
                                  "mesh_dim_names": ("tp",)})()
cuda_comm = types.SimpleNamespace(n=1, device=torch.device("cuda", 0),
                                  mesh=cuda_mesh, axis="tp")
refused = []
for call in (lambda: tfm.forward(params, [[1, 2, 3]], cfg),
             lambda: tfm.init_params(torch.Generator(), cfg),
             lambda: tfm.greedy(params, [[1, 2]], 1, cfg),
             lambda: tfm.make_train_step(cfg),
             lambda: optim.opt_state_from_numpy(
                 {"count": 0, "mu": [], "nu": []}),
             lambda: init_device_plane(rank=0, world_size=1,
                                       store=torch.distributed.HashStore()),
             lambda: ServingEngine(cuda_comm, params, cfg),
             lambda: reshard(torch.zeros(4), ("tp",), (None,), cuda_mesh)):
    try:
        call()
    except RuntimeError as e:
        refused.append("CUDA" in str(e))
print(refused)
"""
    assert _run(code).strip() == str([True] * 8)


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py, which drives the port on the card, names neither JAX
    nor the JAX package in any import, at any depth of the script."""
    import ast
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    assert "ompi_tpu_torch.parallel" in names
    bad = {n for n in names
           if n.split(".")[0] in ("jax", "jaxlib", "ompi_tpu")}
    assert bad == set()
