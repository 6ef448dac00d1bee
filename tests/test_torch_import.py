"""The PyTorch port imports without JAX and without the JAX package."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "smore_tpu_torch",
    "smore_tpu_torch.graph.graph",
    "smore_tpu_torch.native.fastgraph",
    "smore_tpu_torch.sampling.alias",
    "smore_tpu_torch.sampling.tables",
    "smore_tpu_torch.sampling.banded",
    "smore_tpu_torch.io.embeddings",
    "smore_tpu_torch.ops._build",
    "smore_tpu_torch.ops.sgns_banded",
    "smore_tpu_torch.ops.sgns",
    "smore_tpu_torch.ops.scatter",
    "smore_tpu_torch.ops.update",
    "smore_tpu_torch.models.base",
    "smore_tpu_torch.models.line",
    "smore_tpu_torch.utils.bench_graphs",
]


def test_port_imports_without_jax():
    code = (
        "import importlib, json, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "jax" not in loaded
    assert not [m for m in loaded if m == "jax" or m.startswith("jax.")]
    assert not [m for m in loaded
                if m == "smore_tpu" or m.startswith("smore_tpu.")]
    assert set(MODULES) <= set(loaded)
