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
    "smore_tpu_torch.models.walk_base",
    "smore_tpu_torch.models.deepwalk",
    "smore_tpu_torch.models.walklets",
    "smore_tpu_torch.models.node2vec",
    "smore_tpu_torch.models.app",
    "smore_tpu_torch.models.rec",
    "smore_tpu_torch.models.hoprec",
    "smore_tpu_torch.models.hpe",
    "smore_tpu_torch.models.cse",
    "smore_tpu_torch.models.gcn",
    "smore_tpu_torch.models.eco",
    "smore_tpu_torch.models.fine",
    "smore_tpu_torch.graph.knowledge",
    "smore_tpu_torch.graph.signed",
    "smore_tpu_torch.graph.hetero",
    "smore_tpu_torch.graph.temporal",
    "smore_tpu_torch.models.kg",
    "smore_tpu_torch.models.sne",
    "smore_tpu_torch.models.fastrp",
    "smore_tpu_torch.models.cpr",
    "smore_tpu_torch.models.metapath2vec",
    "smore_tpu_torch.models.han",
    "smore_tpu_torch.models.ctdne",
    "smore_tpu_torch.utils.oracle_data",
    "smore_tpu_torch.ops.community",
    "smore_tpu_torch.models",
    "smore_tpu_torch.sampling.walks",
    "smore_tpu_torch.sampling.mappers",
    "smore_tpu_torch.sampling.fields",
    "smore_tpu_torch.utils.bench_graphs",
    "smore_tpu_torch.utils.checkpoint",
    "smore_tpu_torch.utils.rec_data",
    "smore_tpu_torch.utils.structured_data",
    "smore_tpu_torch.graph.bipartite",
    "smore_tpu_torch.ops.rnn",
    "smore_tpu_torch.ops.jodie_epoch",
    "smore_tpu_torch.ops.launches",
    "smore_tpu_torch.models.jodie",
    "smore_tpu_torch.models.sasrec",
    "smore_tpu_torch.utils.profiling",
    "smore_tpu_torch.utils.seq_data",
    "smore_tpu_torch.cli.main",
    "smore_tpu_torch.parallel",
    "smore_tpu_torch.parallel.mesh",
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
    # DTensor's module costs ~1 s a process (every CLI run); the port
    # loads it only when a mesh run needs it
    assert "torch.distributed.tensor" not in loaded
