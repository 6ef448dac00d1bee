"""No module that the harness or the reference imports, transitively, has
the top-level name of JAX or of the JAX package (compared whole: the
port's ``smore_tpu_torch`` begins with ``smore_tpu``), and the reference
imports nothing of the program."""

import glob
import json
import os
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "smore_tpu"}

# everything a run imports: the harness, its families and metric readers,
# the reference, and the port's modules they reach
HARNESS = """
import glob, importlib, json, os, sys
sys.path.insert(0, {root!r})
from perfbench.harness import main, spec, trace, check, record, readers
from perfbench.harness.families import line, walk
from perfbench.reference import laws, sgns
import perfbench.calibrate
for path in glob.glob(os.path.join({root!r}, "perfbench", "metrics", "*.py")):
    spec.metric_reader(os.path.basename(path)[:-3])
from smore_tpu_torch.graph.graph import Graph
from smore_tpu_torch.models import line as l, deepwalk, walk_base
import torch.profiler
print(json.dumps(sorted(sys.modules)))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
from perfbench.reference import laws, sgns
print(json.dumps(sorted(sys.modules)))
"""


def _modules(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code.format(root=ROOT)],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_no_jax_in_what_a_run_imports():
    mods = _modules(HARNESS)
    assert "smore_tpu_torch.models.line" in mods
    bad = [m for m in mods if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_the_reference_imports_nothing_of_the_program():
    mods = _modules(REFERENCE)
    top = {m.split(".")[0] for m in mods}
    assert not top & (FORBIDDEN | {"smore_tpu_torch"}), sorted(
        top & (FORBIDDEN | {"smore_tpu_torch"}))


def test_the_reference_sources_name_nothing_of_the_program():
    for path in glob.glob(os.path.join(ROOT, "perfbench", "reference",
                                       "*.py")):
        src = open(path).read()
        assert "smore_tpu" not in src.replace("smore_tpu_torch", ""), path
        assert "import smore_tpu_torch" not in src, path
        assert "from smore_tpu_torch" not in src, path
        assert "import jax" not in src and "from jax" not in src, path
