"""smore-tpu on PyTorch and CUDA: the port of ``smore_tpu`` to one NVIDIA H100.

The JAX package ``smore_tpu`` stays the reference; this package mirrors its
layout (``graph/``, ``native/``, ``sampling/``, ``ops/``, ``models/``,
``io/``, ``utils/``, ``cli/``, ``parallel/``) so each module's counterpart
is easy to find. It imports ``torch``
and never ``jax`` or ``smore_tpu``.

Plain tensor code is PyTorch; each kernel that ``smore_tpu`` wrote in Pallas
for the TPU is a hand-written CUDA C++ kernel for Hopper (``csrc/``), built
with ``nvcc`` at first use and bound with ``ctypes`` (``ops/_build.py``).
Every kernel wrapper keeps a plain PyTorch twin beside it: the wrapper runs
the twin for CPU tensors and launches the kernel (or raises) for CUDA ones.

Ported: every module of ``smore_tpu``: LINE on every route, the walk,
rec, community, knowledge-graph and typed-graph families, JODIE and the
SASRec family, checkpoint/resume, warm start, the command line
``python -m smore_tpu_torch <model> ...``, and training on several devices
(``parallel/mesh.py``: one process per device over ``torch.distributed``).
"""

__version__ = "0.1.0"

from smore_tpu_torch.graph.graph import Graph  # noqa: F401
