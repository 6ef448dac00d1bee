"""The launch counters of the kernels' wrappers, and the launches a captured
CUDA graph holds.

Each wrapper (``sgns_shared_grads``, ``band_scatter_add``,
``sgns_banded_multiblock``, ``sgns_banded_multiblock_nb``,
``sgns_banded_fused``, ``jodie_epoch``, ``random_walk``,
``node2vec_walk``) adds one to its
own ``launches`` attribute where it launches its kernel. A CUDA graph
replays its kernels without running the wrappers' Python, so
``TrainDriver`` reads, from the captured graph's own nodes, how many
launches of each kernel it holds (``in_graph``), holds that to how far each
counter moved while the call was captured, takes the capture's count back
(nothing ran) and credits the graph's on every replay (``recorded``,
``credit``): the counters count launches the card ran.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Tuple

# each kernel library's prefix: its ``<prefix>_graph_launches`` counts the
# nodes of a captured graph that launch its kernel (csrc/graph_nodes.cuh)
_PREFIX = {
    "sgns_banded_multiblock": "sgns_mb",
    "sgns_shared_grads": "sgns_sg",
    "sgns_banded_fused": "sgns_bf",
    "band_scatter_add": "band_scatter",
    "sgns_banded_multiblock_nb": "sgns_nb",
    "jodie_epoch": "jodie_epoch",
    "random_walk": "random_walk",
    "node2vec_walk": "node2vec_walk",
}

Credit = List[Tuple[object, int]]


@functools.cache
def wrappers() -> dict:
    """The launch-counting wrappers of every kernel, by kernel name."""
    from smore_tpu_torch.ops.jodie_epoch import jodie_epoch
    from smore_tpu_torch.ops.node2vec_walk import node2vec_walk
    from smore_tpu_torch.ops.random_walk import random_walk
    from smore_tpu_torch.ops.scatter import band_scatter_add
    from smore_tpu_torch.ops.sgns import sgns_shared_grads
    from smore_tpu_torch.ops.sgns_banded import (
        sgns_banded_fused,
        sgns_banded_multiblock,
        sgns_banded_multiblock_nb,
    )

    funcs = {f.__name__: f for f in (sgns_banded_multiblock, sgns_shared_grads,
                                     sgns_banded_fused, band_scatter_add,
                                     sgns_banded_multiblock_nb, jodie_epoch,
                                     random_walk, node2vec_walk)}
    assert list(funcs) == list(_PREFIX)
    return funcs


def read() -> Dict[str, int]:
    """Every counter's value, by kernel name."""
    return {name: f.launches for name, f in wrappers().items()}


def moved(before: Dict[str, int]) -> Dict[str, int]:
    """How far each counter moved since ``before`` (``read()``); counters
    that did not move are left out."""
    now = read()
    return {k: now[k] - v for k, v in before.items() if now[k] != v}


def in_graph(graph: int) -> Dict[str, int]:
    """The launches of each kernel that a captured CUDA graph holds
    (``graph``: ``torch.cuda.CUDAGraph.raw_cuda_graph()``), counted from its
    kernel nodes by each library; kernels it does not launch are left out.
    A library not loaded in this process launched nothing, and is not
    asked."""
    from smore_tpu_torch.ops._build import loaded_lib

    out = {}
    for name, prefix in _PREFIX.items():
        lib = loaded_lib(name)
        if lib is None:
            continue
        count_nodes = getattr(lib, f"{prefix}_graph_launches")
        count_nodes.restype = ctypes.c_int
        count_nodes.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_longlong)]
        n = ctypes.c_longlong(0)
        rc = count_nodes(graph, ctypes.byref(n))
        if rc:
            err = getattr(lib, f"{prefix}_error_string")
            err.restype, err.argtypes = ctypes.c_char_p, [ctypes.c_int]
            raise RuntimeError(f"reading the captured graph's {name} nodes "
                               f"failed: {err(rc).decode()}")
        if n.value:
            out[name] = n.value
    return out


def node_count(graph: int) -> int:
    """Every node of a captured CUDA graph (``graph``:
    ``torch.cuda.CUDAGraph.raw_cuda_graph()``, a ``CUgraph`` to the driver),
    as the driver's ``cuGraphGetNodes`` counts them."""
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.restype = ctypes.c_int
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    n = ctypes.c_size_t(0)
    rc = lib.cuGraphGetNodes(graph, None, ctypes.byref(n))
    if rc:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {rc}")
    return n.value


def recorded(before: Dict[str, int], nodes: Dict[str, int]) -> Credit:
    """After a capture: the counters' moves since ``before`` (``read()``)
    are taken back, since nothing ran, and must equal the launches the
    graph holds, ``nodes`` (``in_graph``); returns the credit of one
    replay for ``credit``."""
    seen = moved(before)
    credit([(wrappers()[k], -n) for k, n in seen.items()])
    if seen != nodes:
        raise RuntimeError(
            f"the captured graph holds the launches {nodes}, but the "
            f"wrappers launched {seen} while it was captured")
    return [(wrappers()[k], n) for k, n in nodes.items()]


def credit(launched: Credit) -> None:
    """Add each ``(wrapper, n)``'s n to that wrapper's counter."""
    for f, n in launched:
        f.launches += n
