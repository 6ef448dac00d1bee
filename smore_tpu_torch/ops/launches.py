"""How the port binds, launches, checks and counts its hand-written kernel
libraries (``csrc/<name>.cu``), and the launches a captured CUDA graph
holds.

Each launcher module declares its library once, at module level, as a
``Kernel``: its name (the file's), the C signature of its launcher as
ctypes passes it, and its helpers. The ``Kernel`` builds and binds the
library at first use, and its ``launch`` passes the device index and the
current stream, raises with the library's own error string on a nonzero
return, and otherwise adds one to its ``launches``. Every library exports
``<name>_error_string`` and ``<name>_graph_launches`` (the macro of
``csrc/graph_nodes.cuh``).

A CUDA graph replays its kernels without running the launchers' Python,
so ``TrainDriver`` reads, from the captured graph's own nodes, how many
launches of each kernel it holds (``in_graph``), holds that to how far
each counter moved while the call was captured, takes the capture's count
back (nothing ran) and credits the graph's on every replay (``recorded``,
``credit``): the counters count launches the card ran. ``read``,
``moved``, ``in_graph`` and ``recorded`` see the counted kernels declared
so far; ``declared`` first imports every module that may declare one.
"""

from __future__ import annotations

import ctypes
import importlib
import pkgutil
from typing import Dict, List, Optional, Tuple

import torch

_P, _I = ctypes.c_void_p, ctypes.c_int
# each library's own exports, beside its launcher and helpers
_EXPORTS = {"error_string": (ctypes.c_char_p, [_I]),
            "graph_launches": (_I, [_P, ctypes.POINTER(ctypes.c_longlong)])}
# the packages whose modules declare the port's kernels
_PACKAGES = ("smore_tpu_torch.ops", "smore_tpu_torch.utils")

_kernels: Dict[str, "Kernel"] = {}

Credit = List[Tuple["Kernel", int]]


class Kernel:
    """The library ``csrc/<name>.cu``. ``argtypes`` is its launcher's C
    signature as ctypes passes it (pointers and the stream as c_void_p):
    the device index first and the stream last. The launcher is
    ``<name>_launch`` unless ``symbol`` names another; ``helpers`` maps
    each further export ``<name>_<helper>`` to its (restype, argtypes).
    ``counted``: whether ``launches`` counts its launches and the graph
    queries credit them (the tracer's stamps are not kernel launches)."""

    def __init__(self, name: str, argtypes: list,
                 helpers: Optional[dict] = None, counted: bool = True,
                 symbol: Optional[str] = None):
        if name in _kernels:
            raise ValueError(f"kernel library {name} is declared twice")
        self.name, self.argtypes, self.counted = name, argtypes, counted
        self.symbol = symbol or f"{name}_launch"
        self.helpers = {**_EXPORTS, **(helpers or {})}
        self.launches = 0
        self._lib = None
        self._launch = None
        _kernels[name] = self

    def load(self) -> ctypes.CDLL:
        """The library, built (``ops._build``) and bound at first use."""
        if self._lib is None:
            from smore_tpu_torch.ops._build import load_kernel_lib

            lib = load_kernel_lib(self.name)
            sigs = {f"{self.name}_{h}": s for h, s in self.helpers.items()}
            sigs[self.symbol] = (_I, self.argtypes)
            for symbol, (restype, argtypes) in sigs.items():
                fn = getattr(lib, symbol)
                fn.restype, fn.argtypes = restype, argtypes
            self._launch = getattr(lib, self.symbol)
            self._lib = lib
        return self._lib

    def call(self, helper: str, *args):
        """``<name>_<helper>(*args)``."""
        return getattr(self.load(), f"{self.name}_{helper}")(*args)

    def check(self, rc: int, what: str = "launch") -> None:
        """Raise on a nonzero cudaError_t ``rc``, with the library's
        string for it."""
        if rc:
            raise RuntimeError(
                f"{self.name} {what} failed: CUDA error {rc} "
                f"({self.call('error_string', rc).decode()})")

    def launch(self, device: torch.device, *args) -> None:
        """One launch on ``device``'s current stream: the launcher takes
        ``device``'s index, ``args`` and the stream. A failed launch raises
        and is not counted."""
        self.load()
        self.check(self._launch(device_index(device), *args,
                                torch.cuda.current_stream(device).cuda_stream))
        if self.counted:
            self.launches += 1


def declared() -> Dict[str, Kernel]:
    """Every kernel the port declares, by library name: every module of
    the packages that declare them is imported first."""
    for pkg in _PACKAGES:
        path = importlib.import_module(pkg).__path__
        for mod in pkgutil.iter_modules(path):
            importlib.import_module(f"{pkg}.{mod.name}")
    return dict(_kernels)


def device_index(dev: torch.device) -> int:
    """``dev``'s index, or the current card's where it names none."""
    return dev.index if dev.index is not None else torch.cuda.current_device()


def aligned(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """``t`` contiguous at an address of ``nbytes``' alignment, a kernel's
    vector loads' (a contiguous view may start inside its storage)."""
    t = t.contiguous()
    return t if t.data_ptr() % nbytes == 0 else t.clone()


def check_aligned(*tables) -> None:
    """Tables a kernel updates in place, so cannot copy: they must start
    on 16 bytes, where it moves their rows as 16-byte vectors."""
    for t in tables:
        if t.data_ptr() % 16:
            raise ValueError("tables must start on a 16-byte boundary")


def _counted() -> Dict[str, Kernel]:
    return {name: k for name, k in _kernels.items() if k.counted}


def read() -> Dict[str, int]:
    """Every counter's value, by kernel name."""
    return {name: k.launches for name, k in _counted().items()}


def moved(before: Dict[str, int]) -> Dict[str, int]:
    """How far each counter moved since ``before`` (``read()``); a kernel
    declared since counts from 0, and counters that did not move are left
    out."""
    now = read()
    return {k: n - before.get(k, 0) for k, n in now.items()
            if n != before.get(k, 0)}


def in_graph(graph: int) -> Dict[str, int]:
    """The launches of each kernel that a captured CUDA graph holds
    (``graph``: ``torch.cuda.CUDAGraph.raw_cuda_graph()``), counted from its
    kernel nodes by each library; kernels it does not launch are left out.
    A library not loaded in this process launched nothing, and is not
    asked."""
    out = {}
    for name, k in _counted().items():
        if k._lib is None:
            continue
        n = ctypes.c_longlong(0)
        k.check(k.call("graph_launches", graph, ctypes.byref(n)),
                "count of the captured graph's nodes")
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
    credit([(_kernels[k], -n) for k, n in seen.items()])
    if seen != nodes:
        raise RuntimeError(
            f"the captured graph holds the launches {nodes}, but the "
            f"kernels launched {seen} while it was captured")
    return [(_kernels[k], n) for k, n in nodes.items()]


def credit(launched: Credit) -> None:
    """Add each ``(kernel, n)``'s n to that kernel's counter."""
    for k, n in launched:
        k.launches += n
