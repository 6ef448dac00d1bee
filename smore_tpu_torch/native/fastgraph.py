"""ctypes bindings to the native host layer (edge-list parsing, alias
builds, embedding text dump, warm start).

Port of ``smore_tpu/native/fastgraph.py``. The C++ source is this
package's own copy of the JAX package's framework-free loader,
``smore_tpu_torch/csrc/fastgraph.cpp`` (code unchanged), compiled with
``g++`` at first use into this package's build directory
(``ops/_build.build_dir()``). Same compiler flags as the JAX package, so
the alias tables and the text dump are bit-equal to its.

``available()`` is False when the source or ``g++`` is missing; callers
then take their pure-Python paths, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from typing import List, Optional, Tuple

import numpy as np

from smore_tpu_torch.ops._build import build_dir

_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "csrc", "fastgraph.cpp",
)
_lib = None
_tried = False
_lock = threading.Lock()


def _so_path() -> str:
    return os.path.join(build_dir(), "libfastgraph.so")


def _build(so: str) -> None:
    # temp path + rename: concurrent test workers never dlopen a half-written
    # library
    tmp = f"{so}.build.{os.getpid()}"
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-o", tmp, _SRC],
            check=True, capture_output=True, timeout=300,
        )
        os.replace(tmp, so)
    except (OSError, subprocess.SubprocessError) as e:
        err = getattr(e, "stderr", b"") or b""
        print("smore_tpu_torch: native fastgraph build failed; using "
              f"pure-Python paths.\n{err.decode(errors='replace')[-2000:]}",
              file=sys.stderr)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _bind(lib: ctypes.CDLL) -> None:
    ptr = np.ctypeslib.ndpointer
    lib.fg_load_edgelist.restype = ctypes.c_void_p
    lib.fg_load_edgelist.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_int]
    for fn in (lib.fg_n_vertices, lib.fg_n_edges, lib.fg_names_size):
        fn.restype = ctypes.c_longlong
        fn.argtypes = [ctypes.c_void_p]
    lib.fg_export.restype = None
    lib.fg_export.argtypes = [
        ctypes.c_void_p, ptr(np.int64), ptr(np.int32), ptr(np.float64),
        ptr(np.float64), ptr(np.float64), ctypes.c_char_p,
    ]
    lib.fg_free.restype = None
    lib.fg_free.argtypes = [ctypes.c_void_p]
    lib.fg_build_alias.restype = None
    lib.fg_build_alias.argtypes = [ptr(np.float64), ctypes.c_longlong,
                                   ptr(np.float64), ptr(np.int64)]
    lib.fg_build_alias_segmented.restype = None
    lib.fg_build_alias_segmented.argtypes = [
        ptr(np.float64), ptr(np.int64), ctypes.c_longlong, ctypes.c_double,
        ptr(np.float64), ptr(np.int64),
    ]
    lib.fg_save_embeddings.restype = ctypes.c_int
    lib.fg_save_embeddings.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ptr(np.float32),
        ctypes.c_longlong, ctypes.c_longlong,
    ]
    lib.fg_warm_start.restype = ctypes.c_longlong
    lib.fg_warm_start.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_longlong,
        ctypes.c_longlong, ptr(np.float32),  # table, modified in place
    ]


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SRC):
            return None
        so = _so_path()
        if (not os.path.exists(so)
                or os.path.getmtime(so) < os.path.getmtime(_SRC)):
            _build(so)
        if not os.path.exists(so):
            return None
        lib = ctypes.CDLL(so)
        _bind(lib)
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_alias(norm_prob: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vose build over probabilities already scaled to mean 1."""
    n = len(norm_prob)
    prob = np.empty(n, dtype=np.float64)
    alias = np.empty(n, dtype=np.int64)
    buf = np.ascontiguousarray(norm_prob, dtype=np.float64).copy()
    _load().fg_build_alias(buf, n, prob, alias)
    return prob, alias


def build_alias_segmented(
    weights: np.ndarray, indptr: np.ndarray, power: float
) -> Tuple[np.ndarray, np.ndarray]:
    n = len(weights)
    prob = np.empty(n, dtype=np.float64)
    alias = np.empty(n, dtype=np.int64)
    _load().fg_build_alias_segmented(
        np.ascontiguousarray(weights, dtype=np.float64),
        np.ascontiguousarray(indptr, dtype=np.int64),
        len(indptr) - 1, float(power), prob, alias,
    )
    return prob, alias


def _names_blob(names) -> bytes:
    return b"\x00".join(s.encode() for s in names) + b"\x00"


def save_embeddings(path: str, names, table: np.ndarray) -> None:
    """Native writer of the ``N dim`` / ``name v...`` text format (%.6g)."""
    t = np.ascontiguousarray(table, dtype=np.float32)
    n, dim = t.shape
    rc = _load().fg_save_embeddings(path.encode(), _names_blob(names), t,
                                    n, dim)
    if rc != 0:
        raise OSError(f"fg_save_embeddings failed for {path}")


def warm_start(table: np.ndarray, names, pretrain_path: str) -> np.ndarray:
    """Native LoadPreTrain: a float32 copy of ``table`` with every row whose
    name has a line of the right length in the file overwritten by it."""
    t = np.array(table, dtype=np.float32, copy=True, order="C")
    n, dim = t.shape
    matched = _load().fg_warm_start(pretrain_path.encode(), _names_blob(names),
                                    n, dim, t)
    if matched < 0:
        raise OSError(f"cannot open pretrain file {pretrain_path}")
    return t


def load_edge_list(files: List[str], undirected: bool):
    """Parse edge-list files with the native tokenizer + interner."""
    from smore_tpu_torch.graph.graph import Graph

    lib = _load()
    handle = lib.fg_load_edgelist("\n".join(files).encode(),
                                  1 if undirected else 0, 0)
    if not handle:
        raise RuntimeError("no input files")
    try:
        n = lib.fg_n_vertices(handle)
        e = lib.fg_n_edges(handle)
        nb = lib.fg_names_size(handle)
        indptr = np.empty(n + 1, dtype=np.int64)
        indices = np.empty(e, dtype=np.int32)
        weights = np.empty(e, dtype=np.float64)
        out_deg = np.empty(n, dtype=np.float64)
        in_deg = np.empty(n, dtype=np.float64)
        names_buf = ctypes.create_string_buffer(nb)
        lib.fg_export(handle, indptr, indices, weights, out_deg, in_deg,
                      names_buf)
        names = names_buf.raw[: nb - 1].decode().split("\x00") if nb > 1 else []
        return Graph(
            indptr=indptr, indices=indices, weights=weights, names=names,
            name2id={s: i for i, s in enumerate(names)},
            out_degree=out_deg, in_degree=in_deg,
        )
    finally:
        lib.fg_free(handle)
