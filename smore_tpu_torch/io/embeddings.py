"""Embedding text IO in the reference interchange format.

Port of ``smore_tpu/io/embeddings.py`` (``save_embeddings``,
``load_embeddings``, ``warm_start``); the text is byte-equal to the JAX
package's::

    N dim
    name v1 v2 ... vdim

with 6 significant digits per value.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def save_embeddings(path: str, names: Sequence[str], table: np.ndarray) -> None:
    table = np.asarray(table)
    n, dim = table.shape
    if n != len(names):
        raise ValueError(f"{n} rows vs {len(names)} names")
    from smore_tpu_torch.native import fastgraph

    # the native writer formats float32 only; a float64 table keeps its
    # digits through the Python writer
    if table.dtype == np.float32 and fastgraph.available():
        fastgraph.save_embeddings(path, names, table)
        return
    with open(path, "w") as f:
        f.write(f"{n} {dim}\n")
        for name, row in zip(names, table):
            f.write(name)
            f.write(" ")
            f.write(" ".join(f"{v:.6g}" for v in row))
            f.write("\n")


def load_embeddings(path: str) -> Dict[str, np.ndarray]:
    """Parse a saved embedding file into name -> float32 vector; rows whose
    length differs from the header's dim are skipped."""
    out: Dict[str, np.ndarray] = {}
    with open(path, "r") as f:
        header = f.readline().split()
        dim = int(header[1]) if len(header) >= 2 else -1
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            vec = np.array([float(x) for x in parts[1:]], dtype=np.float32)
            if dim > 0 and len(vec) != dim:
                continue
            out[parts[0]] = vec
    return out


def warm_start(table: np.ndarray, names: Sequence[str],
               pretrain_path: str) -> np.ndarray:
    """A copy of ``table`` with rows overwritten by name from a saved
    embedding file (the reference's LoadPreTrain); rows of another length
    are skipped. float32 tables go through the native reader when it
    builds; the Python reader keeps a float64 table's precision."""
    from smore_tpu_torch.native import fastgraph

    if np.asarray(table).dtype == np.float32 and fastgraph.available():
        return fastgraph.warm_start(table, names, pretrain_path)
    loaded = load_embeddings(pretrain_path)
    table = np.array(table, copy=True)
    dim = table.shape[1]
    for i, name in enumerate(names):
        vec = loaded.get(name)
        if vec is not None and len(vec) == dim:
            table[i] = vec
    return table
