"""Host-side weighted-graph store: CSR + string interning + loaders.

Port of ``smore_tpu/graph/graph.py`` (``from_arrays``, ``from_edges``,
``load_edge_list`` with its native and pure-Python loaders, the per-vertex
accessors ``branch``, ``neighbors`` and ``neighbor_weights``, and the
metadata loaders ``load_field_meta`` and ``load_walk_meta``). The store is
host numpy and bit-equal to the JAX package's: the device never sees it,
only the sampler tables built from it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from smore_tpu_torch.utils import profiling


def _iter_edge_files(path: str) -> List[str]:
    """An input path may be a single file or a directory of files."""
    if os.path.isdir(path):
        return sorted(
            os.path.join(path, f)
            for f in os.listdir(path)
            if os.path.isfile(os.path.join(path, f))
        )
    return [path]


def _parse_edges(files: List[str]) -> Iterator[Tuple[str, str, float]]:
    """(src, dst, weight) of every well-formed line of the files."""
    for fname in files:
        with open(fname, "r") as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                try:
                    w = float(parts[2]) if len(parts) >= 3 else 1.0
                except ValueError:
                    w = None
                if len(parts) < 2 or w is None:
                    print(f"[smore-tpu] skipping malformed line: {line!r}")
                    continue
                yield parts[0], parts[1], w


@dataclass
class Graph:
    """Immutable weighted directed graph in CSR form.

    indptr (N+1,) int64 row offsets; indices (E,) int32 destination vids;
    weights (E,) float64; names / name2id the vertex interning (vids in
    first-appearance order); out_degree / in_degree (N,) float64 weighted
    degrees. Optional metadata: ``fields`` (N,) int32 field ids with
    ``n_fields`` and ``field_names`` (``load_field_meta``), ``walk_steps``
    (N,) int32 per-vertex walk lengths (``load_walk_meta``).
    """

    indptr: np.ndarray
    indices: np.ndarray
    weights: np.ndarray
    names: List[str]
    name2id: Dict[str, int]
    out_degree: np.ndarray
    in_degree: np.ndarray
    fields: Optional[np.ndarray] = None
    n_fields: int = 1
    walk_steps: Optional[np.ndarray] = None
    field_names: List[str] = field(default_factory=list)

    @property
    def n_vertices(self) -> int:
        return len(self.indptr) - 1

    @property
    def n_edges(self) -> int:
        return len(self.indices)

    def branch(self, vid: int) -> int:
        return int(self.indptr[vid + 1] - self.indptr[vid])

    def neighbors(self, vid: int) -> np.ndarray:
        return self.indices[self.indptr[vid]:self.indptr[vid + 1]]

    def neighbor_weights(self, vid: int) -> np.ndarray:
        return self.weights[self.indptr[vid]:self.indptr[vid + 1]]

    @staticmethod
    @profiling.spanned("graph.from_arrays")
    def from_arrays(
        src: np.ndarray,
        dst: np.ndarray,
        w: np.ndarray,
        names: List[str],
        name2id: Dict[str, int],
    ) -> "Graph":
        """Build CSR from parallel edge arrays (vids already interned).
        Duplicate edges are kept: they add sampling mass, as in the
        reference."""
        n = len(names)
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        w = np.asarray(w, dtype=np.float64)
        order = np.argsort(src, kind="stable")
        src_s, dst_s, w_s = src[order], dst[order], w[order]
        counts = np.bincount(src_s, minlength=n)
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return Graph(
            indptr=indptr,
            indices=dst_s.astype(np.int32),
            weights=w_s,
            names=names,
            name2id=name2id,
            out_degree=np.bincount(src, weights=w, minlength=n),
            in_degree=np.bincount(dst, weights=w, minlength=n),
        )

    @staticmethod
    def from_edges(
        edges: Iterable[Tuple[str, str, float]], undirected: bool = True
    ) -> "Graph":
        """Build from (src_name, dst_name, weight) tuples."""
        name2id: Dict[str, int] = {}
        names: List[str] = []
        src_l: List[int] = []
        dst_l: List[int] = []
        w_l: List[float] = []

        def intern(s: str) -> int:
            i = name2id.get(s)
            if i is None:
                i = len(names)
                name2id[s] = i
                names.append(s)
            return i

        for a, b, w in edges:
            ia, ib = intern(a), intern(b)
            src_l.append(ia)
            dst_l.append(ib)
            w_l.append(w)
            if undirected:
                src_l.append(ib)
                dst_l.append(ia)
                w_l.append(w)
        return Graph.from_arrays(
            np.array(src_l, dtype=np.int64),
            np.array(dst_l, dtype=np.int64),
            np.array(w_l, dtype=np.float64),
            names,
            name2id,
        )

    @staticmethod
    def load_edge_list(
        path: str, undirected: bool = True, use_native: bool = True
    ) -> "Graph":
        """Load ``src dst [weight]`` text file(s): whitespace-split, weight
        1.0 when missing, undirected doubles every edge, malformed lines
        skipped. Uses the native parser when it builds, else Python."""
        files = _iter_edge_files(path)
        if use_native:
            from smore_tpu_torch.native import fastgraph

            if fastgraph.available():
                return fastgraph.load_edge_list(files, undirected)
        return Graph._load_edge_list_py(files, undirected)

    @staticmethod
    def _load_edge_list_py(files: List[str], undirected: bool) -> "Graph":
        return Graph.from_edges(_parse_edges(files), undirected)

    def _meta_lines(self, path: str) -> Iterator[Tuple[int, str]]:
        """(vid, second token) of every line of the file(s) at ``path``
        whose first token names a vertex; lines of fewer than two tokens
        and unknown names are skipped."""
        for fname in _iter_edge_files(path):
            with open(fname, "r") as f:
                for line in f:
                    parts = line.split()
                    if len(parts) < 2:
                        continue
                    vid = self.name2id.get(parts[0])
                    if vid is not None:
                        yield vid, parts[1]

    def load_field_meta(self, path: str) -> None:
        """``vertex field`` file(s) -> per-vertex field id (int32, 0 for a
        vertex the file does not name), ids in first-appearance order of
        the field names (reference LoadFieldMeta)."""
        fields = np.zeros(self.n_vertices, dtype=np.int32)
        fnames: Dict[str, int] = {}
        for vid, name in self._meta_lines(path):
            fields[vid] = fnames.setdefault(name, len(fnames))
        self.fields = fields
        self.n_fields = max(1, len(fnames))
        self.field_names = sorted(fnames, key=fnames.get)

    def load_walk_meta(self, path: str, default_steps: int = 3) -> None:
        """``vertex steps`` file(s) -> per-vertex walk length (int32);
        vertices the file does not name keep ``default_steps`` (the
        reference's 3), and a step count that is not an integer is
        skipped (reference LoadWalkMeta)."""
        steps = np.full(self.n_vertices, default_steps, dtype=np.int32)
        for vid, value in self._meta_lines(path):
            try:
                steps[vid] = int(value)
            except ValueError:
                continue
        self.walk_steps = steps
