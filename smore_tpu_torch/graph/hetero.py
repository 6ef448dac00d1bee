"""Heterogeneous (typed-node) graph store and batched metapath walks.

Port of ``smore_tpu/graph/hetero.py``. The store is host numpy and
bit-equal to the JAX package's: file format ``src srcType dst dstType
edgeType [weight]``, per-node neighbour lists by type, neighbours sorted
by (src, dst type) into one flat array with (node, type) segments
addressed by a (N*T+1,) indptr, so that a typed-neighbour draw is one
uniform inside the segment. ``HeteroTables`` holds its arrays on the
device; ``metapath_walk`` follows the type sequence cyclically and stops on
a type mismatch or a missing typed neighbour (the reference's
MetaPathWalk). JAX's ``lax.scan`` over the steps is a Python loop over
steps on whole-batch tensors here; given the same uniforms the walks are
the JAX package's bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


@dataclass
class HeteroGraph:
    names: List[str]
    name2id: Dict[str, int]
    types: List[str]
    type2id: Dict[str, int]
    node_type: np.ndarray  # (N,) int32
    nbr_indptr: np.ndarray  # (N*T+1,) int64 -- segment (node*T + type)
    nbr_flat: np.ndarray  # (E,) int32 neighbors sorted by (src, type)

    @property
    def n_vertices(self) -> int:
        return len(self.names)

    @property
    def n_types(self) -> int:
        return len(self.types)

    def nodes_of_type(self, t: str) -> np.ndarray:
        tid = self.type2id[t]
        return np.nonzero(self.node_type == tid)[0]

    def neighbors_by_type(self, vid: int, t: str) -> np.ndarray:
        """Neighbors of ``vid`` whose node type is ``t`` (hetero_graph.go:169-182).
        Unknown type names yield an empty array (reference map-miss semantics)."""
        tid = self.type2id.get(t)
        if tid is None:
            return self.nbr_flat[:0]
        seg = vid * self.n_types + tid
        return self.nbr_flat[self.nbr_indptr[seg]:self.nbr_indptr[seg + 1]]

    def neighbor_count(self, vid: int, t: str) -> int:
        """Count of typed neighbors (hetero_graph.go GetNeighborCount);
        0 for a type name not present in the graph."""
        tid = self.type2id.get(t)
        if tid is None:
            return 0
        seg = vid * self.n_types + tid
        return int(self.nbr_indptr[seg + 1] - self.nbr_indptr[seg])

    def validate_meta_path(self, meta_path: List[str]) -> None:
        """Raise ValueError on an invalid metapath: fewer than 2 types, or a
        type name unknown to the graph (hetero_graph.go:260-272)."""
        if len(meta_path) < 2:
            raise ValueError("meta-path must have at least 2 types")
        for t in meta_path:
            if t not in self.type2id:
                raise ValueError(f"unknown node type in meta-path: {t}")

    @staticmethod
    def load_edge_list(path: str, undirected: bool = True) -> "HeteroGraph":
        name2id: Dict[str, int] = {}
        names: List[str] = []
        type2id: Dict[str, int] = {}
        types: List[str] = []
        ntype: List[int] = []
        src_l, dst_l = [], []

        def intern_type(s):
            i = type2id.get(s)
            if i is None:
                i = len(types)
                type2id[s] = i
                types.append(s)
            return i

        def intern(nm, tp):
            i = name2id.get(nm)
            if i is None:
                i = len(names)
                name2id[nm] = i
                names.append(nm)
                ntype.append(intern_type(tp))
            return i

        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 5:
                    continue
                a = intern(parts[0], parts[1])
                b = intern(parts[2], parts[3])
                src_l.append(a)
                dst_l.append(b)
                if undirected:
                    src_l.append(b)
                    dst_l.append(a)

        n, t = len(names), len(types)
        node_type = np.asarray(ntype, dtype=np.int32)
        src = np.asarray(src_l, dtype=np.int64)
        dst = np.asarray(dst_l, dtype=np.int64)
        seg = src * t + node_type[dst]
        order = np.argsort(seg, kind="stable")
        seg_s, dst_s = seg[order], dst[order]
        indptr = np.searchsorted(seg_s, np.arange(n * t + 1)).astype(np.int64)
        return HeteroGraph(
            names=names,
            name2id=name2id,
            types=types,
            type2id=type2id,
            node_type=node_type,
            nbr_indptr=indptr,
            nbr_flat=dst_s.astype(np.int32),
        )


class HeteroTables:
    """The device arrays of a HeteroGraph: node_type (N,) int32,
    nbr_indptr (N*T+1,) int32, nbr_flat (E,) int32."""

    def __init__(self, node_type: torch.Tensor, nbr_indptr: torch.Tensor,
                 nbr_flat: torch.Tensor, n_types: int):
        self.node_type = node_type
        self.nbr_indptr = nbr_indptr
        self.nbr_flat = nbr_flat
        self.n_types = n_types

    @property
    def device(self) -> torch.device:
        return self.node_type.device

    @staticmethod
    def build(hg: HeteroGraph,
              device: torch.device | str = "cuda") -> "HeteroTables":
        def dev(a):
            return torch.from_numpy(np.asarray(a, dtype=np.int32)).to(device)

        return HeteroTables(dev(hg.node_type), dev(hg.nbr_indptr),
                            dev(hg.nbr_flat), hg.n_types)

    def typed_neighbor(self, u: torch.Tensor, vids: torch.Tensor,
                       ttypes: torch.Tensor):
        """A uniform neighbour of type ttypes[i] for each vids[i], given
        the (B,) uniforms ``u``; returns (nbr, ok)."""
        seg = vids * self.n_types + ttypes
        lo = self.nbr_indptr[seg]
        size = self.nbr_indptr[seg + 1] - lo
        ok = size > 0
        slot = lo + torch.minimum((u * torch.clamp(size, min=1)).to(
            torch.int32), torch.clamp(size - 1, min=0))
        # an empty segment past the last edge points one past the end: its
        # read is discarded (ok is False)
        slot = torch.clamp(slot, max=self.nbr_flat.shape[0] - 1)
        return self.nbr_flat[slot], ok

    def metapath_walk(
        self,
        gen: Optional[torch.Generator],
        starts: torch.Tensor,  # (B,)
        path_types: torch.Tensor,  # (P, Lmax) int32 type ids, padded
        path_lens: torch.Tensor,  # (P,) int32
        path_idx: torch.Tensor,  # (B,) which metapath each walk follows
        steps: int,
        u: Optional[torch.Tensor] = None,  # (steps, B)
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched MetaPathWalk. Returns (walk (B, steps+1) int32, valid
        (B, steps+1) float32)."""
        B = starts.shape[0]
        if u is None:
            u = torch.rand((steps, B), generator=gen, device=self.device)
        plen = path_lens[path_idx].to(torch.int64)
        # the walk dies at once if the start's type is not path[0]
        alive = self.node_type[starts] == path_types[path_idx, 0]
        # the type each step moves to: path[(s + 1) % len], all steps at once
        step_no = torch.arange(1, steps + 1, device=self.device)[:, None]
        next_t = path_types[path_idx[None, :].to(torch.int64),
                            step_no % plen[None, :]]  # (steps, B)
        cur = starts
        walk, valid = [starts], [alive]
        for s in range(steps):
            nbr, ok = self.typed_neighbor(u[s], cur, next_t[s])
            alive = ok & alive
            cur = torch.where(alive, nbr, cur)
            walk.append(cur)
            valid.append(alive)
        return (torch.stack(walk, dim=1),
                torch.stack(valid, dim=1).to(torch.float32))
