"""Temporal graph store and batched time-increasing walks.

Port of ``smore_tpu/graph/temporal.py``. The store is host numpy and
bit-equal to the JAX package's: ``src dst timestamp`` lines, out-edges
flattened to (indptr, dst, ts) with per-node timestamp-sorted segments.
The reference's TemporalRandomWalk picks each step UNIFORMLY among the
out-edges with timestamp in (t_cur, t_cur + time_window] and advances
t_cur to the chosen edge's timestamp; the walk stops when no edge
qualifies. The in-window range [lo, hi) is found by the JAX package's
fixed-iteration right bisection (``val <= t``, so ties at equal
timestamps pick the same slot), both ends in one loop; the draw is one
uniform. JAX's ``lax.scan`` over the steps is a Python loop here; given
the same uniforms the walks are the JAX package's bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


@dataclass
class TemporalGraph:
    names: List[str]
    name2id: Dict[str, int]
    indptr: np.ndarray  # (N+1,)
    edge_dst: np.ndarray  # (E,) sorted by (src, ts)
    edge_ts: np.ndarray  # (E,)
    active_min: np.ndarray  # (N,) min ts over in+out edges
    active_max: np.ndarray  # (N,)
    min_time: float
    max_time: float

    @property
    def n_vertices(self) -> int:
        return len(self.names)

    @property
    def n_edges(self) -> int:
        return len(self.edge_dst)

    def temporal_neighbors(self, vid: int, t0: float, t1: float) -> np.ndarray:
        """Out-neighbors of ``vid`` connected in [t0, t1] inclusive
        (temporal_graph.go GetTemporalNeighbors :181-195; edges are
        time-sorted per node, so this is two binary searches)."""
        lo, hi = self.indptr[vid], self.indptr[vid + 1]
        seg_ts = self.edge_ts[lo:hi]
        a = int(np.searchsorted(seg_ts, np.float32(t0), side="left"))
        b = int(np.searchsorted(seg_ts, np.float32(t1), side="right"))
        return self.edge_dst[lo + a:lo + b]

    def sample_temporal_neighbor(
        self, vid: int, t0: float, t1: float, rng: np.random.Generator
    ) -> Tuple[int, float]:
        """Uniform draw among in-window out-edges; (-1, 0.0) when none
        qualify (temporal_graph.go SampleTemporalNeighbor :198-210)."""
        lo, hi = self.indptr[vid], self.indptr[vid + 1]
        seg_ts = self.edge_ts[lo:hi]
        a = int(np.searchsorted(seg_ts, np.float32(t0), side="left"))
        b = int(np.searchsorted(seg_ts, np.float32(t1), side="right"))
        if b <= a:
            return -1, 0.0
        j = lo + a + int(rng.integers(0, b - a))
        return int(self.edge_dst[j]), float(self.edge_ts[j])

    @staticmethod
    def load_edge_list(path: str) -> "TemporalGraph":
        name2id: Dict[str, int] = {}
        names: List[str] = []
        src_l, dst_l, ts_l = [], [], []

        def intern(s):
            i = name2id.get(s)
            if i is None:
                i = len(names)
                name2id[s] = i
                names.append(s)
            return i

        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 3:
                    continue
                try:
                    ts = float(parts[2])
                except ValueError:
                    continue
                src_l.append(intern(parts[0]))
                dst_l.append(intern(parts[1]))
                ts_l.append(ts)

        n = len(names)
        src = np.asarray(src_l, dtype=np.int64)
        dst = np.asarray(dst_l, dtype=np.int64)
        ts = np.asarray(ts_l, dtype=np.float64)
        order = np.lexsort((ts, src))
        src, dst, ts = src[order], dst[order], ts[order]
        counts = np.bincount(src, minlength=n)
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])

        amin = np.full(n, np.inf)
        amax = np.full(n, -np.inf)
        np.minimum.at(amin, src, ts)
        np.maximum.at(amax, src, ts)
        np.minimum.at(amin, dst, ts)
        np.maximum.at(amax, dst, ts)
        amin[~np.isfinite(amin)] = 0.0
        amax[~np.isfinite(amax)] = 0.0

        return TemporalGraph(
            names=names,
            name2id=name2id,
            indptr=indptr,
            edge_dst=dst.astype(np.int32),
            edge_ts=ts.astype(np.float32),
            active_min=amin.astype(np.float32),
            active_max=amax.astype(np.float32),
            min_time=float(ts.min()) if len(ts) else 0.0,
            max_time=float(ts.max()) if len(ts) else 0.0,
        )


class TemporalTables:
    """The device arrays of a TemporalGraph for temporal walks."""

    def __init__(self, indptr, edge_dst, edge_ts, active_min, active_max,
                 max_time: float, n_iters: int):
        self.indptr = indptr  # (N+1,) int32
        self.edge_dst = edge_dst  # (E,) int32
        self.edge_ts = edge_ts  # (E,) float32
        self.active_min = active_min  # (N,) float32
        self.active_max = active_max
        self.max_time = max_time  # a float32 value
        self.n_iters = n_iters

    @property
    def device(self) -> torch.device:
        return self.indptr.device

    @staticmethod
    def build(tg: TemporalGraph,
              device: torch.device | str = "cuda") -> "TemporalTables":
        max_deg = int(np.max(np.diff(tg.indptr))) if tg.n_vertices else 1
        n_iters = max(1, int(np.ceil(np.log2(max(max_deg, 2)))) + 1)

        def dev(a, dtype):
            return torch.from_numpy(np.asarray(a, dtype=dtype)).to(device)

        return TemporalTables(
            dev(tg.indptr, np.int32), dev(tg.edge_dst, np.int32),
            dev(tg.edge_ts, np.float32), dev(tg.active_min, np.float32),
            dev(tg.active_max, np.float32), float(np.float32(tg.max_time)),
            n_iters)

    def _seg_searchsorted(self, lo, hi, t):
        """First index in [lo, hi) with edge_ts > t (right bisect), by
        n_iters fixed iterations."""
        last = self.edge_ts.shape[0] - 1
        for _ in range(self.n_iters):
            mid = (lo + hi) // 2
            val = self.edge_ts[torch.clamp(mid, max=last)]
            go_right = (val <= t) & (mid < hi)
            lo = torch.where(go_right, mid + 1, lo)
            hi = torch.where(go_right, hi, mid)
        return lo

    def temporal_walk(
        self,
        gen: Optional[torch.Generator],
        starts: torch.Tensor,  # (B,)
        start_times: torch.Tensor,  # (B,)
        steps: int,
        time_window: float,
        u: Optional[torch.Tensor] = None,  # (steps, B)
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched TemporalRandomWalk. Returns (walk (B, steps+1) int32,
        valid (B, steps+1) float32, 1 while the walk is alive)."""
        B = starts.shape[0]
        if u is None:
            u = torch.rand((steps, B), generator=gen, device=self.device)
        last = self.edge_ts.shape[0] - 1
        cur, t = starts, start_times
        alive = torch.ones(B, dtype=torch.bool, device=self.device)
        walk, valid = [starts], [alive]
        for s in range(steps):
            lo0 = self.indptr[cur]
            hi0 = self.indptr[cur + 1]
            end = torch.clamp(t + time_window, max=self.max_time)
            # both ends of the window in one bisection of 2B rows
            both = self._seg_searchsorted(torch.cat([lo0, lo0]),
                                          torch.cat([hi0, hi0]),
                                          torch.cat([t, end]))
            lo, hi = both[:B], both[B:]
            size = hi - lo
            alive = (size > 0) & alive
            slot = lo + torch.minimum((u[s] * torch.clamp(size, min=1)).to(
                torch.int32), torch.clamp(size - 1, min=0))
            # a dead row's slot may point past the end: its read is discarded
            slot = torch.clamp(slot, max=last)
            cur = torch.where(alive, self.edge_dst[slot], cur)
            t = torch.where(alive, self.edge_ts[slot], t)
            walk.append(cur)
            valid.append(alive)
        return (torch.stack(walk, dim=1),
                torch.stack(valid, dim=1).to(torch.float32))
