"""Batched walk generators on the tables' device.

Port of ``smore_tpu/sampling/walks.py``. The reference's walks:

- RandomWalk: a fixed-length walk; on a dead end the cursor goes back to
  the start vertex and walks on, so every walk has ``steps + 1`` entries.
  A walk whose start is itself a dead end stays there and is masked by
  ``row_mask``.
- JumpingRandomWalk: walk until a geometric coin (stop probability
  ``jump``) or a dead end. Here a fixed-length walk that does not restart
  (the cursor stays on a dead end, as ``target_sample`` returns it) and a
  geometric stop index per row; APP keeps only the start and the end.
- node2vec's second-order walk: the next vertex is weighted by edge weight
  times 1/p (back to the previous vertex), 1 (a neighbour of the previous
  vertex) or 1/q (otherwise), drawn by rejection: up to ``trials`` alias
  draws, each accepted with probability bias / max_bias, the last taken
  when all are rejected.

JAX's loop over the steps is, on a CUDA card, one launch of a hand-written
kernel for ``random_walk`` (``csrc/random_walk.cu``, one thread a walk)
and for ``node2vec_walk`` (``csrc/node2vec_walk.cu``, a warp a walk at
small batches, one thread a walk at large ones), every step in the
launch; on the CPU their plain twins ``random_walk_ref`` and
``node2vec_walk_ref``, a Python loop over steps, each step a few tensor ops
on the whole batch. Every function takes its
uniforms as optional arguments of the JAX draws' shapes and draws them
from ``gen`` when they are not given; given the same uniforms the walks are
the JAX package's bit for bit, except the stop index of
``jumping_walk_endpoints``, whose float32 logarithm may round the other way
where the quotient lies next to an integer. Walks come back as (B, L)
int32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from smore_tpu_torch.ops import node2vec_walk as n2v_kernel
from smore_tpu_torch.ops import random_walk as walk_kernel
from smore_tpu_torch.sampling.tables import SamplerTables


def random_walk_ref(
    tables: SamplerTables,
    starts: torch.Tensor,  # (B,) int32
    steps: int,
    u: torch.Tensor,  # (steps, B, 2)
    restart_on_deadend: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the kernel: the JAX scan as a loop over the
    steps, a few tensor ops on the whole batch each."""
    meta0 = tables.vert_meta[starts]
    row_mask = (meta0[..., 1] > 0).to(torch.float32)
    path = [starts]
    cur = starts
    for t in range(steps):
        meta = tables.vert_meta[cur]
        if restart_on_deadend:
            live = meta[..., 1] > 0
            cur = torch.where(live, cur, starts)
            meta = torch.where(live[..., None], meta, meta0)
        cur = tables._context_of(cur, meta, u[t])
        path.append(cur)
    return torch.stack(path, dim=1), row_mask


def random_walk(
    tables: SamplerTables,
    gen: Optional[torch.Generator],
    starts: torch.Tensor,  # (B,) int32
    steps: int,
    restart_on_deadend: bool = True,
    u: Optional[torch.Tensor] = None,  # (steps, B, 2)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched RandomWalk. Returns (walk (B, steps+1) int32, row_mask (B,)
    float32, 0 where the start vertex has no out-edges).

    The uniforms are drawn from ``gen`` in one call when not given. CPU
    tensors run ``random_walk_ref``; CUDA tensors launch the kernel
    (``csrc/random_walk.cu``) on the current stream, bit-equal to the twin
    given the same ``u``; any other device raises: nothing falls back.
    ``ops/random_walk.KERNEL.launches`` counts kernel launches. Vertex
    ids are not bounds-checked on the card."""
    dev = starts.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    if u is None:
        u = tables._uniform(gen, (steps,) + tuple(starts.shape) + (2,))
    if dev.type == "cuda":
        return walk_kernel.random_walk(starts, u, tables.vert_meta,
                                       tables.ctx_pa, restart_on_deadend)
    walk_kernel.check(starts, steps, u, tables.vert_meta, tables.ctx_pa)
    return random_walk_ref(tables, starts, steps, u, restart_on_deadend)


def jumping_walk_endpoints(
    tables: SamplerTables,
    gen: Optional[torch.Generator],
    starts: torch.Tensor,  # (B,) int32
    jump: float,
    max_steps: int = 64,
    u: Optional[torch.Tensor] = None,  # (max_steps, B, 2): the walk
    u_stop: Optional[torch.Tensor] = None,  # (B,): the stop index
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched JumpingRandomWalk reduced to what APP reads, the walk's end:
    (endpoints (B,), row_mask (B,))."""
    walk, row_mask = random_walk(tables, gen, starts, max_steps,
                                 restart_on_deadend=False, u=u)
    if u_stop is None:
        u_stop = tables._uniform(gen, starts.shape)
    # stop index 1 + Geometric(jump) continuations, clamped to max_steps
    # (the reference takes one step before it flips the coin)
    us = torch.clamp(u_stop, 1e-12, 1.0)
    cont = torch.floor(torch.log(us) / float(np.log(max(1.0 - jump, 1e-12))))
    t = torch.clamp(1 + cont.to(torch.int32), 1, max_steps)
    # a dead end holds the cursor, so walk[t] is the dead-end vertex where
    # the walk died before t (the reference's walk.back())
    return walk.gather(1, t[:, None].long())[:, 0], row_mask


class NeighborIndex:
    """Is ``b`` a neighbour of ``a``? A binary search of a fixed number of
    iterations over ``a``'s sorted slice of the adjacency, on the device
    (the reference scans the neighbour list).

    indptr (N+1,) int32, sorted_nbrs (E,) int32, n_iters the iterations
    that cover the largest degree."""

    def __init__(self, indptr: torch.Tensor, sorted_nbrs: torch.Tensor,
                 n_iters: int):
        self.indptr = indptr
        self.sorted_nbrs = sorted_nbrs
        self.n_iters = n_iters

    @staticmethod
    def build(graph, device: torch.device | str = "cuda") -> "NeighborIndex":
        indptr = np.asarray(graph.indptr, dtype=np.int64)
        row_id = np.repeat(np.arange(graph.n_vertices, dtype=np.int64),
                           np.diff(indptr))
        order = np.lexsort((graph.indices, row_id))  # sort within each row
        sorted_nbrs = np.asarray(graph.indices)[order]
        max_deg = int(np.max(np.diff(indptr))) if len(indptr) > 1 else 1
        n_iters = max(1, int(np.ceil(np.log2(max(max_deg, 2)))) + 1)
        return NeighborIndex(
            torch.from_numpy(indptr.astype(np.int32)).to(device),
            torch.from_numpy(sorted_nbrs.astype(np.int32)).to(device),
            n_iters,
        )

    def contains(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Elementwise: b in neighbours(a), as a bool tensor."""
        lo = self.indptr[a]
        hi = end = self.indptr[a + 1]
        last = self.sorted_nbrs.shape[0] - 1
        for _ in range(self.n_iters):
            mid = (lo + hi) // 2
            val = self.sorted_nbrs[torch.clamp(mid, max=last)]
            go_right = (val < b) & (mid < hi)
            lo = torch.where(go_right, mid + 1, lo)
            hi = torch.where(go_right, hi, mid)
        val = self.sorted_nbrs[torch.clamp(lo, max=last)]
        return (lo < end) & (val == b)


def node2vec_walk_ref(
    tables: SamplerTables,
    nbr: NeighborIndex,
    starts: torch.Tensor,  # (B,) int32
    steps: int,
    p: float,
    q: float,
    trials: int,
    u_first: torch.Tensor,  # (B, 2): the first step
    u: torch.Tensor,  # (steps-1, B, trials, 3)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the node2vec walk kernel: the JAX loop over
    the steps, a few tensor ops on the whole batch for each trial. Every
    trial is computed; the kernel stops at the first accepted one, which is
    the one kept here."""
    inv_p, inv_q, max_bias = n2v_kernel.biases(p, q)
    row_mask = (tables.vert_meta[starts][..., 1] > 0).to(torch.float32)
    B = starts.shape[0]
    first = tables.target_sample(None, starts, u2=u_first)
    if steps <= 1:
        return torch.stack([starts, first], dim=1)[:, :steps + 1], row_mask

    path = [starts, first]
    prev, cur = starts, first
    for s in range(steps - 1):
        live = tables.vert_meta[cur][..., 1] > 0
        cur = torch.where(live, cur, starts)  # restart like RandomWalk
        chosen = torch.zeros_like(starts)
        done = torch.zeros(B, dtype=torch.bool, device=starts.device)
        for t in range(trials):
            cand = tables.target_sample(None, cur, u2=u[s, :, t, 0:2])
            bias = torch.where(cand == prev, inv_p,
                               torch.where(nbr.contains(prev, cand), 1.0,
                                           inv_q))
            accept = u[s, :, t, 2] * max_bias < bias
            if t == trials - 1:
                accept = torch.ones_like(accept)
            chosen = torch.where(accept & ~done, cand, chosen)
            done = done | accept
        prev, cur = cur, chosen
        path.append(chosen)
    return torch.stack(path, dim=1), row_mask


def node2vec_walk(
    tables: SamplerTables,
    nbr: NeighborIndex,
    gen: Optional[torch.Generator],
    starts: torch.Tensor,  # (B,) int32
    steps: int,
    p: float = 1.0,
    q: float = 1.0,
    trials: int = 4,
    u_first: Optional[torch.Tensor] = None,  # (B, 2): the first step
    u: Optional[torch.Tensor] = None,  # (steps-1, B, trials, 3)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched second-order walk by alias draw and rejection: per step and
    row up to ``trials`` candidates (uniforms: index, alias, acceptance),
    the first accepted one kept, the last one if none is. p = q = 1 is
    random_walk's law (every candidate is accepted). Returns (walk (B,
    steps+1) int32, row_mask (B,)).

    The uniforms are drawn from ``gen`` when not given, ``u_first`` first
    and ``u`` after it (none when steps <= 1). CPU tensors run
    ``node2vec_walk_ref``; CUDA tensors launch the kernel
    (``csrc/node2vec_walk.cu``) on the current stream, bit-equal to the
    twin given the same uniforms; any other device raises: nothing falls
    back. ``ops/node2vec_walk.KERNEL.launches`` counts kernel
    launches. Vertex ids are not bounds-checked on the card."""
    dev = starts.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    B = starts.shape[0]
    if u_first is None:
        u_first = tables._uniform(gen, (B, 2))
    if u is None:
        u = (tables._uniform(gen, (steps - 1, B, trials, 3)) if steps > 1
             else torch.empty((0, B, trials, 3), device=dev))
    args = (tables.vert_meta, tables.ctx_pa, nbr.indptr, nbr.sorted_nbrs)
    if dev.type == "cuda":
        return n2v_kernel.node2vec_walk(starts, u_first, u, *args, steps, p,
                                        q, trials)
    n2v_kernel.check(starts, steps, trials, u_first, u, *args)
    return node2vec_walk_ref(tables, nbr, starts, steps, p, q, trials,
                             u_first, u)
