"""Plain reference of node2vec as SMORe trains it: second-order biased
walks, skip-gram pairs and the shared-negative SGNS update. It imports
nothing of the program and no JAX: numpy for the walk's scalar loop, plain
torch for the update, float32 throughout, TF32 off while it computes.

node2vec (Grover & Leskovec, KDD 2016, arXiv:1607.00653) walks with
second-order weights: from (prev, cur) the next vertex x has weight
w(cur, x) times 1/p when x is prev, 1 when x is a neighbour of prev and 1/q
otherwise. SMORe-Go (``node2vec.go:82-258``) draws that law by scanning
cur's neighbours; here, as in the program, x is drawn by rejection from
cur's alias table of w^0.75 (SMORe's context law): up to ``trials``
candidates, each accepted with probability bias / max_bias, the first
accepted one kept and the last one taken when none is. The neighbour test
scans prev's neighbour list, as Go's ``areNeighbors`` does
(``node2vec.go:114-175``). The alias draw rounds as the program's sampler
does (the index ``int(float32(u) * float32(degree))``, clamped to the last
slot; the slot's vertex when ``u' < prob``, else its alias), so given the
same uniforms the walks are the program's, entry for entry.

Departures from the published method, noted:

- the ``trials`` cap: Go's exact scan gives the exact second-order law;
  with the cap the law is truncated: after T - 1 rejections the T-th
  candidate is taken by the first-order law (``class_law`` gives the
  resulting probabilities). The program keeps the same cap;
- the update draws one pool of negatives for the whole batch, each
  negative's gradient scaled by K / Ks, in place of K negatives per pair
  (the program's shared pool);
- a walk whose cursor reaches a vertex without out-edges goes back to its
  start vertex, and a walk from such a start stays there and trains no
  pair.

``walk`` and ``walks`` give the walks; ``class_law`` the law of a step's
class (back to prev, to a neighbour of prev, elsewhere); ``train_step`` is
one node2vec step: walks, the skip-gram pairs of a window shrunk per center
to ``reduce``, and the SGNS update from the tables as they were before the
step.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

F32 = np.float32


def adjacency(src, dst, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(indptr (n + 1,), nbrs) of the out-neighbour lists of the directed
    edges ``src`` -> ``dst``, in edge order within a vertex."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    order = np.argsort(src, kind="stable")
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=indptr[1:])
    return indptr, dst[order]


def are_neighbors(indptr: np.ndarray, nbrs: np.ndarray, a: int,
                  b: int) -> bool:
    """Is b among a's out-neighbours? A scan of a's list."""
    return bool((nbrs[indptr[a]:indptr[a + 1]] == b).any())


def alias_draw(v: int, vert_meta: np.ndarray, ctx_pa: np.ndarray, ua,
               ub) -> int:
    """One out-neighbour of v from its alias table (vert_meta [first slot,
    degree], ctx_pa [prob, vertex, alias vertex, 0] float32 rows); a vertex
    without out-edges returns itself."""
    first, deg = int(vert_meta[v, 0]), int(vert_meta[v, 1])
    if deg <= 0:
        return v
    r = int(F32(ua) * F32(deg))  # float32 product, truncated
    slot = min(first + min(r, deg - 1), ctx_pa.shape[0] - 1)
    row = ctx_pa[slot]
    return int(row[1]) if F32(ub) < row[0] else int(row[2])


def walk(start: int, steps: int, u_first, u, vert_meta, ctx_pa, indptr,
         nbrs, p: float, q: float, trials: int):
    """One walk of ``steps`` steps from ``start``, its vertices.
    ``u_first`` (2,) the first step's uniforms, ``u`` (steps - 1, trials,
    3) each later step's [index, alias, acceptance] per trial."""
    inv_p, inv_q = 1.0 / p, 1.0 / q
    top = F32(max(inv_p, 1.0, inv_q))
    bias_back, bias_near, bias_far = F32(inv_p), F32(1.0), F32(inv_q)
    path = [int(start)]
    if steps == 0:
        return path
    cur = alias_draw(start, vert_meta, ctx_pa, u_first[0], u_first[1])
    path.append(cur)
    prev = int(start)
    for s in range(steps - 1):
        if int(vert_meta[cur, 1]) == 0:  # a dead end: back to the start
            cur = int(start)
        for t in range(trials):
            cand = alias_draw(cur, vert_meta, ctx_pa, u[s, t, 0], u[s, t, 1])
            if t == trials - 1:
                break
            if cand == prev:
                bias = bias_back
            elif are_neighbors(indptr, nbrs, prev, cand):
                bias = bias_near
            else:
                bias = bias_far
            if F32(u[s, t, 2]) * top < bias:
                break
        path.append(cand)
        prev, cur = cur, cand
    return path


def walks(starts, steps: int, u_first, u, vert_meta, ctx_pa, indptr, nbrs,
          p: float, q: float, trials: int, rows=None):
    """The walks of the rows ``rows`` (all by default) of a batch, an int64
    (R, steps + 1) tensor. ``starts`` (B,), ``u_first`` (B, 2), ``u``
    (steps - 1, B, trials, 3), as the program draws them."""
    starts = np.asarray(starts)
    u_first, u = np.asarray(u_first, dtype=F32), np.asarray(u, dtype=F32)
    vert_meta, ctx_pa = np.asarray(vert_meta), np.asarray(ctx_pa, dtype=F32)
    rows = range(len(starts)) if rows is None else rows
    out = [walk(int(starts[b]), steps, u_first[b], u[:, b], vert_meta,
                ctx_pa, indptr, nbrs, p, q, trials) for b in rows]
    return torch.tensor(out, dtype=torch.int64).reshape(-1, steps + 1)


def class_law(back, near, p: float, q: float, trials: int):
    """The probabilities that a step goes back to prev, to a neighbour of
    prev, or elsewhere, under the truncated rejection law, given the mass
    ``back`` and ``near`` of those classes in cur's first-order law (floats
    or tensors, elementwise): with a_x = bias_x / max_bias and
    r = 1 - sum_y pi_y a_y, P(x) = pi_x a_x (1 - r^(T-1)) / (1 - r)
    + r^(T-1) pi_x. Every a_x is positive, so 1 - r is."""
    inv_p, inv_q = 1.0 / p, 1.0 / q
    top = max(inv_p, 1.0, inv_q)
    mass = (back, near, 1.0 - back - near)
    a = (inv_p / top, 1.0 / top, inv_q / top)
    acc = sum(m * x for m, x in zip(mass, a))
    tail = (1.0 - acc) ** (trials - 1)
    geo = (1.0 - tail) / acc
    return tuple(m * x * geo + tail * m for m, x in zip(mass, a))


def skipgram_pairs(walk_rows: torch.Tensor, reduce: torch.Tensor,
                   live: torch.Tensor):
    """(src, pos) of every pair (walk[i], walk[i + o]), 0 < |o| <=
    reduce[b, i], inside the walk, of the live rows."""
    src, pos = [], []
    B, L = walk_rows.shape
    for b in range(B):
        if not bool(live[b]):
            continue
        for i in range(L):
            for o in range(1, int(reduce[b, i]) + 1):
                for j in (i - o, i + o):
                    if 0 <= j < L:
                        src.append(int(walk_rows[b, i]))
                        pos.append(int(walk_rows[b, j]))
    return (torch.tensor(src, dtype=torch.int64),
            torch.tensor(pos, dtype=torch.int64))


def sgns_step(wv: torch.Tensor, wc: torch.Tensor, src: torch.Tensor,
              pos: torch.Tensor, negs: torch.Tensor, alpha: float,
              k_equiv: int) -> None:
    """One shared-negative SGNS step on ``wv`` and ``wc`` in place, every
    delta from the tables before it, duplicate rows summed:
    g_pos = alpha (1 - sigmoid(v . c)), g_k = -alpha (K / Ks)
    sigmoid(v . n_k); v += g_pos c + sum_k g_k n_k, c += g_pos v,
    n_k += sum over the pairs of g_k v."""
    negs = negs.long()
    v, cp, cn = wv[src], wc[pos], wc[negs]
    kscale = k_equiv / cn.shape[0]
    s_pos = torch.sigmoid((v * cp).sum(-1))
    s_neg = torch.sigmoid(v @ cn.T)
    g_pos = (1.0 - s_pos) * alpha
    g_neg = -s_neg * (alpha * kscale)
    d_src = g_pos[:, None] * cp + g_neg @ cn
    d_pos = g_pos[:, None] * v
    d_neg = g_neg.T @ v
    wc.index_add_(0, pos, d_pos)
    wc.index_add_(0, negs, d_neg)
    wv.index_add_(0, src, d_src)


def train_step(wv: torch.Tensor, wc: torch.Tensor, starts, steps: int,
               u_first, u, reduce, negs, alpha: float, vert_meta, ctx_pa,
               indptr, nbrs, p: float, q: float, trials: int, k_equiv: int):
    """One node2vec step on ``wv`` and ``wc`` in place: the walks from
    ``starts``, their skip-gram pairs, one SGNS update with the pool
    ``negs``. Returns the walks."""
    rows = walks(starts, steps, u_first, u, vert_meta, ctx_pa, indptr, nbrs,
                 p, q, trials)
    live = np.asarray(vert_meta)[np.asarray(starts), 1] > 0
    src, pos = skipgram_pairs(rows, torch.as_tensor(reduce), live)
    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        if src.numel():
            sgns_step(wv, wc, src.to(wv.device), pos.to(wv.device),
                      torch.as_tensor(negs).to(wv.device), alpha, k_equiv)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = keep
    return rows
