"""node2vec jobs: ``Node2Vec(graph).init(dim)`` then ``train(...)`` with
the configuration's settings (p and q among them), everything else
``Node2Vec.train``'s defaults (batches of 128 walks, a shared pool of 256
negatives, the masked plain update, four rejection trials a step;
epoch-exact starts on graphs of at most 131,072 vertices).

The output check holds the walks three ways besides ``walk``'s checks of
the tables, the starts, the pairs and the negatives:

- exact: the plain reference (``perfbench/reference/node2vec.py``) walks
  again from the recorded starts on the recorded uniforms, with the
  configuration's p and q, and every entry must be the program's
  (``EXACT_WALKS`` walks spread over the recorded draws);
- the second-order law: each step (prev, cur) -> x is classed as a return
  (x is prev), a neighbour of prev, or other, and the three class counts
  are held by z-scores to the truncated rejection law
  (``reference.node2vec.class_law``) of the step's first-order masses;
  the first step to the first-order law.

``launch_bytes_of`` counts the bytes that one launch of the walk kernel
needs, from a replay of the rejection rule on the recorded walks; the
output check leaves it on the recorder (``n2v_launch_bytes``) for
``n2v_walk_roofline_pct``.
"""

from __future__ import annotations

import math

import torch

from perfbench.harness import record
from perfbench.harness.families import line as line_family
from perfbench.harness.families import walk as walk_family
from perfbench.reference import laws
from perfbench.reference import node2vec as reference

WORK = "walks"
# recorded walks the exact check walks again with the reference (a Python
# loop, ~1 ms a walk)
EXACT_WALKS = 1024
# second-order steps the class-law check reads at most, and the neighbour
# lists it expands at once
LAW_STEPS = 400_000
CHUNK = 1 << 24
SECTOR = 32  # bytes the card reads at least from device memory


def build(graph, seed: int, cell, device):
    from smore_tpu_torch.models.node2vec import Node2Vec
    # the walk kernel's launcher, whose launches the per-layer metrics
    # read: a program without it fails here, at set-up
    from smore_tpu_torch.ops import node2vec_walk  # noqa: F401

    return Node2Vec(graph, seed=seed, device=device)


def job(model, cell, budget: dict) -> None:
    model.init(**cell.config["init"])
    model.train(**cell.config["train"], **budget, verbose=False)


def walk_wrapper(rec: record.Recorder):
    """Wraps ``node2vec_walk(tables, nbr, gen, starts, steps, p, q,
    trials, u_first, u)``: draws the uniforms from ``gen`` as the walk
    would (``u_first``, then ``u``), hands them in, and records the starts,
    the uniforms and the walk of the first draws outside a capture."""

    def make(orig):
        def wrapped(tables, nbr, gen, starts, steps, p=1.0, q=1.0,
                    trials=4, u_first=None, u=None):
            B, dev = starts.shape[0], starts.device
            if u_first is None:
                u_first = torch.rand((B, 2), generator=gen, device=dev)
            if u is None:
                u = torch.rand((max(steps - 1, 0), B, trials, 3),
                               generator=gen, device=dev)
            walk, row_mask = orig(tables, nbr, gen, starts, steps, p, q,
                                  trials, u_first=u_first, u=u)
            if len(rec.walks) < rec.n_draws and not record._capturing(walk):
                if not hasattr(rec, "n2v_draws"):
                    rec.n2v_draws = []
                rec.n2v_draws.append({
                    "starts": rec._keep(starts), "u_first": rec._keep(u_first),
                    "u": rec._keep(u), "steps": int(steps)})
            rec.walk(walk)
            return walk, row_mask

        return wrapped

    return make


def hooks(rec: record.Recorder) -> None:
    from smore_tpu_torch.models import node2vec, walk_base

    rec.patch(walk_base, "sgns_shared_negs_step",
              record.shared_negs_wrapper(rec))
    rec.patch(node2vec, "node2vec_walk", walk_wrapper(rec))


# the tables the checks read, and the SGNS operations of the walks' pairs,
# as ``walk`` has them: the walk itself does no floating-point work worth
# counting
derived = walk_family.derived
flops = walk_family.flops


# ------------------------------------------------------------ the bytes #
def _slot(u0, deg, off, n_edges):
    """The alias slot of an index uniform, as the program's sampler rounds
    it (float32 product, truncated, clamped to the row and the table)."""
    r = (u0 * deg.to(torch.float32)).to(torch.int64)
    return torch.clamp(off + torch.minimum(r, torch.clamp(deg - 1, min=0)),
                       max=n_edges - 1)


class _Sectors:
    """32-B sectors of one array touched by each launch, as a bitmap."""

    def __init__(self, n_launch: int, nbytes: int, item: int, device):
        self.per = -(-nbytes // SECTOR)
        self.item = item
        self.bits = torch.zeros(n_launch * self.per, dtype=torch.bool,
                                device=device)

    def mark(self, launch, index, where=None):
        if where is not None:
            launch, index = launch[where], index[where]
        self.bits[launch * self.per + index * self.item // SECTOR] = True

    def count(self) -> int:
        return int(self.bits.sum())


def launch_bytes_of(draws, walks, vert_meta, ctx_pa, p: float, q: float,
                    trials: int) -> float:
    """The bytes one launch of the walk kernel needs, the mean over the
    recorded launches (``draws``: their starts and uniforms; ``walks``:
    their walks): the rejection rule replayed on the recorded walks, each
    input byte counted once a launch, at a 32-B sector's grain: the starts'
    and every cursor's [first slot, degree] rows; each candidate's alias
    row; for each acceptance test (every trial but the last, which is taken
    as it comes) whose candidate is not prev, prev's indptr pair and the
    sectors of prev's sorted list that a binary search reads; the uniforms
    of the trials reached (12 B, 8 B the first step's); the starts read,
    the walks and their row masks written (4 B an entry)."""
    dev = vert_meta.device
    meta = vert_meta.long()
    off, deg = meta[:, 0], meta[:, 1]
    n, E = meta.shape[0], ctx_pa.shape[0]
    # the program's neighbour lists: each vertex's slot vertices, sorted
    vid = ctx_pa[:, 1].long()
    owner = torch.repeat_interleave(torch.arange(n, device=dev), deg)
    nbrs = vid[torch.argsort(owner * n + vid)]
    keys = owner * n + nbrs
    L = len(draws)
    vm = _Sectors(L, 8 * n, 8, dev)
    cx = _Sectors(L, 16 * E, 16, dev)
    ip = _Sectors(L, 4 * (n + 1), 4, dev)
    nb = _Sectors(L, 4 * E, 4, dev)
    launch = torch.cat([torch.full((dr["starts"].shape[0],), i,
                                   device=dev) for i, dr in
                        enumerate(draws)])
    walk = torch.cat([w.to(dev) for w in walks]).long()
    u_first = torch.cat([dr["u_first"].to(dev) for dr in draws])
    u = torch.cat([dr["u"].to(dev) for dr in draws], dim=1)
    B, steps = walk.shape[0], walk.shape[1] - 1
    nbytes = 4 * B * (steps + 3)
    start = walk[:, 0]
    vm.mark(launch, start)
    if steps:
        nbytes += 8 * B
        cx.mark(launch, _slot(u_first[:, 0], deg[start], off[start], E),
                deg[start] > 0)
    inv_p, inv_q = 1.0 / p, 1.0 / q
    top = max(inv_p, 1.0, inv_q)
    depth = max(1, math.ceil(math.log2(int(deg.max()) + 1)) + 1)
    prev, cur = start, walk[:, 1] if steps else start
    for s in range(steps - 1):
        cur = torch.where(deg[cur] > 0, cur, start)
        d = deg[cur]
        vm.mark(launch, cur)
        alive = torch.ones(B, dtype=torch.bool, device=dev)
        for t in range(trials):
            uu = u[s, :, t]
            nbytes += 12 * int(alive.sum())
            slot = _slot(uu[:, 0], d, off[cur], E)
            cx.mark(launch, slot, alive & (d > 0))
            if t == trials - 1:
                break
            row = ctx_pa[slot]
            cand = torch.where(uu[:, 1] < row[:, 0], row[:, 1], row[:, 2])
            cand = torch.where(d > 0, cand.long(), cur)
            search = alive & (cand != prev)
            ip.mark(launch, prev, search)
            ip.mark(launch, prev + 1, search)
            lo, hi = off[prev].clone(), off[prev] + deg[prev]
            end = hi.clone()
            for _ in range(depth):
                go = search & (lo < hi)
                mid = (lo + hi) // 2
                nb.mark(launch, mid, go)
                less = nbrs[mid.clamp(max=E - 1)] < cand
                lo = torch.where(go & less, mid + 1, lo)
                hi = torch.where(go & ~less, mid, hi)
            nb.mark(launch, lo, search & (lo < end))
            k = prev * n + cand
            i = torch.searchsorted(keys, k).clamp(max=E - 1)
            bias = torch.where(cand == prev, inv_p,
                               torch.where(keys[i] == k, 1.0, inv_q))
            alive = alive & ~(uu[:, 2] * top < bias)
        prev, cur = cur, walk[:, s + 2]
    sectors = vm.count() + cx.count() + ip.count() + nb.count()
    return (nbytes + SECTOR * sectors) / L


# --------------------------------------------------------- the checks #
def exact_check(rec, d: dict, L: laws.GraphLaws, cell) -> int:
    """The entries of ``EXACT_WALKS`` recorded walks, spread over the
    recorded draws, that differ from the reference's walks on the same
    starts and uniforms at the configuration's p and q."""
    tr, trials = cell.config["train"], cell.config["assumed"]["trials"]
    indptr, nbrs = reference.adjacency(L.src.cpu().numpy(),
                                       L.dst.cpu().numpy(), L.n)
    vert_meta, ctx_pa = d["vert_meta"].cpu().numpy(), d["ctx_pa"].cpu().numpy()
    draws = rec.n2v_draws
    per = max(1, EXACT_WALKS // len(draws))
    miss = 0
    for dr, got in zip(draws, rec.walks):
        B = dr["starts"].shape[0]
        rows = sorted({int(i) for i in torch.linspace(0, B - 1, min(per, B))})
        steps = dr["steps"]
        want = reference.walks(
            dr["starts"].cpu().numpy(), steps, dr["u_first"].cpu().numpy(),
            dr["u"].cpu().numpy(), vert_meta, ctx_pa, indptr, nbrs,
            tr["p"], tr["q"], trials, rows=rows)
        miss += int((got.cpu()[rows].long() != want).sum())
    return miss


def _cursors(walks: torch.Tensor, deg: torch.Tensor):
    """(prev, cur, next) of every second-order step of the (W, L) walks:
    a cursor without out-edges stands for the walk's start, as the walk's
    restart rule sends it there."""
    eff = torch.where(deg[walks] > 0, walks, walks[:, :1])
    return (eff[:, :-2].reshape(-1), eff[:, 1:-1].reshape(-1),
            walks[:, 2:].reshape(-1))


class _Keyed:
    """The graph's distinct edges u -> v as sorted keys u * n + v, with
    each one's first-order mass P(v | u) (repeated slots summed)."""

    def __init__(self, L: laws.GraphLaws):
        self.n = L.n
        keys, inv = torch.unique(L.src * L.n + L.dst, return_inverse=True)
        self.keys = keys
        self.mass = torch.zeros(keys.numel(), dtype=laws.F64,
                                device=keys.device).index_add_(
                                    0, inv, L.ctx_mass)
        verts = torch.arange(L.n + 1, device=keys.device)
        self.ptr = torch.searchsorted(keys, verts * L.n)
        self.deg = self.ptr[1:] - self.ptr[:-1]

    def find(self, a, b):
        """(is a -> b an edge, its index among the keys)."""
        k = a * self.n + b
        i = torch.searchsorted(self.keys, k).clamp(max=self.keys.numel() - 1)
        return self.keys[i] == k, i

    def mass_of(self, a, b):
        hit, i = self.find(a, b)
        return torch.where(hit, self.mass[i], torch.zeros_like(self.mass[i]))

    def near_mass(self, prev, cur):
        """The first-order mass of cur's edges to a neighbour of prev other
        than prev, over the shorter of the two neighbour lists."""
        own = self.deg[cur] <= self.deg[prev]
        counts = torch.where(own, self.deg[cur], self.deg[prev])
        out = torch.zeros(prev.numel(), dtype=laws.F64, device=prev.device)
        ends = torch.cumsum(counts, 0)
        lo = 0
        while lo < prev.numel():
            base = int(ends[lo - 1]) if lo else 0
            hi = int(torch.searchsorted(ends, base + CHUNK, right=True))
            hi = max(hi, lo + 1)
            c = counts[lo:hi]
            owner = torch.repeat_interleave(
                torch.arange(lo, hi, device=prev.device), c)
            first = torch.cumsum(c, 0) - c
            off = torch.arange(owner.numel(), device=prev.device) - \
                first[owner - lo]
            o_own, o_prev, o_cur = own[owner], prev[owner], cur[owner]
            idx = torch.where(o_own, self.ptr[o_cur], self.ptr[o_prev]) + off
            y = self.keys[idx] % self.n
            via_cur = self.find(o_prev, y)[0] & (y != o_prev)
            m = torch.where(o_own, torch.where(via_cur, self.mass[idx], 0.0),
                            torch.where(y != o_prev, self.mass_of(o_cur, y),
                                        0.0))
            out.index_add_(0, owner, m)
            lo = hi
        return out


def class_z(walks: torch.Tensor, L: laws.GraphLaws, p: float, q: float,
            trials: int) -> dict:
    """z-scores of the counts of returns, steps to a neighbour of prev and
    other steps, over the first ``LAW_STEPS`` second-order steps of the
    walks, against the truncated rejection law."""
    prev, cur, nxt = (x[:LAW_STEPS] for x in _cursors(walks.long(),
                                                        L.out_slots))
    K = _Keyed(L)
    probs = reference.class_law(K.mass_of(cur, prev), K.near_mass(prev, cur),
                                p, q, trials)
    is_back = nxt == prev
    is_near = ~is_back & K.find(prev, nxt)[0]
    seen = (is_back, is_near, ~is_back & ~is_near)
    out = {}
    for name, hit, pr in zip(("return", "near", "far"), seen, probs):
        out[name] = laws.z_score(float(hit.sum()) - float(pr.sum()),
                                 float((pr * (1.0 - pr)).sum()))
    return out


def law_checks(rec, d: dict, L: laws.GraphLaws, cell, fault: bool = False):
    if fault:
        return line_family.law_faults(rec, L)
    # walk's checks of the init, the tables, every step along an edge, the
    # starts, the pairs and the negatives; its first-order law of every
    # walk step does not hold here
    miss, zs, tvs = walk_family.law_checks(rec, d, L, cell)
    zs = {k: v for k, v in zs.items() if not k.startswith("walk_steps.")}
    dev = L.src.device
    tr, trials = cell.config["train"], cell.config["assumed"]["trials"]
    walks = torch.cat([w.to(dev) for w in rec.walks]).long()
    miss += exact_check(rec, d, L, cell)
    rec.n2v_launch_bytes = launch_bytes_of(
        rec.n2v_draws, rec.walks, d["vert_meta"].to(dev),
        d["ctx_pa"].to(dev), tr["p"], tr["q"], trials)
    line_family.put(zs, "first_step", L.z_next(walks[:, 0], walks[:, 1]))
    line_family.put(zs, "second_order",
                    class_z(walks, L, tr["p"], tr["q"], trials))
    return miss, zs, tvs
