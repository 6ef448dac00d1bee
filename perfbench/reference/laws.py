"""Plain PyTorch reference of the sampling laws of the benchmark's cells,
and the comparisons that hold draws and alias tables to them. It imports
nothing of the program: every law is worked out from the benchmark's own
edge arrays (``src``, ``dst``, ``w``: directed edge slots over vertex ids).

The laws (the upstream SMORe's, at power 0.75):

- a source vertex u by its weighted out-degree^0.75;
- a context v of u by the weight^0.75 of the edge slot u -> v among u's
  slots (a random walk's next vertex the same);
- a pair (u, v) by the product of the two;
- a negative by its weighted (out + in) degree^0.75.

An alias table (``prob``, ``alias``) of n slots is drawn as: slot i uniform,
then i with probability prob[i], else alias[i]; ``alias_implied`` gives the
law that this draws, so a table is held to its law by the total-variation
distance between the two. Draws are held to their law by z-scores: the
sum over draws of f(draw) minus its expectation under the law, over the
square root of the summed variances, for two probes f: "deg", log(1 +
degree(v)), and "id", v / n (which sees a law that reaches only part of
the table on a graph whose degrees are all alike). The exact properties
(a drawn pair is an edge, a walk moves along edges) are counts of the
draws that break them.
"""

from __future__ import annotations

import math

import torch

F64 = torch.float64
POWER = 0.75


class GraphLaws:
    """The laws of one graph, on ``device``."""

    def __init__(self, src, dst, w, n: int, device):
        self.n = n
        self.src = torch.as_tensor(src, device=device).long()
        self.dst = torch.as_tensor(dst, device=device).long()
        self.w = torch.as_tensor(w, device=device).to(F64)
        self.out_w = torch.zeros(n, dtype=F64, device=device).index_add_(
            0, self.src, self.w)
        self.in_w = torch.zeros(n, dtype=F64, device=device).index_add_(
            0, self.dst, self.w)
        self.out_slots = torch.bincount(self.src, minlength=n)
        self.keys = torch.unique(self.src * n + self.dst)  # sorted
        # the probes of the z-scores
        self.probes = {
            "deg": torch.log1p(self.out_w + self.in_w),
            "id": torch.arange(n, dtype=F64, device=device) / n,
        }
        wp = _pow(self.w)
        seg = torch.zeros(n, dtype=F64, device=device).index_add_(
            0, self.src, wp)
        self.ctx_mass = wp / seg[self.src]  # P(slot | its source)
        self.source = law(_pow(self.out_w))
        self.negative = law(_pow(self.out_w + self.in_w))
        self.slot_mass = self.source[self.src] * self.ctx_mass  # P(slot)
        # each probe's mean and variance over a context of each vertex
        self.next_moments = {}
        for name, f in self.probes.items():
            fd = f[self.dst]
            m1 = torch.zeros(n, dtype=F64, device=device).index_add_(
                0, self.src, self.ctx_mass * fd)
            m2 = torch.zeros(n, dtype=F64, device=device).index_add_(
                0, self.src, self.ctx_mass * fd * fd)
            self.next_moments[name] = (m1, torch.clamp(m2 - m1 ** 2,
                                                       min=0.0))

    def not_edges(self, u, v) -> int:
        """How many of the pairs (u[i], v[i]) are no edge of the graph."""
        return missing(self.keys, u.long() * self.n + v.long())

    def z_law(self, draws, p) -> dict:
        """Each probe's z-score of i.i.d. ``draws`` of vertex ids against
        the law ``p``."""
        d = draws.reshape(-1).long()
        out = {}
        for name, f in self.probes.items():
            mean = float((p * f).sum())
            var = float((p * f ** 2).sum()) - mean ** 2
            out[name] = z_score(float(f[d].sum()) - d.numel() * mean,
                                d.numel() * var)
        return out

    def z_next(self, cur, nxt) -> dict:
        """Each probe's z-score of ``nxt[i]`` drawn as a context of
        ``cur[i]``."""
        cur, nxt = cur.reshape(-1).long(), nxt.reshape(-1).long()
        out = {}
        for name, f in self.probes.items():
            m1, var = self.next_moments[name]
            out[name] = z_score(float((f[nxt] - m1[cur]).sum()),
                                float(var[cur].sum()))
        return out


def _pow(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x.clamp(min=1e-300) ** POWER,
                       torch.zeros_like(x))


def law(mass: torch.Tensor) -> torch.Tensor:
    return mass / mass.sum()


def z_score(dev: float, var: float) -> float:
    return dev / math.sqrt(var) if var > 0 else (0.0 if dev == 0 else
                                                 math.inf)


def missing(sorted_keys: torch.Tensor, query: torch.Tensor,
            chunk: int = 1 << 24) -> int:
    """How many of ``query`` are not in ``sorted_keys``."""
    miss = 0
    q = query.reshape(-1)
    for a in range(0, q.numel(), chunk):
        x = q[a:a + chunk]
        i = torch.searchsorted(sorted_keys, x).clamp(
            max=sorted_keys.numel() - 1)
        miss += int((sorted_keys[i] != x).sum())
    return miss


def alias_implied(prob: torch.Tensor, alias: torch.Tensor) -> torch.Tensor:
    """The law over slots 0..n-1 that drawing the table gives."""
    n = prob.shape[0]
    p = prob.to(F64)
    out = p.clone()
    out.index_add_(0, alias.long(), 1.0 - p)
    return out / n


def tv(p: torch.Tensor, q: torch.Tensor) -> float:
    """Total-variation distance of two laws over the same slots."""
    return 0.5 * float((p.to(F64) - q.to(F64)).abs().sum())


def keyed_tv(keys_a, mass_a, keys_b, mass_b) -> float:
    """Total-variation distance of two laws given as masses on keys
    (repeated keys add up)."""
    keys = torch.cat([keys_a.reshape(-1), keys_b.reshape(-1)]).long()
    uniq, inv = torch.unique(keys, return_inverse=True)
    na = keys_a.numel()
    diff = torch.zeros(uniq.numel(), dtype=F64, device=keys.device)
    diff.index_add_(0, inv[:na], mass_a.reshape(-1).to(F64))
    diff.index_add_(0, inv[na:], -mass_b.reshape(-1).to(F64))
    return 0.5 * float(diff.abs().sum())


def segment_tv_max(seg_a, keys_a, mass_a, seg_b, keys_b, mass_b,
                   n_seg: int) -> float:
    """The largest total-variation distance of two families of laws, one
    per segment (a keyed mass belongs to segment ``seg``)."""
    keys = torch.cat([keys_a.reshape(-1), keys_b.reshape(-1)]).long()
    segs = torch.cat([seg_a.reshape(-1), seg_b.reshape(-1)]).long()
    uniq, inv = torch.unique(keys, return_inverse=True)
    na = keys_a.numel()
    diff = torch.zeros(uniq.numel(), dtype=F64, device=keys.device)
    diff.index_add_(0, inv[:na], mass_a.reshape(-1).to(F64))
    diff.index_add_(0, inv[na:], -mass_b.reshape(-1).to(F64))
    seg_of = torch.zeros(uniq.numel(), dtype=torch.long, device=keys.device)
    seg_of[inv] = segs
    per = torch.zeros(n_seg, dtype=F64, device=keys.device).index_add_(
        0, seg_of, diff.abs())
    return 0.5 * float(per.max())


def window_count_moments(length: int, window: int):
    """Mean and variance of the number of skip-gram pairs of one walk of
    ``length`` vertices, each center's window U{1..window} and a pair's
    both ends inside the walk."""
    mean = var = 0.0
    for i in range(length):
        counts = []
        for r in range(1, window + 1):
            counts.append(sum((i - o >= 0) + (i + o < length)
                              for o in range(1, r + 1)))
        m = sum(counts) / window
        mean += m
        var += sum((c - m) ** 2 for c in counts) / window
    return mean, var


def window_pair_keys(walks: torch.Tensor, window: int, n: int):
    """Keys u * n + v of every (walk[i], walk[i + o]), 0 < |o| <= window,
    of the (B, L) walks, sorted."""
    B, L = walks.shape
    w = walks.long()
    keys = []
    for o in range(1, window + 1):
        a, b = w[:, :L - o], w[:, o:]
        keys.append(a * n + b)
        keys.append(b * n + a)
    return torch.unique(torch.cat([k.reshape(-1) for k in keys]))


def init_moments(dim: int):
    """Mean and variance of one entry of the reference's vertex-table init,
    U(-0.5, 0.5) / dim."""
    return 0.0, 1.0 / (12.0 * dim * dim)
