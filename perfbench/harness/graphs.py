"""The benchmark's graphs, made from a seed in memory (numpy only).

Frozen copies of ``make_graph`` and ``make_youtube_graph`` (the port's
``smore_tpu_torch/utils/bench_graphs.py``, itself a copy of ``bench.py``'s)
in array form: the same draws in the same order, returned as arrays instead
of written as ``v<src> v<dst> 1`` text. ``intern`` then numbers the vertices
and lays the edges out exactly as ``Graph.load_edge_list(path,
undirected=True)`` would from that text, so ``Graph.from_arrays`` gets the
graph the text would have given, without the write and the parse.
perfbench/tests/test_frozen.py holds both to the originals.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np


@dataclass
class EdgeDraws:
    """A generator's output: directed edge draws (self-loops dropped) over
    vertex numbers 0..n-1, each vertex's planted community, and the prefix
    of its name (``u`` or ``v``)."""

    src: np.ndarray
    dst: np.ndarray
    comm: np.ndarray
    prefix: str


def community_graph(n: int, e: int, n_comm: int, seed: int) -> EdgeDraws:
    """``make_graph``'s law: ``n`` vertices in ``n_comm`` planted
    communities, ``e`` edge draws, 90% inside the source's community."""
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, n_comm, n)
    order = np.argsort(comm)
    sorted_comm = comm[order]
    starts = np.searchsorted(sorted_comm, np.arange(n_comm))
    ends = np.searchsorted(sorted_comm, np.arange(n_comm), side="right")

    src = rng.integers(0, n, e)
    intra = rng.random(e) < 0.9
    cs = comm[src]
    lo, hi = starts[cs], ends[cs]
    r = rng.random(e)
    intra_dst = order[(lo + (r * (hi - lo)).astype(np.int64)).clip(0, n - 1)]
    rand_dst = rng.integers(0, n, e)
    dst = np.where(intra, intra_dst, rand_dst)
    keep = src != dst
    return EdgeDraws(src[keep], dst[keep], comm, "v")


def youtube_graph(n: int, e: int, n_comm: int, seed: int) -> EdgeDraws:
    """``make_youtube_graph``'s law: Chung-Lu endpoint draws with power-law
    weights (gamma 2.2, the expected maximum degree capped at com-Youtube's
    28,754) and ``n_comm`` planted communities."""
    rng = np.random.default_rng(seed)
    beta = 1.0 / (2.2 - 1.0)
    w = (np.arange(1, n + 1, dtype=np.float64)) ** (-beta)
    cap = 28_754 / (2.0 * e) * w.sum()
    for _ in range(8):
        w = np.minimum(w, cap)
        cap = 28_754 / (2.0 * e) * w.sum()
    p = w / w.sum()
    comm = rng.integers(0, n_comm, n)
    order = np.argsort(comm, kind="stable")
    sorted_comm = comm[order]
    starts = np.searchsorted(sorted_comm, np.arange(n_comm))
    ends = np.searchsorted(sorted_comm, np.arange(n_comm), side="right")
    w_sorted = p[order]
    cw = np.cumsum(w_sorted)
    cw_lo = np.concatenate([[0.0], cw])[starts]
    cw_hi = np.concatenate([[0.0], cw])[ends]

    src = rng.choice(n, e, p=p)
    intra = rng.random(e) < 0.9
    cs = comm[src]
    r = rng.random(e)
    targets = cw_lo[cs] + r * (cw_hi[cs] - cw_lo[cs])
    intra_dst = order[np.searchsorted(cw, targets).clip(0, n - 1)]
    rand_dst = rng.choice(n, e, p=p)
    dst = np.where(intra, intra_dst, rand_dst)
    keep = src != dst
    return EdgeDraws(src[keep], dst[keep], comm, "u")


LAWS = {"community": community_graph, "youtube": youtube_graph}


@dataclass
class Interned:
    """What ``Graph.from_arrays`` takes, plus each vertex id's number in
    the generator (``number``) and its planted community (``label``)."""

    src: np.ndarray
    dst: np.ndarray
    weights: np.ndarray
    names: List[str]
    name2id: Dict[str, int]
    number: np.ndarray
    label: np.ndarray


def intern(draws: EdgeDraws) -> Interned:
    """Number the vertices in order of first appearance along the text's
    tokens (src, dst of line 0, then of line 1, ...) and emit each line's
    edge both ways, src -> dst first: ``Graph.from_edges(...,
    undirected=True)``'s layout."""
    tokens = np.stack([draws.src, draws.dst], 1).ravel()
    numbers, first = np.unique(tokens, return_index=True)
    number = numbers[np.argsort(first, kind="stable")]
    vid_of = np.empty(int(numbers.max()) + 1, dtype=np.int64)
    vid_of[number] = np.arange(len(number), dtype=np.int64)
    a, b = vid_of[draws.src], vid_of[draws.dst]
    src = np.stack([a, b], 1).ravel()
    dst = np.stack([b, a], 1).ravel()
    names = [f"{draws.prefix}{i}" for i in number.tolist()]
    return Interned(
        src=src,
        dst=dst,
        weights=np.ones(len(src), dtype=np.float64),
        names=names,
        name2id={nm: i for i, nm in enumerate(names)},
        number=number,
        label=draws.comm[number],
    )


def make(graph_spec: dict, seed: int) -> Interned:
    """The traffic file's ``graph`` entry made from ``seed``."""
    law = LAWS[graph_spec["law"]]
    draws = law(int(graph_spec["n"]), int(graph_spec["e"]),
                int(graph_spec["n_comm"]), int(seed))
    return intern(draws)
