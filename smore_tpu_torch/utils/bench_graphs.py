"""The seeded benchmark graphs and their community-AUC probe (numpy only).

The port's own copy of ``bench.py``'s ``make_graph``, ``make_youtube_graph``,
``yt_labels`` and ``yt_community_auc``, so that the port's smoke test and
benchmarks depend on nothing of the JAX package. The copy is held to the
original bit for bit (files and AUC) by tests/test_torch_bench_graphs.py:
the two must write the same graphs from the same seeds.
"""

from __future__ import annotations

import os

import numpy as np


def make_graph(path: str, n=50_000, e=1_000_000, n_comm=100, seed=0) -> None:
    """The 50k-vertex community bench graph: ``n`` vertices in ``n_comm``
    planted communities, ``e`` edge draws (90% inside the source's
    community), self-loops dropped; written as ``v<src> v<dst> 1`` lines.
    Does nothing when ``path`` exists."""
    if os.path.exists(path):
        return
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, n_comm, n)
    order = np.argsort(comm)
    sorted_comm = comm[order]
    starts = np.searchsorted(sorted_comm, np.arange(n_comm))
    ends = np.searchsorted(sorted_comm, np.arange(n_comm), side="right")

    src = rng.integers(0, n, e)
    intra = rng.random(e) < 0.9
    # vectorized intra-community destination draw
    cs = comm[src]
    lo, hi = starts[cs], ends[cs]
    r = rng.random(e)
    intra_dst = order[(lo + (r * (hi - lo)).astype(np.int64)).clip(0, n - 1)]
    rand_dst = rng.integers(0, n, e)
    dst = np.where(intra, intra_dst, rand_dst)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    with open(path, "w") as f:
        np.savetxt(f, np.stack([src, dst], 1), fmt="v%d v%d 1")


def make_youtube_graph(path: str, n=1_100_000, e=3_000_000, n_comm=100,
                       seed=7) -> None:
    """Seeded synthetic with the published shape of SNAP com-Youtube
    (youtube-links): ~1.13M vertices, ~3M undirected links, power-law
    degrees with gamma ~= 2.2 and the maximum degree capped at the real
    graph's 28,754. Chung-Lu endpoint draws and ``n_comm`` planted
    communities, so that the community-AUC gate applies; written as
    ``u<src> u<dst> 1`` lines. Does nothing when ``path`` exists."""
    if os.path.exists(path):
        return
    rng = np.random.default_rng(seed)
    # Chung-Lu weights w_i ~ (i+1)^-beta, beta = 1/(gamma-1), capped so
    # the expected max degree matches the real graph's 28,754.
    beta = 1.0 / (2.2 - 1.0)
    w = (np.arange(1, n + 1, dtype=np.float64)) ** (-beta)
    cap = 28_754 / (2.0 * e) * w.sum()
    for _ in range(8):  # fixed-point: capping changes the normalization
        w = np.minimum(w, cap)
        cap = 28_754 / (2.0 * e) * w.sum()
    p = w / w.sum()
    comm = rng.integers(0, n_comm, n)
    order = np.argsort(comm, kind="stable")
    sorted_comm = comm[order]
    starts = np.searchsorted(sorted_comm, np.arange(n_comm))
    ends = np.searchsorted(sorted_comm, np.arange(n_comm), side="right")
    # per-community cumulative weight for intra-community endpoint draws
    w_sorted = p[order]
    cw = np.cumsum(w_sorted)
    cw_lo = np.concatenate([[0.0], cw])[starts]
    cw_hi = np.concatenate([[0.0], cw])[ends]

    src = rng.choice(n, e, p=p)
    intra = rng.random(e) < 0.9
    cs = comm[src]
    r = rng.random(e)
    # weighted draw inside src's community via inverse-CDF on cw
    targets = cw_lo[cs] + r * (cw_hi[cs] - cw_lo[cs])
    intra_dst = order[np.searchsorted(cw, targets).clip(0, n - 1)]
    rand_dst = rng.choice(n, e, p=p)
    dst = np.where(intra, intra_dst, rand_dst)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    with open(path, "w") as f:
        np.savetxt(f, np.stack([src, dst], 1), fmt="u%d u%d 1")


YT_N, YT_N_COMM, YT_SEED = 1_100_000, 100, 7


def yt_labels() -> np.ndarray:
    """Planted community labels of make_youtube_graph (by NAME index)."""
    return np.random.default_rng(YT_SEED).integers(0, YT_N_COMM, YT_N)


def yt_community_auc(emb_by_vid, names, n_pairs=200_000, seed=0) -> float:
    """Cosine AUC of same-community against different-community pairs of
    make_youtube_graph's vertices (``names[i]`` is the name of row i)."""
    lab_all = yt_labels()
    vid_label = np.array([lab_all[int(nm[1:])] for nm in names])
    x = emb_by_vid / (
        np.linalg.norm(emb_by_vid, axis=1, keepdims=True) + 1e-9
    )
    rng = np.random.default_rng(seed)
    a = rng.integers(0, len(x), n_pairs * 4)
    b = rng.integers(0, len(x), n_pairs * 4)
    same = vid_label[a] == vid_label[b]
    s = (x[a] * x[b]).sum(1)
    pos, neg = s[same][:n_pairs], s[~same][:n_pairs]
    n = min(len(pos), len(neg), n_pairs)
    return float((pos[:n, None] > neg[None, :2000]).mean())
