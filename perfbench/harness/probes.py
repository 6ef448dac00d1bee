"""The community-AUC probe (numpy only).

A frozen copy of ``yt_community_auc`` (``smore_tpu_torch/utils/
bench_graphs.py``) and ``chip_smoke.community_auc_50k``: the cosine AUC of
same-community against different-community vertex pairs. The originals
look each vertex's label up by the number in its name; here the labels come
with the graph (``graphs.Interned.label``, indexed by vertex id), which is
the same lookup. perfbench/tests/test_frozen.py holds it to the originals.
"""

from __future__ import annotations

import numpy as np


def community_auc(emb_by_vid: np.ndarray, vid_label: np.ndarray,
                  n_pairs: int = 200_000, seed: int = 0) -> float:
    """Share of (same-community, different-community) pair pairs whose
    same-community cosine is the larger: up to ``n_pairs`` same-community
    pairs against the first 2,000 different-community ones."""
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
