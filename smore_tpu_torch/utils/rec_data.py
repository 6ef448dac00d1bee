"""The seeded implicit-feedback dataset of the rec quality gates, and its
scorer (numpy only).

The port's own copy of ``experiments/bpr_parity.py``'s ``make_dataset``,
``evaluate`` and ``load_ref_embeddings`` and of
``experiments/longtail_parity.py``'s ``make_field_file`` and
``load_wide_embeddings``, with the file
paths as arguments, so that the port's smoke test depends on nothing of the
JAX package. The copy is held to the originals byte for byte by
tests/test_torch_rec_data.py: the same seed writes the same files.

The dataset: 6,000 users and 3,000 items in 60 latent taste clusters; each
user draws 120-199 items of its cluster plus 10% noise, split 80/20 into
train and test by user. Training edges are ``u<user> i<item> 1`` lines.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Sequence, Tuple

import numpy as np

N_USERS, N_ITEMS, N_CLUST = 6000, 3000, 60


def make_dataset(train_path: str, test_path: str, seed: int = 0) -> None:
    """Write the training edge list and the ``.npz`` of the train and test
    pairs; does nothing when both files exist."""
    if os.path.exists(train_path) and os.path.exists(test_path):
        return
    rng = np.random.default_rng(seed)
    uc = rng.integers(0, N_CLUST, N_USERS)  # user cluster
    ic = rng.integers(0, N_CLUST, N_ITEMS)  # item cluster
    items_by_c = [np.where(ic == c)[0] for c in range(N_CLUST)]
    tr_u, tr_i, te_u, te_i = [], [], [], []
    for u in range(N_USERS):
        pool = items_by_c[uc[u]]
        k = rng.integers(120, 200)
        chosen = rng.choice(pool, size=min(k, len(pool)), replace=False)
        noise = rng.integers(0, N_ITEMS, max(1, k // 10))
        all_i = np.unique(np.concatenate([chosen, noise]))
        rng.shuffle(all_i)
        cut = int(0.8 * len(all_i))
        tr_u += [u] * cut
        tr_i += list(all_i[:cut])
        te_u += [u] * (len(all_i) - cut)
        te_i += list(all_i[cut:])
    with open(train_path, "w") as f:
        for u, i in zip(tr_u, tr_i):
            f.write(f"u{u} i{i} 1\n")
    np.savez(test_path, te_u=np.array(te_u), te_i=np.array(te_i),
             tr_u=np.array(tr_u), tr_i=np.array(tr_i))


def make_field_file(train_path: str, field_path: str) -> None:
    """Users -> field ``u``, items -> field ``i``, one ``vertex field``
    line per name in first-appearance order of the training file; does
    nothing when the file exists."""
    if os.path.exists(field_path):
        return
    seen = set()
    with open(train_path) as f, open(field_path, "w") as out:
        for line in f:
            for name in line.split()[:2]:
                if name not in seen:
                    seen.add(name)
                    out.write(f"{name} {name[0]}\n")


def evaluate(test_path: str, user_emb: np.ndarray, item_emb: np.ndarray,
             seed: int = 3) -> Tuple[float, float]:
    """(AUC, recall@10) of user_emb (N_USERS, D) and item_emb (N_ITEMS, D)
    in label order: AUC over 50,000 (test positive, random item) pairs,
    recall@10 over the unseen-item ranking of 1,000 sampled users."""
    d = np.load(test_path)
    te_u, te_i, tr_u, tr_i = d["te_u"], d["te_i"], d["tr_u"], d["tr_i"]
    rng = np.random.default_rng(seed)

    sel = rng.integers(0, len(te_u), 50_000)
    neg = rng.integers(0, N_ITEMS, 50_000)
    s_pos = np.sum(user_emb[te_u[sel]] * item_emb[te_i[sel]], axis=1)
    s_neg = np.sum(user_emb[te_u[sel]] * item_emb[neg], axis=1)
    auc = float(np.mean(s_pos > s_neg) + 0.5 * np.mean(s_pos == s_neg))

    seen = defaultdict(set)
    for u, i in zip(tr_u, tr_i):
        seen[u].add(i)
    test_by_u = defaultdict(set)
    for u, i in zip(te_u, te_i):
        test_by_u[u].add(i)
    users = rng.choice(list(test_by_u.keys()), 1000, replace=False)
    hits = tot = 0
    scores_all = user_emb[users] @ item_emb.T  # (1000, N_ITEMS)
    for row, u in enumerate(users):
        s = scores_all[row].copy()
        s[list(seen[u])] = -np.inf
        top = np.argpartition(-s, 10)[:10]
        hits += len(set(top) & test_by_u[u])
        tot += min(10, len(test_by_u[u]))
    return auc, hits / tot


def split_by_name(names: Sequence[str], table: np.ndarray,
                  dim: int) -> Tuple[np.ndarray, np.ndarray]:
    """(users (N_USERS, dim), items (N_ITEMS, dim)) in label order from the
    rows of ``table`` named ``u<k>`` / ``i<k>``; unnamed labels stay 0."""
    ue = np.zeros((N_USERS, dim), dtype=np.float32)
    ie = np.zeros((N_ITEMS, dim), dtype=np.float32)
    for row, name in enumerate(names):
        (ue if name[0] == "u" else ie)[int(name[1:])] = table[row]
    return ue, ie


def load_embeddings_ui(path: str, dim: int) -> Tuple[np.ndarray, np.ndarray]:
    """A saved embedding file as label-order (users, items) matrices."""
    names, rows = [], []
    with open(path) as f:
        f.readline()
        for line in f:
            p = line.split()
            names.append(p[0])
            rows.append(np.array(p[1:], dtype=np.float32))
    return split_by_name(names, np.asarray(rows), dim)



def load_wide_embeddings(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """A saved embedding file as label-order (users, items) matrices of the
    rows' own width (FINE and msFINE write two field rows side by side, 2 *
    dim columns, so the width is read from the rows, not the header)."""
    with open(path) as f:
        f.readline()
        lines = f.readlines()
    width = len(lines[0].split()) - 1
    ue = np.zeros((N_USERS, width), dtype=np.float32)
    ie = np.zeros((N_ITEMS, width), dtype=np.float32)
    for line in lines:
        p = line.split()
        (ue if p[0][0] == "u" else ie)[int(p[0][1:])] = np.array(
            p[1:], dtype=np.float32)
    return ue, ie
