"""The seeded sets and the evaluation of the JODIE and SASRec-family quality
gates (numpy only).

The port's own copy of ``experiments/go_oracle_parity.py``'s
``make_interactions`` (with its ``SEED = 5``) and ``_jodie_eval``, and of
``experiments/sasrec_eval.py``'s ``make_data`` with its 4,000 users x 2,000
items x 30 steps, so that the port's smoke test depends on nothing of the
JAX package. tests/test_torch_seq_data.py holds the copy to the originals:
the same files byte for byte, the same scores of the same tables.

``JODIE_RUN``, ``SEQ_INIT`` and ``SEQ_TRAIN`` hold the settings the gates train at:
``go_oracle_parity.run_jodie``'s (8 epochs at lr 0.05, both ``bce_lr``
arms) and ``sasrec_eval``'s full-autodiff arm (100 epochs, lr 3e-3, 5
negatives, max_seq_len 30, holdout), both at ``DIM`` = 64, the CLIs'
``-dimensions`` default.
"""

from __future__ import annotations

import os

import numpy as np

SEED = 5  # go_oracle_parity's dataset seed
DIM = 64  # the CLIs' -dimensions default

JODIE_RUN = dict(epochs=8, learning_rate=0.05)
JODIE_ARMS = {"jodie": None, "jodie_bce": 0.2}  # the arm's bce_lr
SEQ_INIT = dict(max_seq_len=30, num_blocks=2, num_heads=1, dropout=0.2)
SEQ_TRAIN = dict(epochs=100, batch_size=128, alpha=0.003, holdout=True)
SEQ_NEG = 5  # negatives per position
SEQ_MODELS = {"sasrec": "SASRec", "gsasrec": "GSASRec",
              "recdenoiser": "RecDenoiser"}

# sasrec_eval's Markov set
N_ITEMS = 2000
N_USERS = 4000
SEQ_LEN = 30


def make_interactions(path, users=40, items=60, clusters=4, events=8000):
    """Users repeatedly interact with their own cluster's items over
    increasing time (format: user item timestamp)."""
    rng = np.random.default_rng(SEED)
    t = 0.0
    lines = []
    for _ in range(events):
        u = int(rng.integers(0, users))
        own = np.arange(u % clusters, items, clusters)
        i = int(own[rng.integers(0, len(own))])
        t += float(rng.random())
        lines.append(f"u{u} i{i} {t:.3f}\n")
    with open(path, "w") as f:
        f.writelines(lines)
    return path


# the SASRec paper's MovieLens-1M setting (Kang and McAuley, ICDM 2018,
# section IV) as a shape for make_data: 6,040 users and 3,416 items,
# sequences of 200 (its max_seq_len for ML-1M); the paper trains it at dim
# 50, 2 blocks, 1 head, dropout 0.2, batch 128, lr 1e-3
ML1M = dict(users=6040, items=3416, steps=200)

# the JODIE paper's Wikipedia set (Kumar, Zhang and Leskovec, KDD 2019,
# Table 1) as a shape: users, items, interactions, feature columns; the
# paper trains at dim 128
WIKIPEDIA = dict(users=8227, items=1000, events=157474, features=172)


def interaction_arrays(users=40, items=60, clusters=4, events=8000,
                       features=0, seed=SEED):
    """``make_interactions``' law drawn in bulk, in memory: each event's
    user uniform, its item uniform among the user's cluster's items, the
    time up by U[0, 1); ``features`` columns U[0, 1). Returns (user ids,
    item ids, timestamps, features or None); not the file's draws."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, users, events)
    c = u % clusters
    own = (items - c + clusters - 1) // clusters  # len(range(c, items, k))
    i = c + clusters * (rng.random(events) * own).astype(np.int64)
    t = np.cumsum(rng.random(events))
    f = (rng.random((events, features), dtype=np.float32) if features
         else None)
    return u, i, t, f


def jodie_eval(ue, ie, user_ids, item_ids, n_items, tail=1000):
    """Pairwise accuracy pos > random-neg over the last <= tail (and <=
    20%) interactions; identical fixed negative draws for every table."""
    n = min(tail, max(1, len(user_ids) // 5))
    u = np.asarray(user_ids[-n:])
    i = np.asarray(item_ids[-n:])
    rng = np.random.default_rng(0)
    neg = rng.integers(0, n_items, n)
    s_pos = np.einsum("nd,nd->n", ue[u], ie[i])
    s_neg = np.einsum("nd,nd->n", ue[u], ie[neg])
    return float((s_pos > s_neg).mean())


def make_data(path: str, seed: int = 0, users: int = N_USERS,
              items: int = N_ITEMS, steps: int = SEQ_LEN) -> None:
    """Markov-chain interaction sequences as a user->item edge list (the
    file order defines each user's sequence): ``users`` sequences of
    ``steps`` items among ``items`` (default sasrec_eval's set; ML1M the
    SASRec paper's shape). Keeps an existing file."""
    if os.path.exists(path):
        return
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, items, (items, 5))  # 5 successors per item
    with open(path, "w") as f:
        for u in range(users):
            it = int(rng.integers(0, items))
            for _ in range(steps):
                f.write(f"u{u} i{it} 1\n")
                if rng.random() < 0.85:  # follow the chain
                    it = int(succ[it, rng.integers(0, 5)])
                else:  # exploration noise
                    it = int(rng.integers(0, items))
