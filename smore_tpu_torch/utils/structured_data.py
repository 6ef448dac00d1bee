"""The seeded structured datasets of the community family's quality gates,
and their probe (numpy only).

The port's own copy of ``experiments/structured_parity.py``'s
``make_gcn_dataset``, ``make_textgcn_dataset``, ``make_fine_dataset`` and
``topic_auc``, with the file paths as arguments, so that the port's smoke
test depends on nothing of the JAX package. The copy is held to the
originals byte for byte by tests/test_torch_structured_data.py: the same
seeds write the same files.

Each set plants topics a model can learn (the user-item ranking set reads
chance for GCN, TEXTGCN and FINE in both the JAX package and the C++
reference):

- GCN: 20 topics of 200 entities (field 0) and 75 tags (field 1); each
  entity links 10 tags, 85% of its own topic. Probe: tag same-topic AUC.
- TEXTGCN: 20 topics of 150 docs (field 0) and 150 words (field 2), 500
  stopwords (field 1); each doc links 12 words, 85% of its topic, and 3
  stopwords. Probe: doc same-topic AUC, a doc being the sum of its
  neighbours' rows.
- FINE: 20 genres of 150 users (field 0) and 100 items (field 1); each
  user links 12 items, 85% of its genre. Probe: item same-genre AUC over
  the side-by-side field rows.
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np

SEED = 9
# the members of one topic, in the order of their numbered names
GCN_TAGS_PER_TOPIC = 75
TEXTGCN_DOCS_PER_TOPIC = 150
FINE_ITEMS_PER_GENRE = 100
# each set's probe: (the prefix of the rows it scores, members per topic)
PROBES = {"gcn": ("t", GCN_TAGS_PER_TOPIC),
          "textgcn": ("d", TEXTGCN_DOCS_PER_TOPIC),
          "fine": ("i", FINE_ITEMS_PER_GENRE)}


def topic_of(per_topic: int) -> Callable[[str], int]:
    """The topic of a name ``<letter><k>``: k // per_topic."""
    return lambda name: int(name[1:]) // per_topic


def _write(train_path: str, field_path: str, lines, field) -> None:
    with open(train_path, "w") as f:
        f.writelines(lines)
    with open(field_path, "w") as f:
        f.writelines(field)


def make_textgcn_dataset(train_path: str, field_path: str, topics: int = 20,
                         words_pt: int = 150,
                         docs_pt: int = TEXTGCN_DOCS_PER_TOPIC,
                         stop: int = 500, links: int = 12,
                         stop_links: int = 3) -> None:
    """The doc-word graph with planted topics and a field-1 stopword pool;
    does nothing when the training file exists."""
    if os.path.exists(train_path):
        return
    rng = np.random.default_rng(SEED)
    lines, field = [], []
    for t in range(topics):
        for d in range(docs_pt):
            dn = f"d{t * docs_pt + d}"
            field.append(f"{dn} doc\n")
            for _ in range(links):
                wt_ = t if rng.random() < 0.85 else rng.integers(0, topics)
                w = rng.integers(0, words_pt)
                lines.append(f"{dn} w{wt_ * words_pt + w} 1\n")
            for _ in range(stop_links):
                lines.append(f"{dn} s{rng.integers(0, stop)} 1\n")
    for s in range(stop):
        field.append(f"s{s} stopword\n")
    for w in range(topics * words_pt):
        field.append(f"w{w} word\n")
    _write(train_path, field_path, lines, field)


def make_gcn_dataset(train_path: str, field_path: str, topics: int = 20,
                     ents_pt: int = 200, tags_pt: int = GCN_TAGS_PER_TOPIC,
                     links: int = 10) -> None:
    """The entity-tag graph with planted topics; does nothing when the
    training file exists."""
    if os.path.exists(train_path):
        return
    rng = np.random.default_rng(SEED + 1)
    lines, field = [], []
    for t in range(topics):
        for e in range(ents_pt):
            en = f"e{t * ents_pt + e}"
            field.append(f"{en} entity\n")
            for _ in range(links):
                tt = t if rng.random() < 0.85 else rng.integers(0, topics)
                g = rng.integers(0, tags_pt)
                lines.append(f"{en} t{tt * tags_pt + g} 1\n")
    for t in range(topics * tags_pt):
        field.append(f"t{t} tag\n")
    _write(train_path, field_path, lines, field)


def make_fine_dataset(train_path: str, field_path: str, genres: int = 20,
                      users_pg: int = 150,
                      items_pg: int = FINE_ITEMS_PER_GENRE,
                      links: int = 12) -> None:
    """The user-item graph with genre communities (two fields); does nothing
    when the training file exists."""
    if os.path.exists(train_path):
        return
    rng = np.random.default_rng(SEED + 2)
    lines, field = [], []
    for gidx in range(genres):
        for u in range(users_pg):
            un = f"u{gidx * users_pg + u}"
            field.append(f"{un} user\n")
            for _ in range(links):
                gg = gidx if rng.random() < 0.85 else rng.integers(0, genres)
                i = rng.integers(0, items_pg)
                lines.append(f"{un} i{gg * items_pg + i} 1\n")
    for i in range(genres * items_pg):
        field.append(f"i{i} item\n")
    _write(train_path, field_path, lines, field)


def auc(pos, neg) -> float:
    pos, neg = np.asarray(pos, np.float64), np.asarray(neg, np.float64)
    return float((pos[:, None] > neg[None, :]).mean()
                 + 0.5 * (pos[:, None] == neg[None, :]).mean())


def load_emb(path: str):
    """(name -> row, the float64 table) of a saved embedding file."""
    names, rows = [], []
    with open(path) as f:
        f.readline()
        for line in f:
            p = line.rstrip().split(" ")
            if len(p) < 2:
                continue
            names.append(p[0])
            rows.append(np.asarray(p[1:], dtype=np.float64))
    return dict(zip(names, range(len(names)))), np.stack(rows)


def topic_auc(emb_file: str, prefix: str, labels_of: Callable[[str], int],
              n_pairs: int = 4000, seed: int = 0) -> float:
    """Same-topic against different-topic cosine AUC over the rows whose
    name starts with ``prefix``."""
    name2row, emb = load_emb(emb_file)
    emb = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-12)
    names = [nm for nm in name2row if nm.startswith(prefix)]
    rows = np.array([name2row[nm] for nm in names])
    labs = np.array([labels_of(nm) for nm in names])
    rng = np.random.default_rng(seed)
    a = rng.integers(0, len(rows), n_pairs * 6)
    b = rng.integers(0, len(rows), n_pairs * 6)
    keep = a != b
    a, b = a[keep], b[keep]
    s = (emb[rows[a]] * emb[rows[b]]).sum(1)
    same = labs[a] == labs[b]
    return auc(s[same][:n_pairs], s[~same][:n_pairs][:2000])
