"""Knowledge-graph store: (head, relation, tail, weight) triples.

Port of ``smore_tpu/graph/knowledge.py``, host numpy and bit-equal to it:
entity and relation interning in first-appearance order, the triples as
parallel arrays, and the per-relation entity pools (every entity seen as
head or tail of relation r) flattened into (rel_indptr, rel_entities)
segments, so that a corrupted entity is one uniform draw inside the
relation's segment on the device. File format: ``head relation tail
[weight]``, whitespace-split, the weight 1.0 when absent.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np


@dataclass
class KnowledgeGraph:
    heads: np.ndarray  # (T,) int32
    relations: np.ndarray  # (T,) int32
    tails: np.ndarray  # (T,) int32
    weights: np.ndarray  # (T,) float32
    entities: List[str]
    relations_names: List[str]
    entity2id: Dict[str, int]
    relation2id: Dict[str, int]
    # per-relation entity pools, flattened
    rel_indptr: np.ndarray  # (R+1,) int64
    rel_entities: np.ndarray  # (S,) int32

    @property
    def n_entities(self) -> int:
        return len(self.entities)

    @property
    def n_relations(self) -> int:
        return len(self.relations_names)

    @property
    def n_triples(self) -> int:
        return len(self.heads)

    @staticmethod
    def load_triples(path: str) -> "KnowledgeGraph":
        e2i: Dict[str, int] = {}
        r2i: Dict[str, int] = {}
        ents: List[str] = []
        rels: List[str] = []
        h_l, r_l, t_l, w_l = [], [], [], []

        def intern(table, names, s):
            i = table.get(s)
            if i is None:
                i = len(names)
                table[s] = i
                names.append(s)
            return i

        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 3:
                    continue
                h = intern(e2i, ents, parts[0])
                r = intern(r2i, rels, parts[1])
                t = intern(e2i, ents, parts[2])
                w = 1.0
                if len(parts) >= 4:
                    try:
                        w = float(parts[3])
                    except ValueError:
                        pass
                h_l.append(h)
                r_l.append(r)
                t_l.append(t)
                w_l.append(w)

        heads = np.asarray(h_l, dtype=np.int32)
        relations = np.asarray(r_l, dtype=np.int32)
        tails = np.asarray(t_l, dtype=np.int32)

        # per-relation entity pools: unique entities seen with relation r
        pairs = np.unique(
            np.concatenate(
                [
                    np.stack([relations, heads], axis=1),
                    np.stack([relations, tails], axis=1),
                ]
            ),
            axis=0,
        )
        n_rel = len(rels)
        rel_indptr = np.searchsorted(
            pairs[:, 0], np.arange(n_rel + 1)
        ).astype(np.int64)

        return KnowledgeGraph(
            heads=heads,
            relations=relations,
            tails=tails,
            weights=np.asarray(w_l, dtype=np.float32),
            entities=ents,
            relations_names=rels,
            entity2id=e2i,
            relation2id=r2i,
            rel_indptr=rel_indptr,
            rel_entities=pairs[:, 1].astype(np.int32),
        )
