"""Signed network store: separate positive and negative edge lists.

Port of ``smore_tpu/graph/signed.py``, host numpy and bit-equal to it:
``src dst sign [weight]`` lines; the sign accepts +1/1/pos/positive,
-1/neg/negative, or any number (its sign taken); undirected doubles each
edge.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

_POS = {"+1", "1", "pos", "positive"}
_NEG = {"-1", "neg", "negative"}


@dataclass
class SignedNetwork:
    names: List[str]
    name2id: Dict[str, int]
    pos_src: np.ndarray  # (Ep,)
    pos_dst: np.ndarray
    pos_w: np.ndarray
    neg_src: np.ndarray  # (En,)
    neg_dst: np.ndarray
    neg_w: np.ndarray

    @property
    def n_vertices(self) -> int:
        return len(self.names)

    @staticmethod
    def load_edge_list(path: str, undirected: bool = True) -> "SignedNetwork":
        name2id: Dict[str, int] = {}
        names: List[str] = []
        ps, pd, pw, ns, nd, nw = [], [], [], [], [], []

        def intern(s):
            i = name2id.get(s)
            if i is None:
                i = len(names)
                name2id[s] = i
                names.append(s)
            return i

        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 3:
                    continue
                a, b = intern(parts[0]), intern(parts[1])
                s = parts[2].lower()
                if s in _POS:
                    sign = 1.0
                elif s in _NEG:
                    sign = -1.0
                else:
                    try:
                        sign = 1.0 if float(s) > 0 else -1.0
                    except ValueError:
                        print(f"[smore-tpu] invalid sign: {parts[2]!r}")
                        continue
                w = 1.0
                if len(parts) >= 4:
                    try:
                        w = float(parts[3])
                    except ValueError:
                        pass
                dest = (ps, pd, pw) if sign > 0 else (ns, nd, nw)
                dest[0].append(a)
                dest[1].append(b)
                dest[2].append(w)
                if undirected:
                    dest[0].append(b)
                    dest[1].append(a)
                    dest[2].append(w)

        return SignedNetwork(
            names=names,
            name2id=name2id,
            pos_src=np.asarray(ps, dtype=np.int32),
            pos_dst=np.asarray(pd, dtype=np.int32),
            pos_w=np.asarray(pw, dtype=np.float32),
            neg_src=np.asarray(ns, dtype=np.int32),
            neg_dst=np.asarray(nd, dtype=np.int32),
            neg_w=np.asarray(nw, dtype=np.float32),
        )
