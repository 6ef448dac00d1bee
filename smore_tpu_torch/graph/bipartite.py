"""Bipartite interaction store: timestamped user-item events.

Port of ``smore_tpu/graph/bipartite.py``, host numpy and bit-equal to it:
``user item timestamp [features...]`` lines; users and items interned
SEPARATELY in first-appearance order; the events as parallel arrays in a
stable float64 time sort (timestamps then cast to float32); features padded
with zeros or truncated to the first line's width; per-user and per-item
event lists as (indptr, order) groupings that keep time order; window
queries that bisect the float32 timestamps.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class InteractionGraph:
    users: List[str]
    items: List[str]
    user2id: Dict[str, int]
    item2id: Dict[str, int]
    user_ids: np.ndarray  # (T,) int32, time-sorted
    item_ids: np.ndarray  # (T,)
    timestamps: np.ndarray  # (T,) float32
    features: Optional[np.ndarray]  # (T, F) or None
    user_indptr: np.ndarray  # (U+1,)
    user_order: np.ndarray  # (T,) interaction idx grouped by user, by time
    item_indptr: np.ndarray  # (I+1,)
    item_order: np.ndarray

    @property
    def n_users(self) -> int:
        return len(self.users)

    @property
    def n_items(self) -> int:
        return len(self.items)

    @property
    def n_interactions(self) -> int:
        return len(self.timestamps)

    @property
    def feature_dim(self) -> int:
        return 0 if self.features is None else self.features.shape[1]

    @property
    def min_time(self) -> float:
        return float(self.timestamps[0]) if len(self.timestamps) else 0.0

    @property
    def max_time(self) -> float:
        return float(self.timestamps[-1]) if len(self.timestamps) else 0.0

    def user_interactions(self, uid: int) -> np.ndarray:
        return self.user_order[self.user_indptr[uid]:self.user_indptr[uid + 1]]

    def item_interactions(self, iid: int) -> np.ndarray:
        return self.item_order[self.item_indptr[iid]:self.item_indptr[iid + 1]]

    def user_interactions_before(self, uid: int, t: float) -> np.ndarray:
        """Interaction indices of ``uid`` with timestamp < t, in time
        order."""
        idx = self.user_interactions(uid)
        k = int(np.searchsorted(self.timestamps[idx], np.float32(t),
                                side="left"))
        return idx[:k]

    def item_interactions_before(self, iid: int, t: float) -> np.ndarray:
        """Interaction indices of ``iid`` with timestamp < t."""
        idx = self.item_interactions(iid)
        k = int(np.searchsorted(self.timestamps[idx], np.float32(t),
                                side="left"))
        return idx[:k]

    def last_user_interaction(self, uid: int, t: float) -> int:
        """The most recent interaction index of ``uid`` before t, or -1."""
        idx = self.user_interactions_before(uid, t)
        return int(idx[-1]) if len(idx) else -1

    def last_item_interaction(self, iid: int, t: float) -> int:
        """The most recent interaction index of ``iid`` before t, or -1."""
        idx = self.item_interactions_before(iid, t)
        return int(idx[-1]) if len(idx) else -1

    def window(self, t0: float, t1: float) -> Tuple[int, int]:
        """Global interaction index range with t0 <= ts < t1."""
        lo = int(np.searchsorted(self.timestamps, t0, side="left"))
        hi = int(np.searchsorted(self.timestamps, t1, side="left"))
        return lo, hi

    @staticmethod
    def load_interactions(path: str) -> "InteractionGraph":
        user2id: Dict[str, int] = {}
        item2id: Dict[str, int] = {}
        users: List[str] = []
        items: List[str] = []
        u_l, i_l, t_l, f_l = [], [], [], []
        feat_dim = None

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
                try:
                    ts = float(parts[2])
                except ValueError:
                    continue
                feats = []
                for p in parts[3:]:
                    try:
                        feats.append(float(p))
                    except ValueError:
                        pass
                if feat_dim is None:
                    feat_dim = len(feats)
                u_l.append(intern(user2id, users, parts[0]))
                i_l.append(intern(item2id, items, parts[1]))
                t_l.append(ts)
                f_l.append(feats[:feat_dim] + [0.0] * (feat_dim - len(feats)))

        ts = np.asarray(t_l, dtype=np.float64)
        order = np.argsort(ts, kind="stable")
        uid = np.asarray(u_l, dtype=np.int32)[order]
        iid = np.asarray(i_l, dtype=np.int32)[order]
        ts = ts[order].astype(np.float32)
        feats = np.asarray(f_l, dtype=np.float32)[order] if feat_dim else None

        return InteractionGraph._build(users, items, user2id, item2id, uid,
                                       iid, ts, feats)

    @staticmethod
    def from_events(user_ids: np.ndarray, item_ids: np.ndarray,
                    timestamps: np.ndarray,
                    features: Optional[np.ndarray] = None
                    ) -> "InteractionGraph":
        """The store of events given as arrays: dense user and item ids
        (named ``u<id>`` / ``i<id>``, ids 0 .. max), timestamps and (T, F)
        features, sorted by time as the loader sorts them."""
        order = np.argsort(np.asarray(timestamps, np.float64), kind="stable")
        users = [f"u{k}" for k in range(int(user_ids.max(initial=-1)) + 1)]
        items = [f"i{k}" for k in range(int(item_ids.max(initial=-1)) + 1)]
        feats = (None if features is None or features.shape[1] == 0
                 else np.asarray(features, np.float32)[order])
        return InteractionGraph._build(
            users, items, {n: k for k, n in enumerate(users)},
            {n: k for k, n in enumerate(items)},
            np.asarray(user_ids, np.int32)[order],
            np.asarray(item_ids, np.int32)[order],
            np.asarray(timestamps, np.float64)[order].astype(np.float32),
            feats)

    @staticmethod
    def _build(users, items, user2id, item2id, uid, iid, ts, feats):
        def group(ids, n):
            o = np.argsort(ids, kind="stable")  # stable keeps time order
            indptr = np.searchsorted(ids[o], np.arange(n + 1)).astype(np.int64)
            return indptr, o.astype(np.int64)

        u_indptr, u_order = group(uid, len(users))
        i_indptr, i_order = group(iid, len(items))

        return InteractionGraph(
            users=users,
            items=items,
            user2id=user2id,
            item2id=item2id,
            user_ids=uid,
            item_ids=iid,
            timestamps=ts,
            features=feats,
            user_indptr=u_indptr,
            user_order=u_order,
            item_indptr=i_indptr,
            item_order=i_order,
        )
