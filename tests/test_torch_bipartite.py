"""The port's interaction store (smore_tpu_torch/graph/bipartite.py) against
smore_tpu/graph/bipartite.py: the same file loads bit-equal (separate user
and item interning, the stable float64 time sort, features padded or cut
to the first line's width, the per-user and per-item groupings), and every
window query answers the same, on files with ties in time, features, short
lines and unparsable fields."""

import numpy as np
import pytest
import torch

from smore_tpu.graph.bipartite import InteractionGraph as JaxIG
from smore_tpu_torch.graph.bipartite import InteractionGraph

# one intra-op thread, as in every port test file: test workers share the
# cores
torch.set_num_threads(1)

FIELDS = ("user_ids", "item_ids", "timestamps", "features", "user_indptr",
          "user_order", "item_indptr", "item_order")


def _write(path, seed, features: bool, events=160):
    """Events with many exact time ties, users and items that share names
    ("x1" is a user and an item), short and unparsable lines, and feature
    rows shorter, longer and partly non-numeric against the first's."""
    rng = np.random.default_rng(seed)
    lines = ["x1 x1 0.5 1.0 2.0\n" if features else "x1 x1 0.5\n"]
    t = 0.0
    for e in range(events):
        if rng.random() < 0.6:  # else a tie with the previous event
            t += float(rng.integers(0, 4)) * 0.25
        ts = t if rng.random() < 0.9 else t - float(rng.integers(1, 5))
        line = f"u{rng.integers(0, 9)} x{rng.integers(0, 12)} {ts}"
        if features:
            nf = int(rng.integers(0, 4))
            feats = [f"{v:.3f}" for v in rng.random(nf)]
            if nf and rng.random() < 0.2:
                feats[0] = "nan?"
            line += " " + " ".join(feats)
        lines.append(line + "\n")
        if e % 37 == 0:
            lines.append("lonely x2\n")  # under 3 fields: skipped
        if e % 41 == 0:
            lines.append("u1 x3 not-a-time 1.0\n")  # skipped
    path.write_text("".join(lines))
    return str(path)


@pytest.mark.parametrize("seed,features", [(0, True), (1, True),
                                           (2, False), (3, False)])
def test_load_interactions_bit_equal(tmp_path, seed, features):
    p = _write(tmp_path / "events.txt", seed, features)
    theirs, ours = JaxIG.load_interactions(p), InteractionGraph.load_interactions(p)
    assert ours.users == theirs.users and ours.items == theirs.items
    assert ours.user2id == theirs.user2id and ours.item2id == theirs.item2id
    for name in FIELDS:
        a, b = getattr(ours, name), getattr(theirs, name)
        if b is None:
            assert a is None
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name
    assert (ours.n_users, ours.n_items, ours.n_interactions,
            ours.feature_dim) == (theirs.n_users, theirs.n_items,
                                  theirs.n_interactions, theirs.feature_dim)
    assert ours.feature_dim == (2 if features else 0)
    assert (ours.min_time, ours.max_time) == (theirs.min_time,
                                              theirs.max_time)
    # the time sort is stable: tied events keep file order
    assert np.all(np.diff(ours.timestamps) >= 0)


@pytest.mark.parametrize("seed", [0, 2])
def test_window_queries_agree(tmp_path, seed):
    p = _write(tmp_path / "events.txt", seed, features=seed == 0)
    theirs, ours = JaxIG.load_interactions(p), InteractionGraph.load_interactions(p)
    ts = ours.timestamps
    # every event time (ties included), points between them, and the ends
    probes = np.unique(np.concatenate([ts, ts + 0.125, [ts[0] - 1.0,
                                                        ts[-1] + 1.0]]))
    for t in probes.tolist():
        for u in range(ours.n_users):
            assert np.array_equal(ours.user_interactions_before(u, t),
                                  theirs.user_interactions_before(u, t))
            assert (ours.last_user_interaction(u, t)
                    == theirs.last_user_interaction(u, t))
        for i in range(ours.n_items):
            assert np.array_equal(ours.item_interactions_before(i, t),
                                  theirs.item_interactions_before(i, t))
            assert (ours.last_item_interaction(i, t)
                    == theirs.last_item_interaction(i, t))
        for t1 in (t, t + 0.5, t + 10.0):
            assert ours.window(t, t1) == theirs.window(t, t1)
    for u in range(ours.n_users):
        assert np.array_equal(ours.user_interactions(u),
                              theirs.user_interactions(u))
    for i in range(ours.n_items):
        assert np.array_equal(ours.item_interactions(i),
                              theirs.item_interactions(i))


def test_groupings_keep_time_order(tmp_path):
    ig = InteractionGraph.load_interactions(
        _write(tmp_path / "events.txt", 4, features=True))
    for u in range(ig.n_users):
        idx = ig.user_interactions(u)
        assert np.all(ig.user_ids[idx] == u) and np.all(np.diff(idx) > 0)
    for i in range(ig.n_items):
        idx = ig.item_interactions(i)
        assert np.all(ig.item_ids[idx] == i) and np.all(np.diff(idx) > 0)
    assert ig.user_indptr[-1] == ig.item_indptr[-1] == ig.n_interactions
