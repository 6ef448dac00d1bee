"""The port's copy of the JODIE and SASRec-family quality sets and their
evaluation (smore_tpu_torch/utils/seq_data.py) against
experiments/go_oracle_parity.py (``make_interactions``, ``_jodie_eval``)
and experiments/sasrec_eval.py (``make_data``): the same files byte for
byte from the same seeds, the same scores of the same tables."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from smore_tpu_torch.graph.bipartite import InteractionGraph
from smore_tpu_torch.utils import seq_data as sd

torch.set_num_threads(1)

EXPERIMENTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "experiments")


def _module(name):
    if EXPERIMENTS not in sys.path:
        sys.path.insert(0, EXPERIMENTS)
    spec = importlib.util.spec_from_file_location(
        f"_{name}", os.path.join(EXPERIMENTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def gp():
    return _module("go_oracle_parity")


@pytest.fixture(scope="module")
def se():
    return _module("sasrec_eval")


def test_constants_match(gp, se):
    assert sd.SEED == gp.SEED
    assert (sd.N_ITEMS, sd.N_USERS, sd.SEQ_LEN) == (se.N_ITEMS, se.N_USERS,
                                                   se.SEQ_LEN)
    # the gates' training settings are sasrec_eval's full-autodiff arm
    assert sd.SEQ_TRAIN["epochs"] == se.EPOCHS
    assert sd.SEQ_TRAIN["alpha"] == se.ALPHA and sd.SEQ_NEG == se.NEG_K


@pytest.mark.parametrize("kw", [{}, dict(users=9, items=13, clusters=3,
                                          events=500)])
def test_make_interactions_byte_equal(gp, tmp_path, kw):
    ours, theirs = str(tmp_path / "ours.txt"), str(tmp_path / "theirs.txt")
    assert sd.make_interactions(ours, **kw) == ours
    gp.make_interactions(theirs, **kw)
    assert open(ours, "rb").read() == open(theirs, "rb").read()


@pytest.mark.parametrize("seed", [0, 3])
def test_make_data_byte_equal(se, tmp_path, seed):
    ours, theirs = str(tmp_path / "ours.txt"), str(tmp_path / "theirs.txt")
    sd.make_data(ours, seed=seed)
    se.make_data(theirs, seed=seed)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    # an existing file is kept
    with open(ours, "w") as f:
        f.write("u0 i0 1\n")
    sd.make_data(ours, seed=seed)
    assert open(ours).read() == "u0 i0 1\n"


@pytest.mark.parametrize("tail", [1000, 37])
def test_jodie_eval_same_scores(gp, tmp_path, tail):
    ig = InteractionGraph.load_interactions(sd.make_interactions(
        str(tmp_path / "i.txt"), events=900))
    rng = np.random.default_rng(1)
    ue = rng.standard_normal((ig.n_users, 8))
    ie = rng.standard_normal((ig.n_items, 8))
    want = gp._jodie_eval(ue, ie, ig.user_ids, ig.item_ids, ig.n_items,
                          tail=tail)
    assert sd.jodie_eval(ue, ie, ig.user_ids, ig.item_ids, ig.n_items,
                         tail=tail) == want


@pytest.mark.parametrize("features", [0, 3])
def test_interaction_arrays_follow_make_interactions_law(tmp_path, features):
    """The bulk draw of the Wikipedia-shaped set: users uniform, each item
    in its user's cluster (item % clusters == user % clusters), times
    strictly rising by U[0, 1), features U[0, 1); and its store equals the
    loader's on a file of the same events."""
    u, i, t, f = sd.interaction_arrays(users=50, items=31, clusters=4,
                                       events=4000, features=features)
    assert u.min() >= 0 and u.max() < 50 and i.min() >= 0 and i.max() < 31
    assert (i % 4 == u % 4).all()
    assert (np.diff(t) > 0).all() and (np.diff(t) < 1).all()
    counts = np.bincount(u, minlength=50)
    assert counts.min() > 40 and counts.max() < 120  # 80 a user expected
    assert (f is None) == (features == 0)
    if features:
        assert f.shape == (4000, 3) and f.dtype == np.float32
        assert 0 <= f.min() and f.max() < 1
    ig = InteractionGraph.from_events(u, i, t, f)
    path = tmp_path / "ev.txt"
    cols = [u, i, t] + ([] if f is None else [f[:, k] for k in range(3)])
    path.write_text("".join(
        f"u{a} i{b} {float(c)!r}" + "".join(f" {float(x)!r}" for x in rest)
        + "\n"
        for a, b, c, *rest in zip(*cols)))
    want = InteractionGraph.load_interactions(str(path))
    for got, ref in ((ig.users, want.users), (ig.items, want.items)):
        assert set(ref) <= set(got)
    names = np.array(ig.users)[ig.user_ids]
    assert (names == np.array(want.users)[want.user_ids]).all()
    names = np.array(ig.items)[ig.item_ids]
    assert (names == np.array(want.items)[want.item_ids]).all()
    assert np.array_equal(ig.timestamps, want.timestamps)
    if features:
        assert np.array_equal(ig.features, want.features)
    else:
        assert ig.features is None and want.features is None
    for k in range(ig.n_users):  # per-user event lists in time order
        ev = ig.user_interactions(k)
        assert (ig.user_ids[ev] == k).all() and (np.diff(ev) > 0).all()


def test_wikipedia_shape():
    assert sd.WIKIPEDIA == dict(users=8227, items=1000, events=157474,
                                features=172)
