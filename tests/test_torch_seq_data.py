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
