"""The port's copy of the rec quality dataset and scorer
(smore_tpu_torch/utils/rec_data.py) against experiments/bpr_parity.py and
experiments/longtail_parity.py: the same files byte for byte from the same
seed, the same AUC and recall@10, and the same label-order tables read
back from a saved embedding file."""

import importlib.util
import os
import sys

import numpy as np
import pytest

from smore_tpu_torch.io.embeddings import save_embeddings
from smore_tpu_torch.utils import rec_data

EXPERIMENTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "experiments")


def _load(name):
    """An experiments/ script as a module (its imports need the folder on
    the path)."""
    if EXPERIMENTS not in sys.path:
        sys.path.insert(0, EXPERIMENTS)
    spec = importlib.util.spec_from_file_location(
        f"_rec_data_{name}", os.path.join(EXPERIMENTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(bpr_parity module, longtail_parity module, their files, the port's
    files), each pair written into a directory of its own."""
    d = tmp_path_factory.mktemp("rec")
    bp, lt = _load("bpr_parity"), _load("longtail_parity")
    theirs = {k: str(d / f"theirs_{k}") for k in ("train.txt", "test.npz",
                                                  "field.txt")}
    ours = {k: str(d / f"ours_{k}") for k in theirs}
    bp.TRAIN, bp.TEST = theirs["train.txt"], theirs["test.npz"]
    bp.make_dataset()
    lt.TRAIN, lt.FIELD = theirs["train.txt"], theirs["field.txt"]
    lt.make_field_file()
    rec_data.make_dataset(ours["train.txt"], ours["test.npz"])
    rec_data.make_field_file(ours["train.txt"], ours["field.txt"])
    return bp, lt, theirs, ours


def test_files_byte_equal(files):
    _, _, theirs, ours = files
    for k in ("train.txt", "field.txt"):
        with open(ours[k], "rb") as a, open(theirs[k], "rb") as b:
            data = a.read()
            assert data and data == b.read(), k
    a, b = np.load(ours["test.npz"]), np.load(theirs["test.npz"])
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with open(ours["train.txt"]) as f:
        assert sum(1 for _ in f) == len(a["tr_u"])
    # an existing file is left as it is
    rec_data.make_dataset(ours["train.txt"], ours["test.npz"], seed=5)
    with open(ours["train.txt"], "rb") as x, open(theirs["train.txt"],
                                                  "rb") as y:
        assert x.read() == y.read()


def test_evaluate_and_read_back_match(files, tmp_path):
    bp, _, _, ours = files
    rng = np.random.default_rng(0)
    d = bp.DIM
    ue = rng.standard_normal((rec_data.N_USERS, d)).astype(np.float32)
    ie = rng.standard_normal((rec_data.N_ITEMS, d)).astype(np.float32)
    # user rows leaning to their test items: AUC above 0.5
    t = np.load(ours["test.npz"])
    np.add.at(ue, t["te_u"], ie[t["te_i"]] * 0.2)
    got = rec_data.evaluate(ours["test.npz"], ue, ie)
    assert got == bp.evaluate(ue, ie)
    assert 0.5 < got[0] < 1.0 and 0.0 < got[1] < 1.0
    names = [f"u{k}" for k in range(rec_data.N_USERS)][::-1] + [
        f"i{k}" for k in range(rec_data.N_ITEMS)]
    table = np.concatenate([ue[::-1], ie])
    path = str(tmp_path / "emb.txt")
    save_embeddings(path, names, table)
    a, b = rec_data.load_embeddings_ui(path, d), bp.load_ref_embeddings(path)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    # the file holds 6 significant digits
    np.testing.assert_allclose(a[0], ue, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(a[1], ie, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(rec_data.split_by_name(names, table, d)[0],
                                  ue)
