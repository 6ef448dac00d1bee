"""The port's copy of the structured quality sets and their probe
(smore_tpu_torch/utils/structured_data.py) against
experiments/structured_parity.py, and ``rec_data.load_wide_embeddings``
against experiments/longtail_parity.py's: the same files byte for byte from
the same seeds, and the same scores of the same embedding files."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from smore_tpu_torch.io.embeddings import save_embeddings
from smore_tpu_torch.utils import rec_data
from smore_tpu_torch.utils import structured_data as sd

# one intra-op thread, as in every port test file: test workers share the
# cores
torch.set_num_threads(1)

EXPERIMENTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "experiments")


def _load(name):
    """An experiments/ script as a module (its imports need the folder on
    the path)."""
    if EXPERIMENTS not in sys.path:
        sys.path.insert(0, EXPERIMENTS)
    spec = importlib.util.spec_from_file_location(
        f"_structured_{name}", os.path.join(EXPERIMENTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# dataset -> (structured_parity's path constants, the port's maker)
SETS = {
    "gcn": (("GCN_TRAIN", "GCN_FIELD"), sd.make_gcn_dataset),
    "textgcn": (("TG_TRAIN", "TG_FIELD"), sd.make_textgcn_dataset),
    "fine": (("FINE_TRAIN", "FINE_FIELD"), sd.make_fine_dataset),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{set: (their (train, field), our (train, field))}, each written in a
    directory of its own by its own generator."""
    d = tmp_path_factory.mktemp("structured")
    sp = _load("structured_parity")
    out = {}
    for name, (consts, make) in SETS.items():
        theirs = tuple(str(d / f"theirs_{name}_{k}.txt")
                       for k in ("net", "field"))
        ours = tuple(str(d / f"ours_{name}_{k}.txt") for k in ("net", "field"))
        for c, path in zip(consts, theirs):
            setattr(sp, c, path)
        getattr(sp, f"make_{name}_dataset")()
        make(*ours)
        out[name] = (theirs, ours)
    return sp, out


@pytest.mark.parametrize("name", sorted(SETS))
def test_files_byte_equal(files, name):
    _, out = files
    theirs, ours = out[name]
    for a, b in zip(theirs, ours):
        with open(a, "rb") as x, open(b, "rb") as y:
            data = x.read()
            assert data and data == y.read(), (name, b)
    # an existing file is left as it is
    SETS[name][1](ours[0], ours[1], links=1)
    with open(theirs[0], "rb") as x, open(ours[0], "rb") as y:
        assert x.read() == y.read()


@pytest.mark.parametrize("name,prefix,per_topic", [
    ("gcn", "t", sd.GCN_TAGS_PER_TOPIC),
    ("textgcn", "d", sd.TEXTGCN_DOCS_PER_TOPIC),
    ("fine", "i", sd.FINE_ITEMS_PER_GENRE)])
def test_topic_auc_equal(files, tmp_path, name, prefix, per_topic):
    """Rows leaning toward their topic's direction: the same AUC, above
    chance, from both probes."""
    sp, out = files
    names = sorted({line.split()[0] for line in open(out[name][1][1])})
    rng = np.random.default_rng(0)
    topics = rng.standard_normal((40, 16))
    labels = sd.topic_of(per_topic)
    table = np.stack([topics[labels(nm) % 40] * 0.6
                      + rng.standard_normal(16) for nm in names])
    path = str(tmp_path / "emb.txt")
    save_embeddings(path, names, table.astype(np.float32))
    got = sd.topic_auc(path, prefix, labels)
    assert got == sp.topic_auc(path, prefix,
                               lambda nm: int(nm[1:]) // per_topic)
    assert 0.6 < got < 1.0


def test_load_wide_embeddings_equal(tmp_path):
    lt = _load("longtail_parity")
    rng = np.random.default_rng(1)
    names = [f"u{k}" for k in range(rec_data.N_USERS)][::-3] + [
        f"i{k}" for k in range(rec_data.N_ITEMS)][::2]
    table = rng.standard_normal((len(names), 12)).astype(np.float32)
    path = str(tmp_path / "wide.txt")
    save_embeddings(path, names, table)
    got, want = rec_data.load_wide_embeddings(path), lt.load_wide_embeddings(
        path)
    for g, w in zip(got, want):
        assert g.shape[1] == 12
        np.testing.assert_array_equal(g, w)
