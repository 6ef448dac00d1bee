"""The port's copy of the benchmark graphs (smore_tpu_torch/utils/
bench_graphs.py) against bench.py's originals: the same files, byte for
byte, and the same community AUC, at small sizes."""

import os
import sys

import numpy as np
import pytest

from smore_tpu_torch.utils import bench_graphs

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import bench  # noqa: E402  (numpy only at import)


@pytest.mark.parametrize("maker,kw", [
    ("make_graph", dict(n=500, e=4000, n_comm=10, seed=0)),
    ("make_graph", dict(n=2000, e=9000, n_comm=100, seed=3)),
    ("make_youtube_graph", dict(n=3000, e=8000, n_comm=20, seed=7)),
    ("make_youtube_graph", dict(n=20_000, e=30_000, n_comm=100, seed=1)),
])
def test_graph_files_are_byte_equal(tmp_path, maker, kw):
    ours, theirs = tmp_path / "ours.txt", tmp_path / "theirs.txt"
    getattr(bench_graphs, maker)(str(ours), **kw)
    getattr(bench, maker)(str(theirs), **kw)
    data = ours.read_bytes()
    assert data and data == theirs.read_bytes()
    # an existing file is left as it is
    getattr(bench_graphs, maker)(str(ours), n=10, e=10)
    assert ours.read_bytes() == data


def test_yt_labels_and_auc_match(tmp_path):
    assert np.array_equal(bench_graphs.yt_labels(), bench.yt_labels())
    path = tmp_path / "yt.txt"
    bench_graphs.make_youtube_graph(str(path), n=4000, e=10_000)
    names = sorted({tok for line in path.read_text().splitlines()
                    for tok in line.split()[:2]})
    rng = np.random.default_rng(0)
    lab = bench.yt_labels()[[int(nm[1:]) for nm in names]]
    # embeddings that carry the labels, with noise: an AUC between 0.5 and 1
    centre = rng.normal(size=(100, 8))
    emb = (centre[lab] + rng.normal(size=(len(names), 8))).astype(np.float32)
    ours = bench_graphs.yt_community_auc(emb, names, n_pairs=5000)
    assert ours == bench.yt_community_auc(emb, names, n_pairs=5000)
    assert 0.5 < ours < 1.0
