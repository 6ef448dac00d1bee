"""The benchmark's frozen copies held to the program's originals at small
sizes: the two graph generators (array form), the in-memory graph against
``Graph.load_edge_list`` of the same edges as text, the community-AUC
probe, and the operation and byte counts of ``chip_smoke.py``."""

import importlib.util
import os

import numpy as np
import pytest

from perfbench.harness import flops, graphs, probes

from conftest import ROOT


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_perfbench", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


LAWS = [
    ("youtube", "make_youtube_graph", dict(n=20_000, e=50_000, n_comm=30),
     11),
    ("community", "make_graph", dict(n=3_000, e=40_000, n_comm=20), 5),
]


@pytest.mark.parametrize("law,original,size,seed", LAWS)
def test_graph_equals_the_text_load(tmp_path, law, original, size, seed):
    """intern(generator) through Graph.from_arrays is the graph that
    Graph.load_edge_list reads from the original generator's text."""
    from smore_tpu_torch.graph.graph import Graph
    from smore_tpu_torch.utils import bench_graphs

    path = str(tmp_path / "net.txt")
    getattr(bench_graphs, original)(path, seed=seed, **size)
    want = Graph.load_edge_list(path, undirected=True)
    a = graphs.make({"law": law, **size}, seed)
    got = Graph.from_arrays(a.src, a.dst, a.weights, a.names, a.name2id)
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.weights, want.weights)
    assert got.names == want.names
    assert got.name2id == want.name2id
    # the pure-Python loader agrees too
    py = Graph.load_edge_list(path, undirected=True, use_native=False)
    np.testing.assert_array_equal(got.indices, py.indices)
    assert got.names == py.names


def test_labels_are_the_generators_first_draw():
    """The planted labels come with the graph: vertex i's is the community
    of its number, as the original probes look it up."""
    from smore_tpu_torch.utils.bench_graphs import YT_N_COMM

    a = graphs.make({"law": "community", "n": 50_000, "e": 20_000,
                     "n_comm": 100}, 0)
    want = np.random.default_rng(0).integers(0, 100, 50_000)
    np.testing.assert_array_equal(a.label, want[a.number])
    y = graphs.youtube_graph(1_100_000, 2_000, YT_N_COMM, 7)
    from smore_tpu_torch.utils.bench_graphs import yt_labels

    np.testing.assert_array_equal(y.comm, yt_labels())


def test_probe_equals_the_originals():
    from smore_tpu_torch.utils.bench_graphs import yt_community_auc, yt_labels

    rng = np.random.default_rng(3)
    numbers = rng.choice(1_100_000, 5_000, replace=False)
    emb = rng.standard_normal((5_000, 16)).astype(np.float32)
    names = [f"u{i}" for i in numbers]
    assert probes.community_auc(emb, yt_labels()[numbers], n_pairs=20_000) \
        == yt_community_auc(emb, names, n_pairs=20_000)
    cs = _chip_smoke()
    a = graphs.make({"law": "community", "n": 50_000, "e": 200_000,
                     "n_comm": 100}, 0)
    emb = rng.standard_normal((len(a.names), 16)).astype(np.float32)
    assert probes.community_auc(emb, a.label, n_pairs=20_000) \
        == cs.community_auc_50k(emb, a.names, n_pairs=20_000)


def test_counts_equal_chip_smokes():
    cs = _chip_smoke()
    assert (flops.PEAK_F32, flops.PEAK_BYTES) == (cs.PEAK_F32, cs.PEAK_BYTES)
    for samples, ks, d in ((32_768, 128, 64), (2_048, 256, 64), (7, 5, 8)):
        assert flops.sgns_flops(samples, ks, d) == cs._sgns_flops(samples, ks,
                                                                  d)
    for f, b in ((1.619e9, 18.26e6), (2.0e6, 9.0e8)):
        want = cs._bound("x", f, b)
        assert flops.bound_ms(f, b) == (want["bound_ms"], want["bound_by"])
    # phase_banded's K4 byte count, at its constants
    src = open(os.path.join(ROOT, "chip_smoke.py")).read()
    assert ("nbytes = (2 * rows * D + 2 * S * KS * D) * 4 "
            "+ S * (2 * B + 3) * 4") in src
    rows = 40_000
    S, B, KS, D = cs.S, cs.B, cs.KS, cs.D
    assert flops.k4_bytes(rows, S, B, KS, D) == (
        (2 * rows * D + 2 * S * KS * D) * 4 + S * (2 * B + 3) * 4)


@pytest.mark.parametrize("length,window", [(41, 5), (6, 5), (3, 1)])
def test_pairs_per_walk_is_the_mappers_mean(length, window):
    """The expected pairs of a walk: the mapper's masked slots averaged
    over each center's window U{1..window}."""
    import torch

    from perfbench.reference.laws import window_count_moments
    from smore_tpu_torch.sampling.mappers import skipgram_pairs

    walk = torch.arange(length, dtype=torch.int32)[None, :]
    per_r = []
    for r in range(1, window + 1):
        reduce = torch.full((1, length), r)
        _, _, mask = skipgram_pairs(walk, None, window, reduce=reduce)
        per_r.append(mask.reshape(length, -1).sum(1))
    per_center = torch.stack(per_r).double()  # (window, length)
    mean = float(per_center.mean(0).sum())
    var = float(per_center.var(0, unbiased=False).sum())
    assert window_count_moments(length, window) == pytest.approx(
        (mean, var), rel=1e-12)
