"""The port's banded draws on the device (the CPU here) against the exact
sampling law.

torch's generator and JAX's threefry give different numbers, so the draws
are held to the law, as tests/test_banded.py and tests/test_hoisted_draws.py
hold the JAX package's: stratum frequencies against the stratum mass,
band-local rows in range, every drawn pair a real edge of its stratum, the
conditional pair law inside a stratum, and the negatives against deg^0.75."""

import numpy as np
import pytest
import torch

from smore_tpu_torch.graph.graph import Graph
from smore_tpu_torch.models.line import multiblock_draw
from smore_tpu_torch.sampling.banded import BandedTables
from smore_tpu_torch.sampling.tables import _vertex_distribution

BAND = 64


@pytest.fixture(scope="module")
def graph():
    """200-vertex 4-community graph with weighted edges."""
    rng = np.random.default_rng(3)
    edges = []
    for _ in range(3000):
        c = rng.integers(0, 4)
        if rng.random() < 0.9:
            a, b = rng.integers(0, 50, 2) + 50 * c
        else:
            a, b = rng.integers(0, 200, 2)
        if a != b:
            edges.append((f"v{a}", f"v{b}", float(rng.integers(1, 4))))
    return Graph.from_edges(edges, undirected=True)


def _joint_law(g, power=0.75):
    src = np.repeat(np.arange(g.n_vertices), np.diff(g.indptr))
    vmass = _vertex_distribution(g, "out_degrees").astype(np.float64) ** power
    w = np.asarray(g.weights, dtype=np.float64) ** power
    z = np.zeros(g.n_vertices)
    np.add.at(z, src, w)
    return src, np.asarray(g.indices), (vmass[src] / vmass.sum()) * (
        w / z[src])


def _tables(g, stream, min_len=4096):
    bt = BandedTables.build(g, band_size=BAND, two_d=True)
    return bt.build_stream(mult=4, min_len=min_len, seed=0) if stream else bt


def _gen(seed):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return gen


@pytest.mark.parametrize("stream", [True, False])
def test_stratum_frequencies_match_mass(graph, stream):
    g = graph
    bt = _tables(g, stream)
    nb = bt.n_bands
    src, dst, jw = _joint_law(g)
    strat_p = np.zeros(nb * nb)
    np.add.at(strat_p, (src // BAND) * nb + dst // BAND, jw)
    steps = 6000
    sb, db, *_ = multiblock_draw(bt, _gen(0), 32, 8, steps)
    s = (sb.numpy() // BAND) * nb + db.numpy() // BAND
    emp = np.bincount(s, minlength=nb * nb) / steps
    sd = np.sqrt(strat_p * (1 - strat_p) / steps)
    assert (np.abs(emp - strat_p) < 4 * sd + 1e-12).all()


@pytest.mark.parametrize("stream", [True, False])
def test_band_local_pairs_are_edges_of_their_stratum(graph, stream):
    """Rows are band-local and in range, and each lifted (src, pos) pair is
    an edge of the graph: a stream window that ran outside its stratum's
    run would lift another stratum's entries to non-edges."""
    g = graph
    bt = _tables(g, stream)
    sb, db, src_l, pos_l, negs = multiblock_draw(bt, _gen(1), 128, 16, 300)
    assert src_l.dtype == pos_l.dtype == torch.int32
    assert src_l.shape == pos_l.shape == (300, 128)
    assert negs.shape == (300, 16)
    for t in (src_l, pos_l):
        assert int(t.min()) >= 0 and int(t.max()) < BAND
    src = (sb[:, None] + src_l).numpy().ravel()
    pos = (db[:, None] + pos_l).numpy().ravel()
    assert src.max() < g.n_vertices and pos.max() < g.n_vertices
    esrc = np.repeat(np.arange(g.n_vertices), np.diff(g.indptr))
    edges = set(zip(esrc.tolist(), g.indices.tolist()))
    assert all(p in edges for p in zip(src.tolist(), pos.tolist()))


@pytest.mark.parametrize("stream", [True, False])
def test_conditional_pair_law_in_a_stratum(graph, stream):
    """Stream entries are iid draws, so any window is too; a run of 200k
    entries per stratum keeps the stream's own finite-sample noise (which
    the default 4096-entry runs would show) well under the TV bound."""
    g = graph
    bt = _tables(g, stream, min_len=200_000)
    nb = bt.n_bands
    src, dst, jw = _joint_law(g)
    strat = (src // BAND) * nb + dst // BAND
    sb, db, src_l, pos_l, _ = multiblock_draw(bt, _gen(2), 2048, 8, 400)
    s = (sb.numpy() // BAND) * nb + db.numpy() // BAND
    top = int(np.bincount(s).argmax())
    rows = s == top
    es = (sb[:, None] + src_l).numpy()[rows].ravel()
    ep = (db[:, None] + pos_l).numpy()[rows].ravel()
    n = g.n_vertices
    emp = np.bincount(es * n + ep, minlength=n * n).astype(np.float64)
    want = np.zeros(n * n)
    sel = strat == top
    np.add.at(want, src[sel] * n + dst[sel], jw[sel])
    tv = 0.5 * np.abs(emp / emp.sum() - want / want.sum()).sum()
    assert tv < 0.05, f"conditional TV {tv:.4f} in stratum {top}"


def test_negatives_follow_degree_law(graph):
    """Chi-squared of the shared negatives against deg^0.75; the bound is
    the statistic's mean plus 5 standard deviations."""
    g = graph
    bt = _tables(g, True)
    *_, negs = multiblock_draw(bt, _gen(3), 16, 2048, 64)
    counts = np.bincount(negs.numpy().ravel(), minlength=g.n_vertices)
    p = (g.out_degree + g.in_degree) ** 0.75
    p = p / p.sum()
    exp = p * counts.sum()
    chi2 = ((counts - exp) ** 2 / exp).sum()
    dof = g.n_vertices - 1
    assert chi2 < dof + 5 * np.sqrt(2 * dof), chi2
