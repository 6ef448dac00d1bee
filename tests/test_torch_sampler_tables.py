"""The port's SamplerTables against smore_tpu's.

``build`` is host numpy: its packed arrays are bit-equal to smore_tpu's for
every vertex and negative method. The draws run from a torch.Generator,
whose numbers differ from JAX's threefry, so each draw is held to its exact
law (chi-squared below its mean plus 5 standard deviations, as
tests/test_torch_banded_draws.py does), and the hoisted and grouped draws to
their shapes and group layout."""

import dataclasses

import numpy as np
import pytest
import torch

from smore_tpu.graph.graph import Graph as JGraph
from smore_tpu.sampling.tables import SamplerTables as JTables
from smore_tpu_torch.graph.graph import Graph
from smore_tpu_torch.sampling.tables import SamplerTables

# one intra-op thread: test workers share the cores, and a thread pool
# in each of them oversubscribes the CPU on these tiny shapes
torch.set_num_threads(1)

CPU = torch.device("cpu")  # the port defaults to the card
TOY = [("userA", "itemA", 3.0), ("userA", "itemC", 5.0),
       ("userB", "itemA", 1.0), ("userB", "itemB", 5.0),
       ("userC", "itemA", 4.0)]


def _weighted_edges(n=400, e=2600, seed=5):
    """Enough edges (x2 undirected) for the native alias builds."""
    rng = np.random.default_rng(seed)
    a, b = rng.integers(0, n, e), rng.integers(0, n, e)
    w = rng.integers(1, 6, e) * 0.5
    return [(f"v{x}", f"v{y}", float(z)) for x, y, z in zip(a, b, w)
            if x != y]


METHODS = [(vm, nm) for vm in ("out_degrees", "no_degrees", "degrees")
           for nm in ("degrees", "in_degrees", "no_degrees")]


@pytest.mark.parametrize("graph", ["toy", "weighted"])
@pytest.mark.parametrize("vm,nm", METHODS)
def test_build_is_bit_equal(graph, vm, nm):
    edges = TOY if graph == "toy" else _weighted_edges()
    want = JTables.build(JGraph.from_edges(edges), vertex_method=vm,
                         negative_method=nm)
    got = SamplerTables.build(Graph.from_edges(edges), vertex_method=vm,
                              negative_method=nm, device=CPU)
    for f in ("vertex_pa", "neg_pa", "vert_meta", "ctx_pa", "edge_pa"):
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, f
        assert np.array_equal(g, w), f
    assert got.has_edge_table == want.has_edge_table is True
    assert (got.n_vertices, got.n_edges) == (want.n_vertices, want.n_edges)


# ---------------------------------------------------------------- draws
@pytest.fixture(scope="module")
def g():
    """Directed and weighted, with vertices of out-degree 0."""
    rng = np.random.default_rng(9)
    edges = []
    for _ in range(120):
        a, b = rng.integers(0, 30, 2)
        if a != b and a < 26:
            edges.append((f"v{a}", f"v{b}", float(rng.integers(1, 4))))
    return Graph.from_edges(edges, undirected=False)


@pytest.fixture(scope="module")
def t(g):
    return SamplerTables.build(g, device=CPU)


def _gen(seed):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return gen


def _chi2_ok(counts, p):
    """counts against probabilities p (any scale): no draw off the support,
    statistic below its mean plus 5 standard deviations."""
    counts = np.asarray(counts, np.float64).ravel()
    p = np.asarray(p, np.float64).ravel()
    p = p / p.sum()
    sup = p > 0
    assert counts[~sup].sum() == 0, "draws off the support"
    exp = p[sup] * counts.sum()
    chi2 = ((counts[sup] - exp) ** 2 / exp).sum()
    dof = sup.sum() - 1
    assert chi2 < dof + 5 * np.sqrt(2 * dof), (chi2, dof)


def _seg(g):
    return np.repeat(np.arange(g.n_vertices), np.diff(g.indptr))


def _vertex_law(g):
    return g.out_degree ** 0.75


def _neg_law(g):
    return (g.out_degree + g.in_degree) ** 0.75


def _joint_law(g):
    """P(src, dst) over n*n cells: P_v(src) * w^0.75 / Z_src."""
    n, seg = g.n_vertices, _seg(g)
    pv = _vertex_law(g) / _vertex_law(g).sum()
    w = g.weights ** 0.75
    z = np.bincount(seg, weights=w, minlength=n)
    law = np.zeros(n * n)
    np.add.at(law, seg * n + g.indices, pv[seg] * w / z[seg])
    return law


def _pair_counts(g, src, pos):
    n = g.n_vertices
    src = src.numpy().ravel().astype(np.int64)
    pos = pos.numpy().ravel().astype(np.int64)
    return np.bincount(src * n + pos, minlength=n * n)


def test_source_and_negative_laws(g, t):
    s = t.source_sample(_gen(0), (40_000,))
    negs = t.negative_sample(_gen(1), (200, 200))
    assert s.dtype == negs.dtype == torch.int32
    assert negs.shape == (200, 200)
    _chi2_ok(np.bincount(s.numpy(), minlength=g.n_vertices), _vertex_law(g))
    _chi2_ok(np.bincount(negs.numpy().ravel(), minlength=g.n_vertices),
             _neg_law(g))


def test_target_sample_conditional_law(g, t):
    deg = np.diff(g.indptr)
    v = int(np.argmax(deg))
    pos = t.target_sample(_gen(2), torch.full((30_000,), v,
                                              dtype=torch.int32))
    lo, hi = g.indptr[v], g.indptr[v + 1]
    law = np.zeros(g.n_vertices)
    np.add.at(law, g.indices[lo:hi], g.weights[lo:hi] ** 0.75)
    _chi2_ok(np.bincount(pos.numpy(), minlength=g.n_vertices), law)
    # zero out-degree: the vid itself
    zero = np.flatnonzero(deg == 0)
    assert len(zero)
    vids = torch.from_numpy(zero.astype(np.int32))
    assert torch.equal(t.target_sample(_gen(3), vids), vids)


def test_target_sample_global_law(g, t):
    seg = _seg(g)
    n = g.n_vertices
    w = g.weights ** 0.75
    z = np.bincount(seg, weights=w, minlength=n)
    # uniform over edge slots, then the slot's vertex sub-table
    law = np.zeros(n)
    np.add.at(law, g.indices, w / z[seg] * np.diff(g.indptr)[seg])
    pos = t.target_sample_global(_gen(4), (40_000,))
    _chi2_ok(np.bincount(pos.numpy(), minlength=n), law)


def test_edge_sample_joint_law(g, t):
    src, pos = t.edge_sample(_gen(5), (60_000,))
    _chi2_ok(_pair_counts(g, src, pos), _joint_law(g))


@pytest.mark.parametrize("edge_table", [True, False])
def test_draw_edge_batch(g, t, edge_table):
    if not edge_table:  # the (1, 8) dummy of a graph past 2^24
        t = dataclasses.replace(t, edge_pa=torch.zeros(1, 8))
    assert t.has_edge_table is edge_table
    srcs, poss, negs = [], [], []
    gen = _gen(6)
    for _ in range(30):
        s, p, ng = t.draw_edge_batch(gen, 2000, 100)
        assert s.shape == p.shape == (2000,) and ng.shape == (100,)
        srcs.append(s)
        poss.append(p)
        negs.append(ng)
    _chi2_ok(_pair_counts(g, torch.cat(srcs), torch.cat(poss)),
             _joint_law(g))
    _chi2_ok(np.bincount(torch.cat(negs).numpy(), minlength=g.n_vertices),
             _neg_law(g))


@pytest.mark.parametrize("group", [1, 8])
def test_hoisted_draws(g, t, group):
    """group 8 takes the negatives' uniforms from the spare rows of the
    edge draw; group 1 has none spare and draws them apart."""
    S, B, K = 12, 4096, 256
    src, pos, negs = t.draw_edge_batches_hoisted(_gen(7), B, group, K, S)
    assert src.shape == pos.shape == (S, B) and negs.shape == (S, K)
    assert src.dtype == pos.dtype == negs.dtype == torch.int32
    grouped = src.reshape(S, -1, group)
    assert torch.equal(grouped, grouped[:, :, :1].expand_as(grouped))
    # pairs of one group share their source, so the law is tested on one
    # pair per group: the first (its pos from the joint table itself) and
    # the last (its pos from the source's sub-table)
    law = _joint_law(g)
    for j in sorted({0, group - 1}):
        _chi2_ok(_pair_counts(g, src[:, j::group], pos[:, j::group]), law)
    _chi2_ok(np.bincount(negs.numpy().ravel(), minlength=g.n_vertices),
             _neg_law(g))


def test_grouped_draw(g, t):
    G = 4
    srcs, poss, negs = [], [], []
    gen = _gen(8)
    for _ in range(25):
        s, p, ng = t.draw_edge_batch_grouped(gen, 2048, G, 64)
        assert s.shape == p.shape == (2048,) and ng.shape == (64,)
        grouped = s.reshape(-1, G)
        assert torch.equal(grouped, grouped[:, :1].expand_as(grouped))
        srcs.append(s)
        poss.append(p)
        negs.append(ng)
    src, pos = torch.cat(srcs), torch.cat(poss)
    law = _joint_law(g)
    for j in range(G):  # one pair per group, as in test_hoisted_draws
        _chi2_ok(_pair_counts(g, src[j::G], pos[j::G]), law)
    _chi2_ok(np.bincount(torch.cat(negs).numpy(), minlength=g.n_vertices),
             _neg_law(g))
