"""The port's typed-graph family (SNE, FastRP, CPR, TPR, Metapath2Vec, HAN,
CTDNE) and its graph stores against smore_tpu's.

- The signed, hetero and temporal loaders are bit-equal.
- ``typed_neighbor``, ``metapath_walk`` and ``temporal_walk`` (equal
  timestamps included, where the right bisection's ties decide the slot)
  are bit-equal given JAX's uniforms.
- One step of each model, fed the JAX step's draws (its ids and the
  uniforms its keys draw), after ``load_state_numpy`` of the JAX model's
  tables: every table within rtol 1e-5, atol 1e-6 (HAN, on duplicate-free
  node draws: rtol 1e-4, atol 1e-5, its attention sums three small
  products in another order). A node HAN draws twice gets one of its
  candidate rows, the last.
- FastRP given JAX's projection: rtol 1e-5, atol 1e-6.
- The toy learning checks of tests/test_typed_graphs.py and
  tests/test_jodie_cpr_tpr.py.
- Weights files byte-equal to the JAX package's for the same tables.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smore_tpu.models.cpr as JCPR_MOD
from smore_tpu.graph.graph import Graph as JGraph
from smore_tpu.graph.hetero import HeteroGraph as JHeteroGraph
from smore_tpu.graph.hetero import HeteroTables as JHeteroTables
from smore_tpu.graph.signed import SignedNetwork as JSignedNetwork
from smore_tpu.graph.temporal import TemporalGraph as JTemporalGraph
from smore_tpu.graph.temporal import TemporalTables as JTemporalTables
from smore_tpu.models.ctdne import CTDNE as JCTDNE
from smore_tpu.models.fastrp import FastRP as JFastRP
from smore_tpu.models.han import HAN as JHAN
from smore_tpu.models.metapath2vec import Metapath2Vec as JMetapath2Vec
from smore_tpu.models.sne import SNE as JSNE
from smore_tpu_torch.graph.graph import Graph
from smore_tpu_torch.graph.hetero import HeteroGraph, HeteroTables
from smore_tpu_torch.graph.signed import SignedNetwork
from smore_tpu_torch.graph.temporal import TemporalGraph, TemporalTables
from smore_tpu_torch.models import (
    CPR,
    CTDNE,
    HAN,
    SNE,
    TPR,
    FastRP,
    Metapath2Vec,
)
from smore_tpu_torch.models.han import last_occurrence
from smore_tpu_torch.sampling.mappers import skipgram_pairs

# one intra-op thread: test workers share the cores, and a thread pool
# in each of them oversubscribes the CPU on these tiny shapes
torch.set_num_threads(1)

CPU = torch.device("cpu")  # the port defaults to the card
TOL = dict(rtol=1e-5, atol=1e-6)
TOL_HAN = dict(rtol=1e-4, atol=1e-5)
ALPHA = 0.05


def _t(a):
    """A writable torch copy of a JAX or numpy array."""
    return torch.from_numpy(np.array(a))


def _u(key, shape):
    return _t(jax.random.uniform(key, shape))


def _close(ts, js, tol=TOL):
    assert set(ts) == set(js)
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   err_msg=k, **tol)


# ------------------------------- fixtures ------------------------------ #
@pytest.fixture(scope="module")
def signed_path(tmp_path_factory):
    """tests/test_typed_graphs.py's two camps with hostile cross edges,
    plus every sign token."""
    rng = np.random.default_rng(2)
    lines = []
    for camp in (0, 1):
        ids = range(camp * 8, camp * 8 + 8)
        for i in ids:
            for j in ids:
                if i < j and rng.random() < 0.6:
                    lines.append(f"v{i} v{j} +1\n")
    for _ in range(20):
        i = rng.integers(0, 8)
        j = rng.integers(8, 16)
        lines.append(f"v{i} v{j} -1\n")
    lines += ["v1 v2 pos 2.0\n", "v3 v9 negative\n", "v4 v5 0.7\n",
              "v6 v12 -3\n", "v7 v8 what\n", "v0 v1\n", "v2 v3 POSITIVE x\n"]
    p = tmp_path_factory.mktemp("s") / "signed.txt"
    p.write_text("".join(lines))
    return str(p)


@pytest.fixture(scope="module")
def temporal_path(tmp_path_factory):
    """A dense temporal graph on 12 nodes with many equal timestamps (the
    bisection's ties) and a bad timestamp line."""
    rng = np.random.default_rng(4)
    lines = []
    for _ in range(150):
        a, b = rng.integers(0, 12, 2)
        lines.append(f"n{a} n{b} {rng.integers(0, 8)}\n")
    lines += ["n1 n2 x\n", "n3\n", "n2 n5 2.5\n"]
    p = tmp_path_factory.mktemp("t") / "temporal.txt"
    p.write_text("".join(lines))
    return str(p)


@pytest.fixture(scope="module")
def chain_path(tmp_path_factory):
    """tests/test_typed_graphs.py's chain a->b->c->d plus a late edge."""
    lines = ["a b 1\n", "b c 2\n", "c d 3\n", "d e 4\n", "a e 10\n"]
    p = tmp_path_factory.mktemp("t") / "chain.txt"
    p.write_text("".join(lines))
    return str(p)


@pytest.fixture(scope="module")
def hetero_path(tmp_path_factory):
    """tests/test_typed_graphs.py's authors-papers-venues (and a short
    line)."""
    rng = np.random.default_rng(9)
    lines = []
    for a in range(8):
        for p in rng.choice(12, 4, replace=False):
            lines.append(f"a{a} author p{p} paper writes\n")
    for p in range(12):
        lines.append(f"p{p} paper v{p % 3} venue published_at\n")
    lines.append("a1 author p2\n")
    f = tmp_path_factory.mktemp("h") / "hetero.txt"
    f.write_text("".join(lines))
    return str(f)


@pytest.fixture(scope="module")
def big_hetero_path(tmp_path_factory):
    """A wider author-paper-venue graph (100 authors), so that HAN's node
    draws can be duplicate-free."""
    rng = np.random.default_rng(5)
    lines = []
    for a in range(100):
        for p in rng.choice(60, 3, replace=False):
            lines.append(f"a{a} author p{p} paper writes\n")
    for p in range(60):
        lines.append(f"p{p} paper v{p % 4} venue published_at\n")
    f = tmp_path_factory.mktemp("h") / "big_hetero.txt"
    f.write_text("".join(lines))
    return str(f)


@pytest.fixture(scope="module")
def two_domain_paths(tmp_path_factory):
    """tests/test_jodie_cpr_tpr.py's two domains."""
    rng = np.random.default_rng(8)
    d = tmp_path_factory.mktemp("cpr")
    t_lines, s_lines = [], []
    for u in range(12):
        own = [i for i in range(16) if i % 2 == u % 2]
        for i in rng.choice(own, 5, replace=False):
            t_lines.append(f"u{u} t{i} 1\n")
        for i in rng.choice(own, 5, replace=False):
            s_lines.append(f"u{u} s{i} 1\n")
    (d / "target.txt").write_text("".join(t_lines))
    (d / "source.txt").write_text("".join(s_lines))
    return str(d / "target.txt"), str(d / "source.txt")


@pytest.fixture(scope="module")
def tpr_paths(tmp_path_factory):
    """tests/test_jodie_cpr_tpr.py's user-item and item-word graphs, and
    an item with no words."""
    rng = np.random.default_rng(13)
    d = tmp_path_factory.mktemp("tpr")
    ui, iw = [], []
    for u in range(12):
        own = [i for i in range(16) if i % 2 == u % 2]
        for i in rng.choice(own, 5, replace=False):
            ui.append(f"u{u} it{i} 1\n")
    ui.append("u0 it99 1\n")
    for i in range(16):
        for w in range(3):
            iw.append(f"it{i} w{(i % 2) * 3 + w} 1\n")
    (d / "ui.txt").write_text("".join(ui))
    (d / "iw.txt").write_text("".join(iw))
    return str(d / "ui.txt"), str(d / "iw.txt")


# -------------------------------- stores ------------------------------- #
def _fields_equal(a, b, fields):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f
        else:
            assert x == y, f


@pytest.mark.parametrize("undirected", [True, False])
def test_signed_loader_bit_equal(signed_path, undirected):
    a = JSignedNetwork.load_edge_list(signed_path, undirected)
    b = SignedNetwork.load_edge_list(signed_path, undirected)
    _fields_equal(a, b, ("names", "name2id", "pos_src", "pos_dst", "pos_w",
                         "neg_src", "neg_dst", "neg_w"))
    assert len(b.neg_src) > 0 and len(b.pos_src) > 0


@pytest.mark.parametrize("undirected", [True, False])
def test_hetero_loader_bit_equal(hetero_path, undirected):
    a = JHeteroGraph.load_edge_list(hetero_path, undirected)
    b = HeteroGraph.load_edge_list(hetero_path, undirected)
    _fields_equal(a, b, ("names", "name2id", "types", "type2id",
                         "node_type", "nbr_indptr", "nbr_flat"))
    a0 = b.name2id["a0"]
    for t in ("paper", "venue", "author", "nosuch"):
        assert np.array_equal(b.neighbors_by_type(a0, t),
                              a.neighbors_by_type(a0, t))
        assert b.neighbor_count(a0, t) == a.neighbor_count(a0, t)
    assert np.array_equal(b.nodes_of_type("paper"), a.nodes_of_type("paper"))
    b.validate_meta_path(["author", "paper", "author"])
    for bad in (["author"], ["author", "movie"]):
        with pytest.raises(ValueError):
            b.validate_meta_path(bad)


def test_temporal_loader_bit_equal(temporal_path, chain_path):
    for path in (temporal_path, chain_path):
        a = JTemporalGraph.load_edge_list(path)
        b = TemporalGraph.load_edge_list(path)
        _fields_equal(a, b, ("names", "name2id", "indptr", "edge_dst",
                             "edge_ts", "active_min", "active_max",
                             "min_time", "max_time"))
    tg = TemporalGraph.load_edge_list(chain_path)
    a = tg.name2id["a"]
    assert list(tg.temporal_neighbors(a, 1.0, 10.0)) == [tg.name2id["b"],
                                                        tg.name2id["e"]]
    assert tg.sample_temporal_neighbor(a, 5.0, 20.0,
                                       np.random.default_rng(0)) == (
        tg.name2id["e"], 10.0)


# --------------------------------- walks ------------------------------- #
def _meta(hg, paths):
    lmax = max(len(p) for p in paths)
    pt = np.zeros((len(paths), lmax), dtype=np.int32)
    pl = np.array([len(p) for p in paths], dtype=np.int32)
    for i, p in enumerate(paths):
        pt[i, :len(p)] = [hg.type2id[t] for t in p]
    return pt, pl


PATHS = [["author", "paper", "author"],
         ["author", "paper", "venue", "paper", "author"]]


def test_typed_neighbor_bit_equal(hetero_path):
    jt = JHeteroTables.build(JHeteroGraph.load_edge_list(hetero_path))
    hg = HeteroGraph.load_edge_list(hetero_path)
    tt = HeteroTables.build(hg, CPU)
    rng = np.random.default_rng(0)
    vids = rng.integers(0, hg.n_vertices, 300).astype(np.int32)
    types = rng.integers(0, hg.n_types, 300).astype(np.int32)
    u = _u(jax.random.PRNGKey(1), (300,))
    jn, jok = jt.typed_neighbor(jnp.asarray(u.numpy()), jnp.asarray(vids),
                                jnp.asarray(types))
    tn, tok = tt.typed_neighbor(u, torch.from_numpy(vids),
                                torch.from_numpy(types))
    assert np.array_equal(tok.numpy(), np.asarray(jok))
    ok = tok.numpy()
    assert ok.any() and not ok.all()
    assert np.array_equal(tn.numpy()[ok], np.asarray(jn)[ok])


def test_metapath_walk_bit_equal(hetero_path):
    jhg = JHeteroGraph.load_edge_list(hetero_path)
    hg = HeteroGraph.load_edge_list(hetero_path)
    jt, tt = JHeteroTables.build(jhg), HeteroTables.build(hg, CPU)
    pt, pl = _meta(hg, PATHS)
    rng = np.random.default_rng(1)
    B, steps = 64, 7
    starts = rng.integers(0, hg.n_vertices, B).astype(np.int32)
    pidx = rng.integers(0, 2, B).astype(np.int32)
    key = jax.random.PRNGKey(2)
    jw, jv = jt.metapath_walk(key, jnp.asarray(starts), jnp.asarray(pt),
                              jnp.asarray(pl), jnp.asarray(pidx), steps)
    tw, tv = tt.metapath_walk(None, torch.from_numpy(starts),
                              torch.from_numpy(pt), torch.from_numpy(pl),
                              torch.from_numpy(pidx), steps,
                              u=_u(key, (steps, B)))
    assert np.array_equal(tw.numpy(), np.asarray(jw))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert 0 < tv.numpy()[:, 3].sum() < B  # some walks live, some died


@pytest.mark.parametrize("window", [0.5, 2.0, 100.0])
def test_temporal_walk_bit_equal_with_ties(temporal_path, window):
    jtg = JTemporalGraph.load_edge_list(temporal_path)
    tg = TemporalGraph.load_edge_list(temporal_path)
    jt, tt = JTemporalTables.build(jtg), TemporalTables.build(tg, CPU)
    assert tt.n_iters == jt.n_iters
    # equal timestamps inside segments: the ties the right bisect decides
    seg = np.repeat(np.arange(tg.n_vertices), np.diff(tg.indptr))
    ts = tg.edge_ts
    assert ((seg[1:] == seg[:-1]) & (ts[1:] == ts[:-1])).any()
    rng = np.random.default_rng(3)
    B, steps = 128, 6
    starts = rng.integers(0, tg.n_vertices, B).astype(np.int32)
    # start times ON edge timestamps (ties) and between them
    t0 = np.where(rng.random(B) < 0.5, rng.integers(0, 8, B),
                  rng.random(B) * 8).astype(np.float32)
    key = jax.random.PRNGKey(5)
    jw, jv = jt.temporal_walk(key, jnp.asarray(starts), jnp.asarray(t0),
                              steps, window)
    tw, tv = tt.temporal_walk(None, torch.from_numpy(starts),
                              torch.from_numpy(t0), steps, window,
                              u=_u(key, (steps, B)))
    assert np.array_equal(tw.numpy(), np.asarray(jw))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert tv.numpy()[:, 1].sum() > 0


def test_seg_searchsorted_is_the_right_bisect(temporal_path):
    """Against numpy's searchsorted(side="right") on every segment, at
    every timestamp (each a tie) and between."""
    tg = TemporalGraph.load_edge_list(temporal_path)
    tt = TemporalTables.build(tg, CPU)
    lo, hi, t, want = [], [], [], []
    for v in range(tg.n_vertices):
        a, b = int(tg.indptr[v]), int(tg.indptr[v + 1])
        for x in list(np.unique(tg.edge_ts[a:b])) + [-1.0, 3.5, 9.0]:
            lo.append(a)
            hi.append(b)
            t.append(x)
            want.append(a + np.searchsorted(tg.edge_ts[a:b],
                                            np.float32(x), side="right"))
    got = tt._seg_searchsorted(torch.tensor(lo, dtype=torch.int32),
                               torch.tensor(hi, dtype=torch.int32),
                               torch.tensor(t, dtype=torch.float32))
    assert got.tolist() == want


def test_temporal_walk_time_increasing(chain_path):
    tg = TemporalGraph.load_edge_list(chain_path)
    tt = TemporalTables.build(tg, CPU)
    gen = torch.Generator().manual_seed(0)
    starts = torch.full((64,), tg.name2id["a"], dtype=torch.int32)
    walk, valid = tt.temporal_walk(gen, starts, torch.zeros(64), 4, 100.0)
    seen = set()
    for row, vr in zip(walk.numpy(), valid.numpy()):
        seq = [tg.names[i] for i, ok in zip(row, vr) if ok]
        seen.add(tuple(seq))
        assert seq in (["a", "b", "c", "d", "e"], ["a", "e"])
    assert len(seen) == 2
    # window 2 from t=8: only the t=10 edge a->e qualifies
    walk, valid = tt.temporal_walk(gen, starts[:32], torch.full((32,), 8.0),
                                   3, 2.0)
    w, v = walk.numpy(), valid.numpy()
    assert (w[:, 1][v[:, 1] > 0] == tg.name2id["e"]).all()


# ------------------------------- one step ------------------------------ #
def _load(tm, jm):
    tm.load_state_numpy({k: np.asarray(v) for k, v in jm.state.items()})


def test_sne_step_fed_jax_draws(signed_path):
    jnet = JSignedNetwork.load_edge_list(signed_path)
    net = SignedNetwork.load_edge_list(signed_path)
    jm = JSNE(jnet, seed=0, negative_samples=3)
    jm.init(dim=8)
    tm = SNE(net, seed=0, negative_samples=3, device=CPU)
    tm.init(dim=8)
    _load(tm, jm)
    B, K, n = 24, 3, net.n_vertices
    key = jax.random.PRNGKey(7)
    js, jl = jm._make_step(B, "sum")(dict(jm.state), None, key,
                                     jnp.float32(ALPHA))
    k1, k2, k3, k4 = jax.random.split(key, 4)
    i = np.asarray(jax.random.randint(k1, (B,), 0, len(net.pos_src)))
    j = np.asarray(jax.random.randint(k3, (B,), 0, len(net.neg_src)))
    x = (_t(net.pos_src[i]), _t(net.pos_dst[i]),
         _t(jax.random.randint(k2, (B, K), 0, n)), _t(net.neg_src[j]),
         _t(net.neg_dst[j]), _t(jax.random.randint(k4, (B, K), 0, n)))
    ts, tl = tm._make_update("sum")(tm.state, x, torch.tensor(ALPHA))
    _close(ts, js)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)


def test_sne_draw_and_guards(signed_path, tmp_path):
    net = SignedNetwork.load_edge_list(signed_path)
    tm = SNE(net, seed=0, device=CPU)
    x = tm._make_draw(16)(tm._edges(), torch.Generator().manual_seed(1))
    assert x[2].shape == x[5].shape == (16, 5)
    pos = set(zip(net.pos_src.tolist(), net.pos_dst.tolist()))
    assert all(e in pos for e in zip(x[0].tolist(), x[1].tolist()))
    p = tmp_path / "none.txt"
    p.write_text("a b what\n")
    m = SNE.load_edge_list(str(p), device=CPU)
    m.init(dim=4)
    with pytest.raises(ValueError, match="no edges"):
        m.train(epochs=1, verbose=False)


class _Negs:
    """Negative-law stand-in: the draw reads the vertex count, the device
    and the negative pool."""

    def __init__(self, n, negs):
        self.n_vertices = n
        self.device = CPU
        self.negs = negs

    def negative_sample(self, *_, **__):
        return self.negs


def _walk_step(jm, tm, key, B, steps, window, K, Ks, emit):
    """The JAX model's step on ``key`` and the port's with the draws
    ``emit(key) -> (pairs, negs)`` of that key injected; compare."""
    js, jl = jm._make_step(B, steps, window, K, Ks, "sum")(
        dict(jm.state), jm._make_ctx(), key, jnp.float32(ALPHA))
    pairs, negs = emit(key)
    tm._emit_pairs = lambda *_: pairs
    tm._tables_of = lambda ctx: _Negs(tm.graph.n_vertices, negs)
    ts, tl = tm._make_step(B, K, Ks, "sum")(tm.state, None, None,
                                            torch.tensor(ALPHA))
    _close(ts, js)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    assert pairs[2].sum() > 0


@pytest.mark.parametrize("passes", [1, 4])
def test_metapath2vec_step_fed_jax_draws(hetero_path, passes):
    jhg = JHeteroGraph.load_edge_list(hetero_path)
    hg = HeteroGraph.load_edge_list(hetero_path)
    jm = JMetapath2Vec(jhg, seed=0)
    tm = Metapath2Vec(hg, seed=0, device=CPU)
    for m in (jm, tm):
        for p in PATHS:
            m.add_meta_path(p)
        m.init(dim=8)
        m.inner_passes = passes
    # a non-zero context table
    jm.state["context"] = jnp.asarray(np.random.default_rng(0).standard_normal(
        (hg.n_vertices, 8)).astype(np.float32) * 0.1)
    _load(tm, jm)
    B, steps, window, K, Ks = 16, 6, 2, 3, 8
    tt = HeteroTables.build(hg, CPU)
    pt, pl = (torch.from_numpy(a) for a in _meta(hg, PATHS))
    n = hg.n_vertices

    def emit(key):
        k1, k2, k3, k4, k5 = jax.random.split(key, 5)
        starts = _t(jax.random.randint(k1, (B,), 0, n, dtype=jnp.int32))
        pidx = _t(jax.random.randint(k2, (B,), 0, 2, dtype=jnp.int32))
        walk, valid = tt.metapath_walk(None, starts, pt, pl, pidx, steps,
                                       u=_u(k3, (steps, B)))
        reduce = _t(jax.random.randint(k4, walk.shape, 1, window + 1))
        pairs = skipgram_pairs(walk, None, window, valid=valid,
                               reduce=reduce)
        return pairs, _t(jax.random.randint(k5, (Ks,), 0, n))

    _walk_step(jm, tm, jax.random.PRNGKey(3), B, steps, window, K, Ks, emit)


@pytest.mark.parametrize("passes", [1, 4])
def test_ctdne_step_fed_jax_draws(temporal_path, passes):
    jtg = JTemporalGraph.load_edge_list(temporal_path)
    tg = TemporalGraph.load_edge_list(temporal_path)
    jm = JCTDNE(jtg, seed=0, time_window=3.0)
    tm = CTDNE(tg, seed=0, time_window=3.0, device=CPU)
    for m in (jm, tm):
        m.init(dim=8)
        m.inner_passes = passes
    jm.state["context"] = jnp.asarray(np.random.default_rng(1).standard_normal(
        (tg.n_vertices, 8)).astype(np.float32) * 0.1)
    _load(tm, jm)
    B, steps, window, K, Ks = 16, 5, 2, 3, 8
    tt, law = tm._make_ctx()
    n = tg.n_vertices

    def emit(key):
        k1, k2, k3, k4, k5 = jax.random.split(key, 5)
        starts = _t(jax.random.randint(k1, (B,), 0, n, dtype=jnp.int32))
        amin, amax = tt.active_min[starts], tt.active_max[starts]
        span = torch.where(amax > amin, amax - amin, tm.time_window)
        t0 = amin + _u(k2, (B,)) * span
        walk, valid = tt.temporal_walk(None, starts, t0, steps,
                                       tm.time_window, u=_u(k3, (steps, B)))
        reduce = _t(jax.random.randint(k4, walk.shape, 1, window + 1))
        pairs = skipgram_pairs(walk, None, window, valid=valid,
                               reduce=reduce)
        return pairs, law.negative_sample(None, (Ks,), u2=_u(k5, (Ks, 2)))

    _walk_step(jm, tm, jax.random.PRNGKey(4), B, steps, window, K, Ks, emit)


def _cpr_like_step(jm, tm, B, key):
    """The JAX step of a CPR / TPR model on ``key``; the port's draw on the
    uniforms of its five keys, then its update."""
    js, _ = jm._make_step(B, "sum")(dict(jm.state), jm._make_ctx(), key,
                                    jnp.float32(ALPHA))
    S = tm.agg_samples
    k = jax.random.split(key, 5)
    u = tuple(_u(k[i], (B, 2)) for i in range(3)) + tuple(
        _u(k[i], (B, S, 2)) for i in (3, 4))
    x = tm._make_draw(B)(tm._make_ctx(), None, u)
    ts, _ = tm._make_update()(tm.state, x, torch.tensor(ALPHA))
    _close(ts, js)
    return x


def test_cpr_step_fed_jax_uniforms(two_domain_paths):
    jm = JCPR_MOD.CPR(JGraph.load_edge_list(two_domain_paths[0]),
                      JGraph.load_edge_list(two_domain_paths[1]), seed=0,
                      agg_samples=4, margin=8.0)
    tm = CPR.load_domains(*two_domain_paths, seed=0, agg_samples=4,
                          margin=8.0, device=CPU)
    for m in (jm, tm):
        m.init(dim=8)
    _load(tm, jm)
    x = _cpr_like_step(jm, tm, 16, jax.random.PRNGKey(5))
    assert x[4].sum() > 0 and x[6].sum() > 0  # both aggregations act


def test_tpr_step_fed_jax_uniforms(tpr_paths):
    jm = JCPR_MOD.TPR(JGraph.load_edge_list(tpr_paths[0]),
                      JGraph.load_edge_list(tpr_paths[1]), seed=0,
                      text_weight=0.3, agg_samples=4)
    tm = TPR.load_graphs(*tpr_paths, seed=0, text_weight=0.3, agg_samples=4,
                         device=CPU)
    for m in (jm, tm):
        m.init(dim=8)
    _load(tm, jm)
    x = None
    for seed in range(6, 30):
        x = _cpr_like_step(jm, tm, 24, jax.random.PRNGKey(seed))
        if (x[4] == 0).any() or (x[6] == 0).any():
            break  # an item without words (or a user row) was drawn
    assert x[4].sum() > 0


def _han_pair(path, batch, walk_times, walk_steps):
    jhg, hg = JHeteroGraph.load_edge_list(path), HeteroGraph.load_edge_list(
        path)
    jm, tm = JHAN(jhg, seed=0), HAN(hg, seed=0, device=CPU)
    for m in (jm, tm):
        for p in PATHS:
            m.add_meta_path(p)
        m.init(dim=8, learning_rate=0.3)
    _load(tm, jm)
    return jm, tm


def _han_jax_draws(key, batch, inner, n, P, Wt, steps):
    """The JAX step's nodes (G, bg) and walk uniforms, in the port's (steps,
    G*P*Wt*bg) layout."""
    G = max(1, batch // inner)
    bg = batch // G
    nodes, us = [], []
    for kg in jax.random.split(key, G):
        k1, k2 = jax.random.split(kg)
        nodes.append(np.asarray(jax.random.randint(k1, (bg,), 0, n,
                                                   dtype=jnp.int32)))
        keys = jax.random.split(k2, P * Wt).reshape(P, Wt, -1)
        us.append([[np.asarray(jax.random.uniform(keys[p, w], (steps, bg)))
                    for w in range(Wt)] for p in range(P)])
    u = np.asarray(us).transpose(3, 0, 1, 2, 4).reshape(steps, -1)
    return np.stack(nodes), torch.from_numpy(u)


def test_han_step_fed_jax_draws_duplicate_free(big_hetero_path):
    batch, inner, Wt, steps = 8, 4, 3, 4
    jm, tm = _han_pair(big_hetero_path, batch, Wt, steps)
    n, P = tm.hg.n_vertices, 2
    for seed in range(200):
        key = jax.random.PRNGKey(seed)
        nodes, u = _han_jax_draws(key, batch, inner, n, P, Wt, steps)
        if all(len(set(g)) == len(g) for g in nodes):
            break
    else:
        pytest.fail("no duplicate-free draw")
    # the JAX step donates its tables: give it copies
    js = jm._make_step(batch, Wt, steps, inner=inner)(
        {k: jnp.array(v) for k, v in jm.state.items()}, jm._make_ctx(),
        key)[0]
    ctx = tm._make_ctx()
    x = tm._make_draw(batch, Wt, steps, inner=inner)(
        ctx, None, nodes=torch.from_numpy(nodes), u=u)
    assert x[2].sum() > 0  # some walks moved
    for g in range(nodes.shape[0]):
        tm._update_group(tm.state, x[0][g], x[1][g], x[2][g])
    _close(tm.state, js, TOL_HAN)
    assert not np.allclose(tm.state["embed"].numpy(),
                           np.asarray(jm.state["embed"]))


def test_han_duplicate_row_is_its_last_candidate(big_hetero_path):
    _, tm = _han_pair(big_hetero_path, 4, 3, 4)
    draw = tm._make_draw(4, 3, 4, inner=4)
    ctx = tm._make_ctx()
    a, b, c = (tm.hg.name2id[f"a{i}"] for i in (1, 2, 3))
    nodes = torch.tensor([[a, b, a, c]], dtype=torch.int32)
    _, ends, oks = draw(ctx, torch.Generator().manual_seed(0), nodes=nodes)
    assert torch.equal(last_occurrence(nodes[0]), torch.tensor([2, 1, 2, 3]))
    cands = []
    for i in (0, 2):  # each occurrence alone, on the same tables
        st = {k: v.clone() for k, v in tm.state.items()}
        tm._update_group(st, nodes[0, i:i + 1], ends[0][..., i:i + 1],
                         oks[0][..., i:i + 1])
        cands.append(st["embed"][a])
    tm._update_group(tm.state, nodes[0], ends[0], oks[0])
    got = tm.state["embed"][a]
    assert not torch.equal(cands[0], cands[1])  # the candidates differ
    assert torch.equal(got, cands[1])


def test_fastrp_given_jax_projection(tmp_path):
    rng = np.random.default_rng(6)
    p = tmp_path / "net.txt"
    p.write_text("".join(f"v{a} v{b} {w:.2f}\n" for a, b, w in zip(
        rng.integers(0, 40, 200), rng.integers(0, 40, 200),
        rng.random(200) + 0.5)))
    for ns, dim in ((0.0, 32), (0.5, 30)):
        jm = JFastRP(JGraph.load_edge_list(str(p)), seed=3, iterations=3,
                     normalization_strength=ns)
        jm.generate(dim=dim)
        tm = FastRP(Graph.load_edge_list(str(p)), seed=3, iterations=3,
                    normalization_strength=ns, device=CPU)
        d_iter = dim // 4
        u = jax.random.uniform(jax.random.PRNGKey(3), (tm.graph.n_vertices,
                                                       d_iter))
        x = jnp.where(u < 0.025, 1.0, jnp.where(u < 0.05, -1.0, 0.0))
        tm.generate(dim=dim, x=_t(x))
        _close(tm.state, jm.state)
        a, b = tmp_path / "j.txt", tmp_path / "t.txt"
        jm.save_weights(str(a))
        tm.save_weights(str(b))
        assert a.read_text().split("\n")[0] == b.read_text().split("\n")[0]


# ------------------------------- learning ------------------------------ #
def test_sne_learns(signed_path):
    m = SNE.load_edge_list(signed_path, device=CPU)
    m.init(dim=16)
    m.train(epochs=200, alpha=0.02, batch=64, steps_per_call=8,
            verbose=False)
    net = m.net
    ws, wt = m.state["source"].numpy(), m.state["target"].numpy()
    pos_s = np.mean([ws[a] @ wt[b] for a, b in zip(net.pos_src[:50],
                                                  net.pos_dst[:50])])
    neg_s = np.mean([ws[a] @ wt[b] for a, b in zip(net.neg_src,
                                                  net.neg_dst)])
    assert pos_s > neg_s
    assert m.compute_balance_ratio() > 0.6
    assert m.predict_sign(int(net.pos_src[0]), int(net.pos_dst[0])) == (
        pytest.approx(float(ws[net.pos_src[0]] @ wt[net.pos_dst[0]]),
                      rel=1e-5))


def test_ctdne_trains(chain_path, tmp_path):
    m = CTDNE.load_edge_list(chain_path, time_window=5.0, device=CPU)
    m.init(dim=8)
    m.train(walk_times=20, walk_steps=4, window_size=2, negative_samples=2,
            alpha=0.02, batch_walks=16, steps_per_call=4,
            shared_negatives=8, verbose=False)
    assert np.isfinite(m.state["vertex"].numpy()).all()
    assert m.inner_passes == 4  # the truncated budget's policy
    assert -1.0 <= m.compute_temporal_coherence() <= 1.0


def test_metapath2vec_trains(hetero_path, tmp_path):
    m = Metapath2Vec.load_edge_list(hetero_path, seed=0, device=CPU)
    m.add_meta_path(["author", "paper", "author"])
    m.init(dim=8)
    m.train(walk_times=10, walk_steps=6, window_size=2, negative_samples=2,
            alpha=0.02, batch_walks=16, steps_per_call=4,
            shared_negatives=8, verbose=False)
    assert np.isfinite(m.state["vertex"].numpy()).all()
    assert m.state["context"].abs().sum() > 0
    with pytest.raises(ValueError):
        m.add_meta_path(["author", "nosuch"])
    with pytest.raises(ValueError):
        Metapath2Vec.load_edge_list(hetero_path, device=CPU).train()


def test_metapath2vec_learns_topics(tmp_path):
    """On a small make_hetero set (3 topics of 12 authors and 20 papers),
    same-topic authors score above cross-topic ones (cosine)."""
    from smore_tpu_torch.utils.oracle_data import make_hetero

    path = make_hetero(str(tmp_path / "h.txt"), topics=3, authors_pt=12,
                       papers_pt=20, venues_pt=1)
    m = Metapath2Vec.load_edge_list(path, seed=0, device=CPU)
    m.add_meta_path(["author", "paper", "author"])
    m.init(dim=16)
    m.train(walk_times=200, walk_steps=6, window_size=2, negative_samples=3,
            alpha=0.025, batch_walks=32, shared_negatives=32, verbose=False)
    x = m.state["vertex"].numpy()
    x = x / np.linalg.norm(x, axis=1, keepdims=True)
    rows = {i: m.hg.name2id[f"a{i}"] for i in range(36)}
    same, cross = [], []
    for i in range(36):
        for j in range(i + 1, 36):
            s = x[rows[i]] @ x[rows[j]]
            (same if i // 12 == j // 12 else cross).append(s)
    assert np.mean(same) > np.mean(cross) + 0.3


def test_fastrp_two_blocks(tmp_path):
    lines = []
    for base in (0, 10):
        for i in range(10):
            for j in range(i + 1, 10):
                lines.append(f"n{base + i} n{base + j} 1\n")
    lines.append("n0 n10 1\n")
    p = tmp_path / "net.txt"
    p.write_text("".join(lines))
    m = FastRP.load_edge_list(str(p), iterations=3,
                              normalization_strength=0.5, device=CPU)
    m.generate(dim=32)
    wv = m.state["vertex"].numpy()
    assert wv.shape == (20, 32)
    np.testing.assert_allclose(np.linalg.norm(wv, axis=1), 1.0, atol=1e-5)
    g = m.graph
    intra, cross = [], []
    for i in range(0, 20, 2):
        for j in range(1, 20, 2):
            s = wv[g.name2id[f"n{i}"]] @ wv[g.name2id[f"n{j}"]]
            (intra if (i < 10) == (j < 10) else cross).append(s)
    assert np.mean(intra) > np.mean(cross) + 0.1


def test_han_trains(hetero_path, tmp_path):
    m = HAN.load_edge_list(hetero_path, seed=0, device=CPU)
    for p in PATHS:
        m.add_meta_path(p)
    m.init(dim=16, learning_rate=0.05)
    m.train(walk_times=3, walk_steps=4, epochs=3, batch=16, verbose=False)
    wv = m.state["embed"].numpy()
    assert np.isfinite(wv).all()
    norms = np.linalg.norm(wv, axis=1)
    assert (np.abs(norms - 1.0) < 1e-4).sum() > m.hg.n_vertices // 2
    out = tmp_path / "han.txt"
    m.save_weights(str(out))
    assert out.read_text().split("\n")[0] == f"{m.hg.n_vertices} 16"


def test_han_kill_and_resume_step_identical(hetero_path, tmp_path,
                                            monkeypatch):
    import smore_tpu_torch.models.han as THAN

    def fresh():
        m = HAN.load_edge_list(hetero_path, seed=0, device=CPU)
        for p in PATHS:
            m.add_meta_path(p)
        m.init(dim=8, learning_rate=0.1)
        return m

    kw = dict(walk_times=2, walk_steps=3, epochs=4, batch=16, verbose=False)
    ref = fresh()
    ref.train(**kw)
    ckpt = str(tmp_path / "ck")
    real_save = THAN.save_checkpoint

    def killing_save(path, state, step=0, extra=None):
        real_save(path, state, step=step, extra=extra)
        if step == 2:
            raise KeyboardInterrupt("simulated preemption")

    monkeypatch.setattr(THAN, "save_checkpoint", killing_save)
    with pytest.raises(KeyboardInterrupt):
        fresh().train(checkpoint=ckpt, **kw)
    monkeypatch.undo()
    got = fresh()
    got.train(checkpoint=ckpt, **kw)
    for k in ref.state:
        assert torch.equal(got.state[k], ref.state[k]), k


def _own_other(wu, wi, g, prefix):
    own, other = [], []
    for u in range(12):
        for i in range(16):
            nm = f"{prefix}{i}"
            if nm in g.name2id:
                s = wu[g.name2id[f"u{u}"]] @ wi[g.name2id[nm]]
                (own if i % 2 == u % 2 else other).append(s)
    return np.mean(own), np.mean(other)


def test_cpr_learns(two_domain_paths, tmp_path):
    m = CPR.load_domains(*two_domain_paths, seed=0, device=CPU)
    m.init(dim=16)
    m.train(update_times=0.05, alpha=0.05, batch=64, steps_per_call=8,
            verbose=False)
    own, other = _own_other(m.state["user"].numpy(),
                            m.state["target"].numpy(), m.target, "t")
    assert own > other


def test_tpr_learns(tpr_paths, tmp_path):
    m = TPR.load_graphs(*tpr_paths, seed=0, text_weight=0.3, device=CPU)
    m.init(dim=16)
    m.train(sample_times=0.05, alpha=0.05, batch=64, steps_per_call=8,
            verbose=False)
    own, other = _own_other(m.state["user"].numpy(),
                            m.state["item"].numpy(), m.ui, "it")
    assert own > other


# -------------------------------- weights ------------------------------ #
def test_weights_files_byte_equal(two_domain_paths, tpr_paths, signed_path,
                                  hetero_path, temporal_path, tmp_path):
    """The JAX models' init tables, taken by load_state_numpy, save to
    byte-equal files."""
    cases = []
    jm = JCPR_MOD.CPR(JGraph.load_edge_list(two_domain_paths[0]),
                      JGraph.load_edge_list(two_domain_paths[1]), seed=0)
    cases.append((jm, CPR.load_domains(*two_domain_paths, device=CPU), 3))
    jm = JCPR_MOD.TPR(JGraph.load_edge_list(tpr_paths[0]),
                      JGraph.load_edge_list(tpr_paths[1]), seed=0)
    cases.append((jm, TPR.load_graphs(*tpr_paths, device=CPU), 3))
    cases.append((JSNE(JSignedNetwork.load_edge_list(signed_path)),
                  SNE.load_edge_list(signed_path, device=CPU), 1))
    jm = JMetapath2Vec(JHeteroGraph.load_edge_list(hetero_path))
    cases.append((jm, Metapath2Vec.load_edge_list(hetero_path, device=CPU),
                  1))
    cases.append((JCTDNE(JTemporalGraph.load_edge_list(temporal_path)),
                  CTDNE.load_edge_list(temporal_path, device=CPU), 1))
    jh = JHAN(JHeteroGraph.load_edge_list(hetero_path))
    th = HAN.load_edge_list(hetero_path, device=CPU)
    for m in (jh, th):
        m.add_meta_path(PATHS[0])
    cases.append((jh, th, 1))
    for i, (jm, tm, n_files) in enumerate(cases):
        jm.init(dim=8)
        _load(tm, jm)
        jf = [str(tmp_path / f"j{i}_{k}.txt") for k in range(n_files)]
        tf = [str(tmp_path / f"t{i}_{k}.txt") for k in range(n_files)]
        jm.save_weights(*jf)
        tm.save_weights(*tf)
        for a, b in zip(jf, tf):
            assert open(a, "rb").read() == open(b, "rb").read(), (i, a)
