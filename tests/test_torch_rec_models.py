"""The port's rec family (MF, BPR, WARP, Skew-OPT, HPE, PE, HOP-REC, NEMF,
NERANK) against smore_tpu's.

- Draws: HOP-REC's hop chain, ``community_walk_pairs``, ``build_walk_bank``
  and ``community_walk_pairs_bank`` bit-equal given the JAX draws'
  uniforms (on a graph with dead ends).
- One inner batch: each model's update fed the JAX package's draws (the
  four one-table models and HPE through their ``hoisted_scan_step``
  closures, both packages'; HOP-REC, PE and the CSE models through the
  uniforms their JAX step draws from its key) gives the JAX step's tables
  within test_torch_rec_ops.py's tolerances.
- Quality: tests/test_rec_models.py's preference gaps on its 20 x 30
  user-item graph for all nine models (NEMF and NERANK at
  tests/test_field_models.py's arguments), and its per-sample paths.
- The shared pool with a broadcast pool equals the per-sample update; the
  marginalised WARP law.
- ``train`` keyword handling, ``mesh=`` and the CSE weights file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smore_tpu.models.hpe as JHPE_MOD
import smore_tpu.models.rec as JREC
import smore_tpu_torch.models.hpe as THPE_MOD
import smore_tpu_torch.models.rec as TREC
from smore_tpu.graph.graph import Graph as JGraph
from smore_tpu.models.cse import NEMF as JNEMF
from smore_tpu.models.cse import NERANK as JNERANK
from smore_tpu.models.hoprec import HOPREC as JHOPREC
from smore_tpu.models.hpe import HPE as JHPE
from smore_tpu.models.hpe import PE as JPE
from smore_tpu.sampling.tables import SamplerTables as JSamplerTables
from smore_tpu_torch.graph.graph import Graph
from smore_tpu_torch.models import (
    BPR,
    HOPREC,
    HPE,
    MF,
    NEMF,
    NERANK,
    PE,
    WARP,
    SkewOPT,
)
from smore_tpu_torch.models.hoprec import hop_chain
from smore_tpu_torch.ops.update import (
    bpr_shared_negs_step,
    bpr_step,
    mf_shared_negs_step,
    mf_step,
    warp_shared_pool_step,
)
from smore_tpu_torch.sampling.tables import SamplerTables

# one intra-op thread: test workers share the cores, and a thread pool
# in each of them oversubscribes the CPU on these tiny shapes
torch.set_num_threads(1)

CPU = torch.device("cpu")  # the port defaults to the card
TOL = dict(rtol=1e-5, atol=1e-6)
TOL_SKEW = dict(rtol=1e-4, atol=1e-5)
N_USERS, N_ITEMS = 20, 30


def _t(a):
    """A writable torch copy of a JAX or numpy array."""
    return torch.from_numpy(np.array(a))


def _ui_edges():
    """tests/test_rec_models.py's two taste clusters."""
    rng = np.random.default_rng(3)
    edges = []
    for u in range(N_USERS):
        cl = u % 2
        own = [i for i in range(N_ITEMS) if i % 2 == cl]
        other = [i for i in range(N_ITEMS) if i % 2 != cl]
        for i in rng.choice(own, 9, replace=False):
            edges.append((f"u{u}", f"i{i}", 1.0))
        edges.append((f"u{u}", f"i{rng.choice(other)}", 1.0))
    return edges


def _field_file(tmp_path_factory, names):
    p = tmp_path_factory.mktemp("fields") / "field.txt"
    p.write_text("".join(f"{nm} {'user' if nm.startswith('u') else 'item'}\n"
                         for nm in names))
    return str(p)


@pytest.fixture(scope="module")
def ui(tmp_path_factory):
    """(JAX graph, port graph) of the user-item net with field metadata
    (users field 0)."""
    e = _ui_edges()
    jg, tg = JGraph.from_edges(e), Graph.from_edges(e)
    path = _field_file(tmp_path_factory, tg.names)
    jg.load_field_meta(path)
    tg.load_field_meta(path)
    assert tg.field_names[0] == "user"
    return jg, tg


@pytest.fixture(scope="module")
def dead_ends():
    """A weighted directed graph where a fifth of the vertices have no
    out-edge, and its samplers in both packages."""
    rng = np.random.default_rng(3)
    edges = [(f"v{a}", f"v{b}", float(rng.uniform(0.5, 3.0)))
             for a, b in rng.integers(0, 120, (700, 2)) if a != b and a % 5]
    jg, tg = JGraph.from_edges(edges, False), Graph.from_edges(edges, False)
    return (jg, JSamplerTables.build(jg), tg,
            SamplerTables.build(tg, device=CPU))


def _pair(jcls, tcls, graphs, dim=8, **kw):
    """A JAX model and the port's on the same graph, with the JAX model's
    init tables."""
    jg, tg = graphs
    jm = jcls(jg, seed=0, **kw)
    jm.init(dim=dim)
    tm = tcls(tg, seed=0, device=CPU, **kw)
    tm.init(dim=dim)
    tm.load_state_numpy({k: np.asarray(v) for k, v in jm.state.items()})
    return jm, tm


def _same_state(ts, js, tol=TOL):
    assert set(ts) == set(js)
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   err_msg=k, **tol)


# ------------------------------------------------------------------ draws
def test_hop_chain_bit_equal(dead_ends):
    _, jt, _, tt = dead_ends
    rng = np.random.default_rng(0)
    vid = rng.integers(0, tt.n_vertices, 256).astype(np.int32)
    W = 4
    u = jax.random.uniform(jax.random.PRNGKey(1), (256, 2 * W - 1, 2))
    # JAX HOP-REC's chain (smore_tpu/models/hoprec.py:73-80)
    cur = jt.target_sample(None, jnp.asarray(vid), u2=u[:, 0])
    want = [cur]
    for h in range(1, W):
        cur = jt.target_sample(None, cur, u2=u[:, 2 * h - 1])
        cur = jt.target_sample(None, cur, u2=u[:, 2 * h])
        want.append(cur)
    got = hop_chain(tt, torch.from_numpy(vid), W, _t(u))
    np.testing.assert_array_equal(got.numpy(), np.stack(want, 1))


@pytest.mark.parametrize("walk_steps", [1, 2, 5])
def test_community_walk_pairs_bit_equal(dead_ends, walk_steps):
    _, jt, _, tt = dead_ends
    rng = np.random.default_rng(walk_steps)
    src = rng.integers(0, tt.n_vertices, 300).astype(np.int32)
    pos = rng.integers(0, tt.n_vertices, 300).astype(np.int32)
    key = jax.random.PRNGKey(walk_steps)
    want = JHPE_MOD.community_walk_pairs(jt, key, jnp.asarray(src),
                                         jnp.asarray(pos), walk_steps)
    u = (_t(jax.random.uniform(key, (walk_steps - 1, 300, 2)))
         if walk_steps > 1 else None)
    got = THPE_MOD.community_walk_pairs(tt, None, torch.from_numpy(src),
                                        torch.from_numpy(pos), walk_steps,
                                        u=u)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if walk_steps == 5:
        assert 0 < float(got[2].mean()) < 1  # dead ends cut walks


def test_walk_bank_and_bank_pairs_bit_equal(dead_ends):
    jg, jt, tg, tt = dead_ends
    n, k, S = tg.n_vertices, 6, 4
    key = jax.random.PRNGKey(2)
    want = JHPE_MOD.build_walk_bank(jt, key, n, k, S)
    u = _t(jax.random.uniform(key, (S - 1, n * k, 2)))
    bank = THPE_MOD.build_walk_bank(tt, None, n, k, S, u=u)
    assert bank.dtype == torch.int32 and bank.shape == (n, k, S - 1)
    np.testing.assert_array_equal(bank.numpy(), np.asarray(want))
    assert (bank.numpy() >> 30).any()  # positions past a dead end

    rng = np.random.default_rng(4)
    src = rng.integers(0, n, 200).astype(np.int32)
    pos = rng.integers(0, n, 200).astype(np.int32)
    key = jax.random.PRNGKey(5)
    want = JHPE_MOD.community_walk_pairs_bank(want, key, jnp.asarray(src),
                                              jnp.asarray(pos), S)
    r = _t(jax.random.randint(key, (200,), 0, k))
    got = THPE_MOD.community_walk_pairs_bank(bank, None, torch.from_numpy(src),
                                             torch.from_numpy(pos), S, r=r)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------- one inner batch
REC = {"mf": (JREC.MF, MF, {}), "bpr": (JREC.BPR, BPR, {}),
       "warp": (JREC.WARP, WARP, {}),
       "skewopt": (JREC.SkewOPT, SkewOPT, dict(xi=0.5, omega=1.0, eta=3))}


def _closures(monkeypatch, module):
    """Make ``module``'s hoisted_scan_step hand back (draw, update)."""
    monkeypatch.setattr(module, "hoisted_scan_step",
                        lambda draw, update, hoist: (draw, update))


@pytest.mark.parametrize("collision", ["sum", "mean"])
@pytest.mark.parametrize("shared", [16, 0])
@pytest.mark.parametrize("model", sorted(REC))
def test_rec_update_fed_jax_draws(ui, monkeypatch, model, shared,
                                  collision):
    jcls, tcls, kw = REC[model]
    jm, tm = _pair(jcls, tcls, ui, **kw)
    _closures(monkeypatch, JREC)
    _closures(monkeypatch, TREC)
    jdraw, jupdate = jm._make_step(32, collision, hoist=2,
                                   shared_negatives=shared)
    _, tupdate = tm._make_step(32, collision, hoist=2,
                               shared_negatives=shared)
    xs = jdraw(jm.build_sampler(), jax.random.PRNGKey(3))
    for i in range(2):  # two inner batches, the second on updated tables
        x = tuple(a[i] for a in xs)
        js, jl = jupdate(jm.state, x, jnp.float32(0.05))
        ts, tl = tupdate(tm.state, tuple(_t(a) for a in x),
                         torch.tensor(0.05))
        tol = TOL_SKEW if model == "skewopt" else TOL
        _same_state(ts, js, tol)
        np.testing.assert_allclose(float(tl), float(jl), **tol)
        jm.state, tm.state = js, ts
    assert ts["vertex"] is tm.state["vertex"]


@pytest.mark.parametrize("walk_bank", [4, 0])
def test_hpe_update_fed_jax_draws(ui, monkeypatch, walk_bank):
    jg, tg = ui
    jm, tm = _pair(JHPE, HPE, ui)
    _closures(monkeypatch, JHPE_MOD)
    _closures(monkeypatch, THPE_MOD)
    jm.walk_steps = tm.walk_steps = 3
    jt = jm.build_sampler()
    bank = (JHPE_MOD.build_walk_bank(jt, jax.random.PRNGKey(7),
                                     jg.n_vertices, walk_bank, 3)
            if walk_bank else None)
    jdraw, jupdate = jm._make_step(16, 5, 32, "sum", hoist=2,
                                   use_bank=bool(walk_bank))
    _, tupdate = tm._make_step(16, 5, 32, "sum", hoist=2,
                               use_bank=bool(walk_bank))
    xs = jdraw((jt, bank), jax.random.PRNGKey(8))
    x = tuple(a[0] for a in xs)
    js, jl = jupdate(jm.state, x, jnp.float32(0.05))
    ts, tl = tupdate(tm.state, tuple(_t(a) for a in x), torch.tensor(0.05))
    _same_state(ts, js)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)


def test_hoprec_step_fed_jax_uniforms(ui):
    """The JAX step on a key; the port's draw on the uniforms that step
    draws from it, then its update: the same tables."""
    jm, tm = _pair(JHOPREC, HOPREC, ui)
    jm.walk_steps = tm.walk_steps = 3
    B, W = 32, 3
    key = jax.random.PRNGKey(11)
    js, jl = jm._make_step(B, "sum")(jm.state, jm._make_ctx(), key,
                                     jnp.float32(0.05))
    k1, k2, k3 = jax.random.split(key, 3)
    u = (jax.random.uniform(k1, (B, 2)),
         jax.random.uniform(k2, (B, 2 * W - 1, 2)),
         jax.random.uniform(k3, (B * W, 2)))
    x = tm._make_draw(B)(tm._make_ctx(), None, tuple(_t(a) for a in u))
    ts, tl = tm._make_update(B, "sum")(tm.state, x, torch.tensor(0.05))
    _same_state(ts, js)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    fields = ui[1].fields
    assert (fields[x[0].numpy()] == 0).all()  # users
    np.testing.assert_array_equal(fields[x[1].numpy()], fields[x[2].numpy()])


@pytest.mark.parametrize("walk_meta", [False, True])
def test_pe_step_fed_jax_uniforms(ui, tmp_path, walk_meta):
    jg, tg = ui
    jm, tm = _pair(JPE, PE, ui)
    B, Ks = 32, 16
    if walk_meta:
        p = tmp_path / "walk.txt"
        p.write_text("".join(f"{nm} {1 + i % 4}\n"
                             for i, nm in enumerate(tg.names)))
        jm.load_walk_meta(str(p))
        tm.load_walk_meta(str(p))
    try:
        key = jax.random.PRNGKey(12)
        dyn = jg.walk_steps
        jctx = (jm.build_sampler(), jnp.zeros((0,), jnp.int32) if dyn is None
                else jnp.asarray(dyn, jnp.int32))
        js, jl = jm._make_step(B, 5, Ks, "sum")(jm.state, jctx, key,
                                                jnp.float32(0.05))
        ks = jax.random.split(key, 4 if walk_meta else 3)
        shapes = [(B, 2), (B, 2), (Ks, 2)] + ([(3, B, 2)] if walk_meta
                                              else [])
        u = tuple(_t(jax.random.uniform(k, s)) for k, s in zip(ks, shapes))
        tctx = (tm.build_sampler(), torch.zeros(0, dtype=torch.int32)
                if dyn is None else torch.from_numpy(tg.walk_steps))
        x = tm._make_draw(B, Ks)(tctx, None, u)
        ts, tl = tm._make_update(5, "sum")(tm.state, x, torch.tensor(0.05))
        _same_state(ts, js)
        np.testing.assert_allclose(float(tl), float(jl), **TOL)
    finally:
        jg.walk_steps = tg.walk_steps = None


@pytest.mark.parametrize("walk_steps", [3, 1])
@pytest.mark.parametrize("head", ["mf", "rank"])
def test_cse_step_fed_jax_uniforms(ui, head, walk_steps):
    jcls, tcls = (JNEMF, NEMF) if head == "mf" else (JNERANK, NERANK)
    jm, tm = _pair(jcls, tcls, ui)
    jm.walk_steps = tm.walk_steps = walk_steps
    B, neg, Ks = 32, 3, 16
    key = jax.random.PRNGKey(13)
    js, jl = jm._make_step(B, neg, Ks, "sum")(jm.state, jm._make_ctx(), key,
                                              jnp.float32(0.05))
    ks = jax.random.split(key, 7)
    S = walk_steps
    walk = [(ks[3], (S - 1, B, 2)), (ks[4], (S - 1, B, 2))] if S > 1 else []
    hk = (ks[5], (B, neg, 2)) if head == "mf" else (ks[6], (B, 16, 2))
    u = tuple(_t(jax.random.uniform(k, s)) for k, s in
              [(ks[0], (B, 2)), (ks[1], (B, 2)), (ks[2], (Ks, 2))] + walk
              + [hk])
    assert [tuple(a.shape) for a in u] == tm._uniform_shapes(B, neg, Ks)
    x = tm._make_draw(B, neg, Ks)(tm._make_ctx(), None, u)
    ts, tl = tm._make_update(neg, "sum")(tm.state, x, torch.tensor(0.05))
    _same_state(ts, js)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    if head == "rank":  # field-matched negatives
        fields = ui[1].fields
        assert (fields[x[5].numpy()] == fields[x[1].numpy()][:, None]).all()


# ---------------------------------------------------------------- quality
def _pref_gap(m, table_v="vertex", table_c="vertex"):
    """tests/test_rec_models.py's probe: own-cluster minus other-cluster
    score of users against items."""
    wv = m.state[table_v].numpy()
    wc = m.state[table_c].numpy()
    g = m.graph
    own, other = [], []
    for u in range(0, N_USERS, 2):
        for i in range(0, N_ITEMS, 3):
            s = wv[g.name2id[f"u{u}"]] @ wc[g.name2id[f"i{i}"]]
            (own if i % 2 == u % 2 else other).append(s)
    return np.mean(own) - np.mean(other)


KW = dict(sample_times=0.05, alpha=0.02, batch=64, steps_per_call=16,
          verbose=False)
SIMPLE = [(MF, {}), (BPR, {}), (WARP, {}),
          (SkewOPT, dict(xi=0.0, omega=1.0, eta=1))]


@pytest.fixture(scope="module")
def ui_graph():
    """The user-item net, undirected, without field metadata."""
    return Graph.from_edges(_ui_edges(), undirected=True)


@pytest.mark.parametrize("shared", [-1, 0])
@pytest.mark.parametrize("cls,kw", SIMPLE, ids=lambda c: getattr(
    c, "__name__", ""))
def test_simple_rec_models_learn_preferences(ui_graph, cls, kw, shared):
    """The shared-pool default and the per-sample path
    (``shared_negatives=0``)."""
    m = cls(ui_graph, seed=0, device=CPU, **kw)
    m.init(dim=16)
    m.train(shared_negatives=shared, **KW)
    d = m.last_driver
    assert d.micro_steps == (8 if shared else 1)
    assert _pref_gap(m) > 0.05


def test_hpe_learns_preferences(ui_graph):
    m = HPE(ui_graph, seed=0, device=CPU)
    m.init(dim=16)
    m.train(sample_times=0.05, walk_steps=3, negative_samples=5, alpha=0.02,
            batch=64, steps_per_call=16, verbose=False)
    assert _pref_gap(m, "vertex", "context") > 0.02


def test_pe_learns_preferences(ui_graph):
    m = PE(ui_graph, seed=0, device=CPU)
    m.init(dim=16)
    m.train(sample_times=0.05, negative_samples=5, alpha=0.02, batch=64,
            steps_per_call=16, verbose=False)
    # PE updates (pos -> src): context(user) . vertex(item)
    assert _pref_gap(m, "context", "vertex") != 0.0


def test_hoprec_learns_preferences(ui):
    g = Graph.from_edges(_ui_edges(), undirected=True)
    g.fields, g.n_fields = ui[1].fields, ui[1].n_fields
    m = HOPREC(g, seed=0, device=CPU)
    m.init(dim=16)
    m.train(sample_times=0.05, walk_steps=2, alpha=0.02, batch=64,
            steps_per_call=16, verbose=False)
    assert _pref_gap(m) > 0.05


@pytest.fixture(scope="module")
def field_graph(tmp_path_factory):
    """tests/test_field_models.py's 16 x 24 user-item graph, users field
    0."""
    rng = np.random.default_rng(5)
    edges = []
    for u in range(16):
        for i in rng.choice([i for i in range(24) if i % 2 == u % 2], 8,
                            replace=False):
            edges.append((f"u{u}", f"i{i}", 1.0))
    g = Graph.from_edges(edges, undirected=True)
    p = tmp_path_factory.mktemp("f") / "field.txt"
    p.write_text("".join(f"{nm} {'u' if nm.startswith('u') else 'i'}\n"
                         for nm in g.names))
    g.load_field_meta(str(p))
    assert g.field_names[0] == "u"
    return g


def _cse_gap(g, m):
    wv, wc = m.state["vertexU"].numpy(), m.state["vertexI"].numpy()
    own, other = [], []
    for u in range(16):
        for i in range(24):
            s = wv[g.name2id[f"u{u}"]] @ wc[g.name2id[f"i{i}"]]
            (own if i % 2 == u % 2 else other).append(s)
    return np.mean(own) - np.mean(other)


@pytest.mark.parametrize("cls,gap", [(NEMF, 0.02), (NERANK, 0.0)])
def test_cse_models_learn(field_graph, cls, gap, tmp_path):
    m = cls(field_graph, seed=0, device=CPU)
    m.init(dim=16)
    m.train(sample_times=0.05, walk_steps=3, negative_samples=3, alpha=0.02,
            batch=64, steps_per_call=8, verbose=False)
    assert _cse_gap(field_graph, m) > gap
    out = tmp_path / "cse.txt"
    m.save_weights(str(out))
    assert out.read_text().split("\n")[0] == f"{field_graph.n_vertices} 16"


def test_cse_weights_byte_equal(ui, tmp_path):
    """Field-0 rows from vertexU, the others from vertexI, as the JAX
    package writes them."""
    jm, tm = _pair(JNERANK, NERANK, ui)
    a, b = tmp_path / "jax.txt", tmp_path / "port.txt"
    jm.save_weights(str(a))
    tm.save_weights(str(b))
    assert a.read_bytes() == b.read_bytes()


# ------------------------------------------------ shared pool, WARP law
def _toy_table(seed):
    rng = np.random.default_rng(seed)
    N, B, Ks = 64, 32, 8
    return (torch.from_numpy((rng.standard_normal((N, 8)) * 0.1).astype(
        np.float32)), *(torch.from_numpy(rng.integers(0, N, n).astype(
            np.int32)) for n in (B, B, Ks)))


@pytest.mark.parametrize("pooled,per_sample", [
    (bpr_shared_negs_step, bpr_step), (mf_shared_negs_step, mf_step)])
def test_shared_pool_equals_broadcast_per_sample(pooled, per_sample):
    """With every sample given the same negatives and k_equiv = Ks, the
    shared-pool update is the per-sample one."""
    w, user, pos, pool = _toy_table(0)
    ref, got = w.clone(), w.clone()
    Ks = pool.shape[0]
    per_sample(ref, ref, user, pos, pool[None, :].expand(user.shape[0], Ks),
               torch.tensor(0.05), shared_table=True)
    pooled(got, got, user, pos, pool, torch.tensor(0.05), k_equiv=Ks,
           shared_table=True)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-5,
                               atol=1e-6)


def test_warp_shared_pool_marginalized_law():
    """The selected negative is uniform among the pool's margin violators,
    and the update fires with probability 1 - (1 - v)^trials."""
    N, Ks, B, T = 64, 16, 4096, 5
    w = torch.zeros(N, 8)
    w[0, 0] = 1.0  # every user = e0
    w[1, 0] = 2.0  # pos: f_i = 2
    for k in range(Ks):  # the first 4 pool rows violate the margin
        w[2 + k, 0] = 1.5 if k < 4 else -1.0
    user = torch.zeros(B, dtype=torch.int32)
    pos = torch.ones(B, dtype=torch.int32)
    pool = torch.arange(2, 2 + Ks, dtype=torch.int32)
    u = torch.rand(B, Ks + 1, generator=torch.Generator().manual_seed(0))
    alpha = 1e-3
    before = w.clone()
    warp_shared_pool_step(w, w, user, pos, pool, u, torch.tensor(alpha),
                          trials=T, shared_table=True)
    p_hit = 1 - (1 - 4 / Ks) ** T
    un = u.numpy()
    hit = un[:, Ks] < p_hit
    k_sel = np.argmax(np.where(np.arange(Ks)[None, :] < 4, un[:, :Ks], -1.0),
                      1)
    counts = np.bincount(k_sel[hit], minlength=Ks)
    assert counts[4:].sum() == 0
    assert abs(counts[:4] / hit.sum() - 0.25).max() < 0.03
    assert abs(hit.mean() - p_hit) < 0.03
    # each fired sample moves its violator's row: rows 2..5 by their counts
    moved = (before - w)[2:6, 0].numpy()
    assert (moved > 0).all()
    np.testing.assert_allclose(moved / moved.sum(), counts[:4] / hit.sum(),
                               rtol=1e-3)
    assert torch.equal(w[6:2 + Ks], before[6:2 + Ks])  # never selected


# ------------------------------------------------------------ train args
def test_train_sets_known_args_and_rejects_others(ui_graph):
    m = WARP(ui_graph, seed=0, device=CPU)
    m.init(dim=8)
    m.train(sample_times=0.001, batch=32, trials=7, verbose=False)
    assert m.trials == 7 and m.last_driver.total_samples == 1000
    with pytest.raises(TypeError, match="unknown train arg"):
        m.train(sample_times=0.001, nonsense=1, verbose=False)
    with pytest.raises(TypeError, match="1-D DeviceMesh"):
        m.train(sample_times=0.001, mesh=object(), verbose=False)
