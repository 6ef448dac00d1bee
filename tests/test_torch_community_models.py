"""The port's community family (GCN, TEXTGCN, TEXTGCNdev, ECO with its three
heads, FINE, MSFINE) against smore_tpu's.

- One step: the JAX step on a key; the port's draw on the uniforms that
  step draws from it (split as the JAX step splits it), then its update,
  after ``load_state_numpy`` of the JAX model's tables: the same tables
  (tests/test_torch_community_ops.py's tolerances), pooled and per-sample.
- ``train()``'s guards (the batch clamps, the "mean" switch, the tiny-graph
  pool fallback, recall_rank's per-sample negatives) give the JAX
  package's batch, collision and pool on tests/test_field_models.py's toy
  field graph.
- ``save_weights`` files byte-equal to the JAX package's for the same
  tables: TEXTGCN's neighbour sums, TEXTGCNdev's user and word rows,
  FINE's side-by-side field rows.
- The learning checks of tests/test_field_models.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smore_tpu.models.base as JBASE
import smore_tpu.models.eco as JECO_MOD
import smore_tpu.models.fine as JFINE_MOD
import smore_tpu.models.gcn as JGCN_MOD
import smore_tpu_torch.models.base as TBASE
import smore_tpu_torch.models.eco as TECO_MOD
import smore_tpu_torch.models.fine as TFINE_MOD
import smore_tpu_torch.models.gcn as TGCN_MOD
from smore_tpu.graph.graph import Graph as JGraph
from smore_tpu_torch.graph.graph import Graph
from smore_tpu_torch.models import (
    ECO,
    FINE,
    GCN,
    MSFINE,
    TEXTGCN,
    TEXTGCNdev,
)

# one intra-op thread: test workers share the cores, and a thread pool
# in each of them oversubscribes the CPU on these tiny shapes
torch.set_num_threads(1)

CPU = torch.device("cpu")  # the port defaults to the card
TOL = dict(rtol=1e-5, atol=1e-6)
TOL_EXP = dict(rtol=1e-4, atol=1e-5)  # the exp-based choice updates
N_U, N_I = 16, 24
ALPHA = 0.05


def _t(a):
    """A writable torch copy of a JAX or numpy array."""
    return torch.from_numpy(np.array(a))


def _graphs(edges, tmp_path_factory, field_of):
    """(JAX graph, port graph), undirected, with a field file written from
    ``field_of(name)``."""
    jg = JGraph.from_edges(edges, undirected=True)
    tg = Graph.from_edges(edges, undirected=True)
    p = tmp_path_factory.mktemp("fields") / "field.txt"
    p.write_text("".join(f"{nm} {field_of(nm)}\n" for nm in tg.names))
    jg.load_field_meta(str(p))
    tg.load_field_meta(str(p))
    return jg, tg


@pytest.fixture(scope="module")
def ui(tmp_path_factory):
    """tests/test_field_models.py's 16 x 24 user-item graph, users field
    0, items field 1."""
    rng = np.random.default_rng(5)
    edges = []
    for u in range(N_U):
        own = [i for i in range(N_I) if i % 2 == u % 2]
        for i in rng.choice(own, 8, replace=False):
            edges.append((f"u{u}", f"i{i}", 1.0))
    jg, tg = _graphs(edges, tmp_path_factory, lambda nm: nm[0])
    assert tg.field_names[0] == "u"
    return jg, tg


@pytest.fixture(scope="module")
def uew(tmp_path_factory):
    """tests/test_field_models.py's user-event-word graph (fields u, e,
    w)."""
    rng = np.random.default_rng(17)
    edges = []
    for u in range(8):
        for e in rng.choice(6, 3, replace=False):
            edges.append((f"u{u}", f"e{e}", 1.0))
    for e in range(6):
        for w in rng.choice(10, 4, replace=False):
            edges.append((f"e{e}", f"w{w}", 1.0))
    jg, tg = _graphs(edges, tmp_path_factory, lambda nm: nm[0])
    assert tg.field_names[:2] == ["u", "e"]
    return jg, tg


def _pair(jcls, tcls, graphs, dim=8, **kw):
    """A JAX model and the port's on the same graph, the port holding the
    JAX model's init tables."""
    jg, tg = graphs
    jm = jcls(jg, seed=0, **kw)
    jm.init(dim=dim)
    tm = tcls(tg, seed=0, device=CPU, **kw)
    tm.init(dim=dim)
    assert {k: v.shape for k, v in tm.state.items()} == {
        k: v.shape for k, v in jm.state.items()}
    tm.load_state_numpy({k: np.asarray(v) for k, v in jm.state.items()})
    return jm, tm


def _step_both(jm, tm, keys, B, neg, Kp, seed, tol):
    """The JAX step on PRNGKey(seed), and the port's draw and update on the
    uniforms of ``keys(key)`` in the port's shapes; compare."""
    key = jax.random.PRNGKey(seed)
    js, jl = jm._make_step(B, neg, "sum", Kp)(jm.state, jm._make_ctx(), key,
                                              jnp.float32(ALPHA))
    shapes = tm._uniform_shapes(B, neg, Kp)
    ks = keys(key)
    assert len(ks) == len(shapes)
    u = tuple(_t(jax.random.uniform(k, s)) for k, s in zip(ks, shapes))
    x = tm._make_draw(B, neg, Kp)(tm._make_ctx(), None, u)
    ts, tl = tm._make_update(neg, "sum", Kp)(tm.state, x, torch.tensor(ALPHA))
    assert set(ts) == set(js)
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   err_msg=k, **tol)
    np.testing.assert_allclose(float(tl), float(jl), **tol)
    return x


def _split(n, first=None):
    """The keys a JAX step splits its key into, the first split again in
    two for ``first="two"`` (TEXTGCN's doc and neighbour draws)."""

    def keys(key):
        ks = list(jax.random.split(key, n))
        if first == "two":
            ks = list(jax.random.split(ks[0])) + ks[1:]
        return ks

    return keys


@pytest.mark.parametrize("Kp", [0, 8])
@pytest.mark.parametrize("jcls,tcls,first", [
    (JGCN_MOD.GCN, GCN, None), (JGCN_MOD.TEXTGCN, TEXTGCN, "two")],
    ids=["GCN", "TEXTGCN"])
def test_gcn_step_fed_jax_uniforms(ui, jcls, tcls, first, Kp):
    jm, tm = _pair(jcls, tcls, ui)
    jm.walk_steps = tm.walk_steps = 3
    # split into 4 (the 4th unused): vc, the one-hop draws, the negatives
    keys = _split(4, first)
    x = _step_both(jm, tm, lambda k: keys(k)[:-1], 16, 3, Kp, 1, TOL)
    fields = ui[1].fields
    vctx, cctx, mask, negs = x
    assert vctx.shape == cctx.shape == (16, 3)
    assert (fields[negs.numpy()] == 1).all()  # field-1 negatives
    assert mask.sum() > 0


def test_gcn_without_fields_draws_every_vertex(tmp_path):
    """On a graph without field metadata the negatives are uniform over all
    vertices (field 0 of one)."""
    rng = np.random.default_rng(2)
    edges = [(f"v{a}", f"v{b}", 1.0) for a, b in rng.integers(0, 50, (200, 2))
             if a != b]
    jm, tm = _pair(JGCN_MOD.GCN, GCN, (JGraph.from_edges(edges),
                                       Graph.from_edges(edges)))
    jm.walk_steps = tm.walk_steps = 2
    x = _step_both(jm, tm, lambda k: _split(4)(k)[:-1], 32, 4, 0, 2, TOL)
    assert len(np.unique(x[3].numpy())) > 30


@pytest.mark.parametrize("Kp", [0, 8])
def test_textgcndev_step_fed_jax_uniforms(uew, Kp):
    jm, tm = _pair(JGCN_MOD.TEXTGCNdev, TEXTGCNdev, uew)
    for m in (jm, tm):
        m.num_events, m.num_words = 2, 3
    # context rows non-zero, so that the word rows take part
    ctx = np.random.default_rng(0).standard_normal(
        jm.state["context"].shape).astype(np.float32) * 0.1
    jm.state["context"] = jnp.asarray(ctx)
    tm.state["context"] = _t(ctx)
    x = _step_both(jm, tm, _split(3), 16, 2, Kp, 3, TOL)
    fields = uew[1].fields
    user, last_ev, bags, negs = x
    assert (fields[user.numpy()] == 0).all()
    assert (fields[negs.numpy()] == 1).all()  # events
    assert bags.shape == (16, 6)


# recall_rank always takes per-sample negatives
@pytest.mark.parametrize("head,Kp", [
    ("dchoice", 0), ("dchoice", 8), ("hop_choice", 0), ("hop_choice", 8),
    ("recall_rank", 0)])
def test_eco_step_fed_jax_uniforms(ui, head, Kp):
    jm, tm = _pair(JECO_MOD.ECO, ECO, ui, head=head)
    x = _step_both(jm, tm, _split(3), 16, 3, Kp, 4, TOL_EXP)
    if head == "recall_rank":  # field-matched negatives
        fields = ui[1].fields
        pos, negs = x[1].numpy(), x[2].numpy()
        assert (fields[negs] == fields[pos][:, None]).all()
        assert x[0].shape == (16 * 5,)


@pytest.mark.parametrize("Kp", [0, 8])
@pytest.mark.parametrize("walk_steps", [0, 2])
@pytest.mark.parametrize("jcls,tcls", [(JFINE_MOD.FINE, FINE),
                                       (JFINE_MOD.MSFINE, MSFINE)],
                         ids=["FINE", "MSFINE"])
def test_fine_step_fed_jax_uniforms(ui, jcls, tcls, walk_steps, Kp):
    jm, tm = _pair(jcls, tcls, ui)
    jm.walk_steps = tm.walk_steps = walk_steps
    assert tm.state["vertex"].shape == (2 * ui[1].n_vertices, 8)

    def keys(key):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        return [k1, k2, k3, k4] if walk_steps else [k1, k2, k4]

    x = _step_both(jm, tm, keys, 16, 3, Kp, 5, TOL)
    v1, walk, alive, negs, field_of = x
    assert walk.shape == alive.shape == (16, walk_steps + 1)
    if Kp:  # pool f drawn from field f
        assert (field_of[negs.long()] == torch.arange(2)[:, None]).all()
    else:
        want = field_of[walk.long()][..., None]
        assert (field_of[negs.long()] == want).all()


# ------------------------------------------------------------ train guards
def _capture(monkeypatch, jmods, tmods, jcls, tcls):
    """Record the (batch, negatives, collision, shared_negatives) that each
    package's train() passes to _make_step and the batch it drives, with
    the drivers replaced by stand-ins that train nothing."""
    seen = {"jax": [], "port": []}

    class Driver:
        def __init__(self, step, ctx, samples_per_step, **kw):
            self.samples_per_step = samples_per_step

        def train(self, state, key, verbose=True):
            return state

    for side, mods, cls in (("jax", jmods, jcls), ("port", tmods, tcls)):
        for mod in mods:
            monkeypatch.setattr(mod, "TrainDriver", Driver)
        orig = cls._make_step

        def make_step(self, *a, _orig=orig, _side=side):
            seen[_side].append(a)
            return _orig(self, *a)

        monkeypatch.setattr(cls, "_make_step", make_step)
    return seen


GUARDS = [
    # the batch clamp n // (2 S), the pool fallback on a 40-vertex graph
    ("GCN", {}),
    ("GCN", dict(walk_steps=10)),  # n <= 4 S: collision "mean"
    ("GCN", dict(walk_steps=1, shared_negatives=8)),  # min(Kp, batch)
    ("TEXTGCN", dict(walk_steps=2, shared_negatives=10, batch=7)),
    ("TEXTGCNdev", {}),
    ("TEXTGCNdev", dict(num_events=8, num_words=5)),  # n <= E Wn: "mean"
    ("TEXTGCNdev", dict(num_events=1, num_words=1, shared_negatives=8)),
    ("ECO", {}),
    ("ECO", dict(shared_negatives=8)),  # no min(Kp, batch) in ECO
    ("ECO", dict(shared_negatives=8, head="recall_rank")),  # forced 0
    ("FINE", dict(shared_negatives=8, batch=5)),
    ("MSFINE", {}),
]


@pytest.mark.parametrize("name,kw", GUARDS)
def test_train_guards_match_jax(ui, monkeypatch, name, kw):
    kw = dict(kw)
    head = kw.pop("head", None)
    jmod, tmod = {"ECO": (JECO_MOD, TECO_MOD),
                  "FINE": (JFINE_MOD, TFINE_MOD),
                  "MSFINE": (JFINE_MOD, TFINE_MOD)}.get(
                      name, (JGCN_MOD, TGCN_MOD))
    jcls, tcls = getattr(jmod, name), getattr(tmod, name)
    seen = _capture(monkeypatch, [jmod, JBASE], [TBASE], jcls, tcls)
    ctor = {} if head is None else dict(head=head)
    jm, tm = _pair(jcls, tcls, ui, **ctor)
    jm.train(sample_times=0.001, verbose=False, **kw)
    tm.train(sample_times=0.001, verbose=False, **kw)
    assert seen["port"] == seen["jax"] and len(seen["jax"]) == 1
    assert tm.last_driver.samples_per_step == seen["port"][0][0]


# ------------------------------------------------------------ saved files
def _random_state(jm, tm, seed=0):
    """The same random tables in both models."""
    rng = np.random.default_rng(seed)
    st = {k: rng.standard_normal(np.asarray(v).shape).astype(np.float32)
          for k, v in jm.state.items()}
    jm.state = {k: jnp.asarray(v) for k, v in st.items()}
    tm.load_state_numpy(st)


@pytest.mark.parametrize("name,graph", [
    ("GCN", "ui"), ("TEXTGCN", "uew"), ("TEXTGCN", "ui"),
    ("TEXTGCNdev", "uew"), ("ECO", "ui"), ("FINE", "ui"), ("MSFINE", "uew")])
def test_weights_byte_equal(request, tmp_path, name, graph):
    graphs = request.getfixturevalue(graph)
    jmod = {"ECO": JECO_MOD, "FINE": JFINE_MOD, "MSFINE": JFINE_MOD}.get(
        name, JGCN_MOD)
    tmod = {"ECO": TECO_MOD, "FINE": TFINE_MOD, "MSFINE": TFINE_MOD}.get(
        name, TGCN_MOD)
    jm, tm = _pair(getattr(jmod, name), getattr(tmod, name), graphs)
    _random_state(jm, tm)
    a, b = tmp_path / "jax.txt", tmp_path / "port.txt"
    jm.save_weights(str(a))
    tm.save_weights(str(b))
    assert a.read_bytes() == b.read_bytes()
    header = b.read_text().split("\n")[0].split()
    if name.startswith("FINE") or name == "MSFINE":  # both field rows
        assert header == [str(graphs[1].n_vertices), "16"]


# ----------------------------------------------------------------- quality
def _gap(g, wv, wc=None):
    """tests/test_field_models.py's probe: own-cluster minus other-cluster
    user-item score."""
    wc = wv if wc is None else wc
    own, other = [], []
    for u in range(N_U):
        for i in range(N_I):
            s = wv[g.name2id[f"u{u}"]] @ wc[g.name2id[f"i{i}"]]
            (own if i % 2 == u % 2 else other).append(s)
    return np.mean(own) - np.mean(other)


def test_gcn_trains(ui):
    g = ui[1]
    m = GCN(g, seed=0, device=CPU)
    m.init(dim=16)
    m.train(sample_times=0.02, walk_steps=3, negative_samples=3, alpha=0.01,
            batch=32, steps_per_call=8, verbose=False)
    wv = m.state["vertex"].numpy()
    assert np.isfinite(wv).all()
    # both sides sum the user's item neighbours: item-item alignment
    own, other = [], []
    for i in range(N_I):
        for j in range(i + 1, N_I):
            s = wv[g.name2id[f"i{i}"]] @ wv[g.name2id[f"i{j}"]]
            (own if i % 2 == j % 2 else other).append(s)
    assert np.mean(own) > np.mean(other)


def test_textgcn_trains_and_saves(ui, tmp_path):
    g = ui[1]
    m = TEXTGCN(g, seed=0, device=CPU)
    m.init(dim=16)
    m.train(sample_times=0.02, walk_steps=3, negative_samples=3, alpha=0.01,
            batch=32, steps_per_call=8, verbose=False)
    out = tmp_path / "tg.txt"
    m.save_weights(str(out))
    lines = out.read_text().strip().split("\n")
    assert len(lines) == 1 + N_U  # the items (field 1) are skipped


def test_textgcndev_trains_and_saves(uew, tmp_path):
    g = uew[1]
    m = TEXTGCNdev(g, seed=0, device=CPU)
    m.init(dim=8)
    m.train(sample_times=0.01, num_events=2, num_words=3, negative_samples=2,
            alpha=0.01, batch=16, steps_per_call=4, verbose=False)
    assert all(bool(torch.isfinite(t).all()) for t in m.state.values())
    assert float(m.state["context"].abs().sum()) > 0  # the words moved
    out = tmp_path / "tgd.txt"
    m.save_weights(str(out))
    lines = out.read_text().strip().split("\n")
    n_kept = sum(1 for nm in g.names if not nm.startswith("e"))
    assert lines[0] == f"{n_kept} 8" and len(lines) == 1 + n_kept


@pytest.mark.parametrize("head", ["dchoice", "hop_choice", "recall_rank"])
def test_eco_learns(ui, head):
    m = ECO(ui[1], seed=0, head=head, device=CPU)
    m.init(dim=16)
    init = m.state["vertex"].abs().max()
    assert 0.25 < float(init) <= 0.5  # uniform(-0.5, 0.5), no /dim
    m.train(sample_times=0.05, negative_samples=3, alpha=0.005, batch=32,
            steps_per_call=8, verbose=False)
    wv = m.state["vertex"].numpy()
    assert np.isfinite(wv).all()
    assert _gap(ui[1], wv) > 0.0


def test_eco_rejects_unknown_head(ui):
    with pytest.raises(ValueError):
        ECO(ui[1], head="nope", device=CPU)


def test_fine_learns_and_saves(ui, tmp_path):
    m = FINE(ui[1], seed=0, device=CPU)
    m.init(dim=8)
    before = m.state["vertex"].clone()
    m.train(sample_times=0.05, walk_steps=2, negative_samples=3, alpha=0.02,
            batch=64, steps_per_call=8, verbose=False)
    wv = m.state["vertex"]
    assert bool(torch.isfinite(wv).all()) and not torch.equal(wv, before)
    out = tmp_path / "fine.txt"
    m.save_weights(str(out))
    first = out.read_text().split("\n")[1].split()
    assert len(first) == 1 + 2 * 8  # the name and both field rows


def test_msfine_trains(ui):
    m = MSFINE(ui[1], seed=0, device=CPU)
    m.init(dim=8)
    m.train(sample_times=0.02, walk_steps=2, negative_samples=3, alpha=0.02,
            batch=32, steps_per_call=8, verbose=False)
    assert bool(torch.isfinite(m.state["vertex"]).all())
