"""LINE's unbanded path (orders 1 and 2): the PyTorch port against
smore_tpu.

- The ``_make_step`` closures on the same injected draws and rates,
  starting from smore_tpu's init, after several inner steps: rtol 2e-5,
  atol 1e-6 (f32 on both sides, differing only in sum order). smore_tpu
  runs ``use_pallas=False`` (its Pallas route needs a TPU); the port's
  ``use_pallas=True`` cases run its K1 twin, the same math.
- The routing: same batch, group, hoist and steps per call as smore_tpu for
  the same arguments.
- End to end: the toy-net checks of tests/test_line_e2e.py, and community
  structure on small graphs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smore_tpu.graph.graph import Graph as JGraph
from smore_tpu.models.line import LINE as JLINE
from smore_tpu_torch.graph.graph import Graph as TGraph
from smore_tpu_torch.io.embeddings import load_embeddings
from smore_tpu_torch.models.line import LINE as TLINE
from smore_tpu_torch.ops.sgns import sgns_shared_grads
from smore_tpu_torch.sampling.tables import SamplerTables

# one intra-op thread: test workers share the cores, and a thread pool
# in each of them oversubscribes the CPU on these tiny shapes
torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 1e-6

CPU = torch.device("cpu")  # the port defaults to the card


def _comm_edges(seed=7, n_comm=4, size=50, e=3000):
    """The 200-vertex 4-community graph of test_torch_line_slice.py."""
    rng = np.random.default_rng(seed)
    n = n_comm * size
    edges = []
    for _ in range(e):
        c = rng.integers(0, n_comm)
        if rng.random() < 0.9:
            a, b = rng.integers(0, size, 2) + size * c
        else:
            a, b = rng.integers(0, n, 2)
        if a != b:
            edges.append((f"v{a}", f"v{b}", float(rng.integers(1, 4))))
    return edges


@pytest.fixture(scope="module")
def graphs():
    e = _comm_edges()
    return JGraph.from_edges(e, undirected=True), TGraph.from_edges(
        e, undirected=True)


# ------------------------------------------------------- closure parity
class _Injected:
    """Sampler stand-in that hands out prepared draws in order, under the
    draw methods each ``_make_step`` branch calls; ``wrap`` turns a numpy
    array into the package's array type."""

    has_edge_table = True

    def __init__(self, draws, wrap):
        self.draws = [tuple(wrap(a) for a in d) for d in draws]

    def _next(self, *_):
        return self.draws.pop(0)

    draw_edge_batches_hoisted = _next
    draw_edge_batch_grouped = _next
    draw_edge_batch = _next

    def source_sample(self, *_):
        self._strict = self.draws.pop(0)
        return self._strict[0]

    def target_sample(self, *_):
        return self._strict[1]

    def negative_sample(self, *_):
        return self._strict[2]


def _draws(rng, n, calls, batch, group, ks, hoist, strict, k):
    out = []
    for _ in range(calls):
        lead = (hoist,) if hoist > 1 else ()
        if strict:
            out.append((rng.integers(0, n, batch), rng.integers(0, n, batch),
                        rng.integers(0, n, (batch, k))))
            continue
        src = np.repeat(rng.integers(0, n, lead + (batch // group,)), group,
                        axis=-1)
        # a hot range: duplicate rows in every batch
        pos = np.where(rng.random(lead + (batch,)) < 0.3,
                       rng.integers(0, 8, lead + (batch,)),
                       rng.integers(0, n, lead + (batch,)))
        out.append((src, pos, rng.integers(0, n, lead + (ks,))))
    return [tuple(a.astype(np.int32) for a in d) for d in out]


CLOSURES = {
    **{f"o{o}_g{g}_h{h}": dict(order=o, group=g, hoist=h)
       for o in (1, 2) for g in (1, 8) for h in (1, 4)},
    "o1_strict": dict(order=1, strict=True),
    "o2_strict": dict(order=2, strict=True),
    "o1_g8_h4_k1": dict(order=1, group=8, hoist=4, use_pallas=True),
    "o2_g8_h4_k1": dict(order=2, group=8, hoist=4, use_pallas=True),
    "o2_g1_h1_k1": dict(order=2, group=1, hoist=1, use_pallas=True),
    "o2_g8_h1_mean": dict(order=2, group=8, hoist=1, collision="mean"),
}


@pytest.mark.parametrize("case", sorted(CLOSURES))
def test_step_closure_matches_jax(graphs, case):
    c = CLOSURES[case]
    order, group, hoist = c["order"], c.get("group", 1), c.get("hoist", 1)
    strict = c.get("strict", False)
    collision = c.get("collision", "sum")
    jg, tg = graphs
    n, D, batch, Ks, K, calls = jg.n_vertices, 32, 64, 16, 5, 3
    jm = JLINE(jg, seed=0)
    jm.init(dim=D, order=order)
    if order == 2:  # a non-zero context, so the first step is not trivial
        jc = JLINE(jg, seed=1)
        jc.init(dim=D, order=1)
        jm.state["context"] = jc.state["vertex"]
    tm = TLINE(tg, seed=0, device=CPU)
    tm.load_state_numpy({k: np.asarray(v) for k, v in jm.state.items()})
    tm.order = order

    rng = np.random.default_rng(len(case))
    draws = _draws(rng, n, calls, batch, group, Ks, hoist, strict, K)
    alphas = [np.linspace(0.05, 0.04, hoist).astype(np.float32)
              if hoist > 1 else np.float32(0.05 - 0.005 * i)
              for i in range(calls)]
    kw = dict(batch=batch, negatives=K, collision=collision,
              shared_negatives=0 if strict else Ks, group=group,
              hoist=hoist)
    jstep = jm._make_step(use_pallas=False, **kw)
    tstep = tm._make_step(use_pallas=c.get("use_pallas", False), **kw)
    jt, tt = _Injected(draws, jnp.asarray), _Injected(draws, torch.from_numpy)
    jstate, tstate = dict(jm.state), tm.state
    before = sgns_shared_grads.launches
    for a in alphas:
        jstate, jl = jstep(jstate, jt, jax.random.PRNGKey(0),
                           jnp.asarray(a))
        tstate, tl = tstep(tstate, tt, None, torch.from_numpy(np.array(a)))
        np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL,
                                   atol=ATOL)
    assert sgns_shared_grads.launches == before  # CPU: twin, no kernel
    assert set(tstate) == set(jstate) == (
        {"vertex"} if order == 1 else {"vertex", "context"})
    for k in jstate:
        np.testing.assert_allclose(tstate[k].numpy(), np.asarray(jstate[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert not np.allclose(tstate["vertex"].numpy(),
                           np.asarray(jm.state["vertex"]))


# -------------------------------------------------------------- routing
ROUTES = {
    "defaults": {},
    "group1": dict(group=1),
    "hoist4": dict(hoist=4),
    "hoist1_group8": dict(hoist=1, group=8),
    "strict": dict(shared_negatives=0),
    "mean": dict(collision="mean"),
    "order1": dict(order=1),
    "batch128_spc16": dict(batch=128, steps_per_call=16, hoist=2),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_routing_matches_jax(graphs, route):
    """A graph under 262,144 vertices takes the unbanded route; batch,
    group, hoist and steps per call resolve as smore_tpu's do."""
    jg, tg = graphs
    kw = dict(ROUTES[route])
    order = kw.pop("order", 2)
    kw.update(sample_times=0.01, negative_samples=5, alpha=0.025,
              verbose=False)
    jm = JLINE(jg, seed=0)
    jm.init(dim=16, order=order)
    jm.train(**kw)
    tm = TLINE(tg, seed=0, device=CPU)
    tm.init(dim=16, order=order)
    tm.train(**kw)
    jd, td = jm.last_driver, tm.last_driver
    for f in ("samples_per_step", "steps_per_call", "micro_steps",
              "total_samples", "executed_samples"):
        assert getattr(jd, f) == getattr(td, f), f
    assert isinstance(td.ctx, SamplerTables) and tm.banded_tables is None
    assert tm.tables is td.ctx
    for k, v in tm.state.items():
        assert v.shape == (tg.n_vertices, 16) and torch.isfinite(v).all()


def test_batch_not_divisible_by_group_raises_like_jax(graphs):
    jg, tg = graphs
    for cls, g, kw in ((JLINE, jg, {}), (TLINE, tg, dict(device=CPU))):
        m = cls(g, seed=0, **kw)
        m.init(dim=8, order=2)
        with pytest.raises(ValueError, match="divisible"):
            m.train(sample_times=0.01, batch=100, group=8, verbose=False)


@pytest.mark.parametrize("order", [1, 2])
def test_use_pallas_on_cpu_runs_the_twin(graphs, order):
    """use_pallas=True on CPU tensors goes through the K1 twin: no kernel
    launch, and the same tables as the inline math on the same draws."""
    _, tg = graphs
    out = {}
    before = sgns_shared_grads.launches
    for use_pallas in (False, True):
        m = TLINE(tg, seed=0, device=CPU)
        m.init(dim=16, order=order)
        m.train(sample_times=0.02, batch=128, use_pallas=use_pallas,
                verbose=False)
        out[use_pallas] = m.state_numpy()
    assert sgns_shared_grads.launches == before
    for k in out[False]:
        np.testing.assert_allclose(out[True][k], out[False][k], rtol=1e-5,
                                   atol=1e-6)


# ----------------------------------------------------------- end to end
def _toy_line(toy_net_path, order, dim=8):
    g = TGraph.load_edge_list(toy_net_path, undirected=True,
                              use_native=False)
    m = TLINE(g, seed=0, device=CPU)
    m.init(dim=dim, order=order)
    # tiny batch and modest alpha, as tests/test_line_e2e.py: on a
    # 6-vertex graph a large batch sums many colliding updates per row
    m.train(sample_times=0.02, negative_samples=5, alpha=0.025, batch=64,
            steps_per_call=16, verbose=False)
    return m


def _mean_score(m, pairs):
    wv = m.state["vertex"].numpy()
    wc = m.state.get("context", m.state["vertex"]).numpy()
    n2i = m.graph.name2id
    return np.mean([wv[n2i[a]] @ wc[n2i[b]] for a, b in pairs])


def test_line_o2_output_format(toy_net_path, tmp_path):
    m = _toy_line(toy_net_path, order=2)
    out = tmp_path / "rep.txt"
    m.save_weights(str(out))
    lines = out.read_text().strip().split("\n")
    assert lines[0] == "6 8"
    assert len(lines) == 7
    emb = load_embeddings(str(out))
    assert set(emb) == {"userA", "userB", "userC", "itemA", "itemB",
                        "itemC"}
    assert all(len(v) == 8 for v in emb.values())
    assert all(np.isfinite(v).all() for v in emb.values())


def test_line_o2_learns_structure(toy_net_path):
    m = _toy_line(toy_net_path, order=2)
    connected = [("userA", "itemA"), ("userA", "itemC"), ("userB", "itemB"),
                 ("userC", "itemA")]
    not_connected = [("userA", "itemB"), ("userC", "itemB"),
                     ("userC", "itemC")]
    assert _mean_score(m, connected) > _mean_score(m, not_connected)


def test_line_o1_learns_structure(toy_net_path):
    m = _toy_line(toy_net_path, order=1)
    assert "context" not in m.state  # shared table
    connected = [("userA", "itemA"), ("userA", "itemC"), ("userB", "itemB"),
                 ("userC", "itemA")]
    not_connected = [("userA", "itemB"), ("userC", "itemB")]
    assert _mean_score(m, connected) > _mean_score(m, not_connected)


def _two_cliques():
    """tests/test_hoisted_draws.py's 24-vertex two-community graph."""
    rng = np.random.default_rng(7)
    edges = []
    for base in (0, 12):
        for i in range(12):
            for j in range(i + 1, 12):
                if rng.random() < 0.6:
                    edges.append((f"v{base + i}", f"v{base + j}", 1.0))
    edges.append(("v0", "v12", 1.0))
    return TGraph.from_edges(edges, undirected=True)


@pytest.mark.parametrize("order", [1, 2])
def test_hoist_path_learns_communities(order):
    """The hoisted grouped route of test_line_hoist_path_learns_communities
    (tests/test_hoisted_draws.py), same arguments and margin."""
    g = _two_cliques()
    m = TLINE(g, seed=0, device=CPU)
    m.init(dim=16, order=order)
    m.train(sample_times=0.05, negative_samples=5, alpha=0.02, batch=16,
            group=8, hoist=8, steps_per_call=32, collision="mean",
            banded=False, verbose=False)
    wv = m.state["vertex"].numpy()
    assert np.isfinite(wv).all()
    wv = wv / (np.linalg.norm(wv, axis=1, keepdims=True) + 1e-9)
    intra, cross = [], []
    for a in range(0, 24, 3):
        for b in range(1, 24, 3):
            s = wv[g.name2id[f"v{a}"]] @ wv[g.name2id[f"v{b}"]]
            (intra if (a < 12) == (b < 12) else cross).append(s)
    assert np.mean(intra) - np.mean(cross) > 0.2


def _auc(wv, g):
    """Link AUC on cosine similarity (test_torch_line_slice.py's probe)."""
    wv = wv / (np.linalg.norm(wv, axis=1, keepdims=True) + 1e-9)
    src = np.repeat(np.arange(g.n_vertices), np.diff(g.indptr))
    pos_s = (wv[src] * wv[g.indices]).sum(1)
    rng = np.random.default_rng(0)
    a = rng.integers(0, g.n_vertices, 500)
    b = rng.integers(0, g.n_vertices, 500)
    neg_s = (wv[a] * wv[b]).sum(1)
    return (pos_s[:, None] > neg_s[None, :]).mean()


@pytest.mark.parametrize("order", [1, 2])
def test_default_route_quality_matches_jax(graphs, order):
    """Port and smore_tpu trained with the same arguments (the defaults:
    group 8, hoist 32) learn the same structure."""
    jg, tg = graphs
    kw = dict(sample_times=0.2, negative_samples=5, alpha=0.025, batch=128,
              verbose=False)
    m = TLINE(tg, seed=0, device=CPU)
    m.init(dim=32, order=order)
    m.train(**kw)
    auc = _auc(m.state["vertex"].numpy(), tg)
    jm = JLINE(jg, seed=0)
    jm.init(dim=32, order=order)
    jm.train(**kw)
    auc_jax = _auc(np.asarray(jm.state["vertex"]), jg)
    assert auc > 0.8, auc
    assert abs(auc - auc_jax) < 0.08, (auc, auc_jax)
