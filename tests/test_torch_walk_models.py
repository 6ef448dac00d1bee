"""The port's walk family (DeepWalk, Walklets, node2vec, APP) against
smore_tpu's.

- Policy: with both packages' TrainDriver and ``_make_step`` replaced by
  recorders, ``_run`` chooses the same batch, hoist, epoch starts, inner
  passes and alpha over a grid of graph sizes and budgets;
  ``freshness_policy`` and ``trunc_mass_multiplier`` agree over a grid.
- One update: the step closures on the same pairs, mask, negatives, tables
  and rate agree within test_torch_update.py's rtol 1e-5, atol 1e-6, with
  one inner pass and with the truncated budget's four.
- Quality: the four models learn the two communities of
  tests/test_walk_models.py at its thresholds and arguments.
- Weights: smore_tpu's ``init`` tables, taken by ``load_state_numpy``,
  save to a byte-equal file.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smore_tpu.models.walk_base as JWB
import smore_tpu_torch.models.base as TBASE
import smore_tpu_torch.models.walk_base as TWB
from smore_tpu.graph.graph import Graph as JGraph
from smore_tpu.models import APP as JAPP
from smore_tpu.models import DeepWalk as JDeepWalk
from smore_tpu.models import Node2Vec as JNode2Vec
from smore_tpu.models import Walklets as JWalklets
from smore_tpu.models.base import freshness_policy as j_fresh
from smore_tpu.models.base import trunc_mass_multiplier as j_mass
from smore_tpu_torch.graph.graph import Graph as TGraph
from smore_tpu_torch.models import APP, DeepWalk, Node2Vec, Walklets
from smore_tpu_torch.models.base import freshness_policy as t_fresh
from smore_tpu_torch.models.base import trunc_mass_multiplier as t_mass

# one intra-op thread: test workers share the cores, and a thread pool
# in each of them oversubscribes the CPU on these tiny shapes
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
CPU = torch.device("cpu")  # the port defaults to the card

MODELS = {"deepwalk": (JDeepWalk, DeepWalk), "walklets": (JWalklets, Walklets),
          "node2vec": (JNode2Vec, Node2Vec), "app": (JAPP, APP)}


def _comm_edges():
    """tests/test_walk_models.py's two dense 12-vertex communities and one
    bridge edge."""
    rng = np.random.default_rng(7)
    edges = []
    for base in (0, 12):
        for i in range(12):
            for j in range(i + 1, 12):
                if rng.random() < 0.6:
                    edges.append((f"v{base + i}", f"v{base + j}", 1.0))
    edges.append(("v0", "v12", 1.0))
    return edges


@pytest.fixture(scope="module")
def graphs():
    e = _comm_edges()
    return JGraph.from_edges(e, undirected=True), TGraph.from_edges(
        e, undirected=True)


# --------------------------------------------------------------- policy
def test_freshness_policy_and_mass_multiplier_match_jax():
    for total in (0, 100, 9_600, 40_000, 200_000, 2_000_000, 40_000_000):
        for batch in (4, 8, 39, 64, 128, 8192):
            for hoist in (1, 3, 32):
                assert t_fresh(total, batch, hoist) == j_fresh(total, batch,
                                                               hoist)
    for rebatched in (1, 8, 26, 64, 65, 1300, 8192):
        assert t_mass(rebatched) == j_mass(rebatched)


class _Stop:
    """Stands in for TrainDriver: records its arguments, trains nothing."""

    seen = []

    def __init__(self, step_fn, **kw):
        self.kw = kw
        _Stop.seen.append(kw)

    def train(self, state, key, verbose=True):
        return state


def _policy(cls, module, n, monkeypatch, **train_kw):
    made = {}

    def make_step(self, batch_walks, negatives, shared_negatives, collision,
                  hoist=1, epoch_starts=False):
        made.update(batch_walks=batch_walks, hoist=hoist,
                    epoch_starts=epoch_starts,
                    inner_passes=getattr(self, "inner_passes", 1))
        return None

    # the port's models build their driver in PairModelBase._drive
    monkeypatch.setattr(TBASE if module is TWB else module, "TrainDriver",
                        _Stop)
    monkeypatch.setattr(cls, "_make_step", make_step)
    monkeypatch.setattr(cls, "_make_ctx", lambda self: None)
    kw = {"device": CPU} if module is TWB else {}
    m = cls(SimpleNamespace(n_vertices=n), seed=0, **kw)
    _Stop.seen = []
    m.train(verbose=False, **train_kw)
    d = _Stop.seen[0]
    made.update({k: d[k] for k in ("samples_per_step", "alpha",
                                   "total_samples", "steps_per_call",
                                   "micro_steps")})
    return made


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("n", [24, 20_000, 140_000])
def test_run_policy_matches_jax(model, n, monkeypatch):
    """Batch, hoist, epoch starts, inner passes and alpha as smore_tpu's,
    over budgets and batches at three graph sizes (the last above the
    epoch hoist's 131,072 vertices)."""
    jcls, tcls = MODELS[model]
    grid = [dict(walk_times=wt, batch_walks=bw, alpha=0.025,
                 steps_per_call=64)
            for wt in (1, 2, 10, 100) for bw in (8, 128, 8192)]
    if model == "app":
        grid = [dict(g, sample_times=st) for g in grid for st in (1, 20)]
    for kw in grid:
        want = _policy(jcls, JWB, n, monkeypatch, **kw)
        got = _policy(tcls, TWB, n, monkeypatch, **kw)
        assert got == want, kw


# ----------------------------------------------------------- one update
class _Tables:
    """Sampler stand-in: the draw reads only the vertex count and the
    negative pool."""

    def __init__(self, n, negs, wrap):
        self.vertex_prob = np.zeros(n)  # smore_tpu reads the count here
        self.n_vertices = n
        self.device = CPU
        self.negs = wrap(negs)

    def negative_sample(self, *_):
        return self.negs


@pytest.mark.parametrize("passes", [1, 4])
@pytest.mark.parametrize("collision", ["sum", "mean"])
def test_deepwalk_update_matches_jax(graphs, passes, collision,
                                     monkeypatch):
    jg, tg = graphs
    n, D, Ks, K = jg.n_vertices, 16, 32, 5
    rng = np.random.default_rng(passes)
    M = 8 * 41 * 10  # 8 walks of 41 vertices, 10 offsets
    src = rng.integers(0, n, M).astype(np.int32)
    pos = rng.integers(0, n, M).astype(np.int32)
    mask = (rng.random(M) < 0.7).astype(np.float32)
    negs = rng.integers(0, n, Ks).astype(np.int32)
    jm = JDeepWalk(jg, seed=0)
    jm.init(dim=D)
    jc = JDeepWalk(jg, seed=1)  # a non-zero context table
    jc.init(dim=D)
    jm.state["context"] = jc.state["vertex"]
    tm = DeepWalk(tg, seed=0, device=CPU)
    tm.load_state_numpy({k: np.asarray(v) for k, v in jm.state.items()})
    for m, wrap in ((jm, jnp.asarray), (tm, torch.from_numpy)):
        m.inner_passes = passes
        x = tuple(wrap(a) for a in (src, pos, mask))
        monkeypatch.setattr(m, "_emit_pairs", lambda *_, x=x: x)
    jstep = jm._make_step(8, K, Ks, collision)
    tstep = tm._make_step(8, K, Ks, collision)
    js, jl = jstep(dict(jm.state), _Tables(n, negs, jnp.asarray),
                   jax.random.PRNGKey(0), jnp.float32(0.05))
    ts, tl = tstep(tm.state, _Tables(n, negs, torch.from_numpy),
                   torch.Generator(), torch.tensor(0.05))
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL, atol=ATOL)
    for k in ("vertex", "context"):
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert not np.allclose(ts["vertex"].numpy(),
                           np.asarray(jm.state["vertex"]))


# -------------------------------------------------------------- quality
def _separation(wv, g, wc=None):
    """Mean intra- minus mean cross-community score (cosine of vertex
    rows, or vertex . context with ``wc``), test_walk_models.py's probe."""
    if wc is None:
        wv = wv / (np.linalg.norm(wv, axis=1, keepdims=True) + 1e-9)
        wc = wv
    intra, cross = [], []
    for a in range(0, 24, 3):
        for b in range(1, 24, 3):
            s = wv[g.name2id[f"v{a}"]] @ wc[g.name2id[f"v{b}"]]
            (intra if (a < 12) == (b < 12) else cross).append(s)
    return np.mean(intra) - np.mean(cross)


TRAIN_KW = dict(walk_times=100, negative_samples=5, alpha=0.01,
                batch_walks=8, steps_per_call=16, collision="sum",
                verbose=False)


@pytest.mark.parametrize("model,kw", [
    ("deepwalk", dict(walk_steps=10, window_size=3)),
    ("walklets", dict(walk_steps=10, window_min=1, window_max=3)),
    ("node2vec", dict(walk_steps=10, window_size=3, p=0.5, q=2.0)),
])
def test_skipgram_models_learn_communities(graphs, model, kw):
    _, tg = graphs
    m = MODELS[model][1](tg, seed=0, device=CPU)
    m.init(dim=16)
    m.train(**TRAIN_KW, **kw)
    assert _separation(m.state["vertex"].numpy(), tg) > 0.2


def test_app_learns_communities(graphs):
    _, tg = graphs
    m = APP(tg, seed=0, device=CPU)
    m.init(dim=16)
    m.train(walk_times=100, sample_times=4, jump=0.3, negative_samples=5,
            alpha=0.01, batch_walks=64, steps_per_call=16, collision="sum",
            verbose=False)
    # APP scores with vertex . context (asymmetric proximity)
    assert _separation(m.state["vertex"].numpy(), tg,
                       m.state["context"].numpy()) > 0


def test_node2vec_homophily_matches_jax(graphs):
    jg, tg = graphs
    jm = JNode2Vec(jg, seed=0)
    jm.init(dim=8)
    tm = Node2Vec(tg, seed=0, device=CPU)
    tm.load_state_numpy({k: np.asarray(v) for k, v in jm.state.items()})
    for t in (0.0, 0.3, 0.5):
        assert tm.compute_homophily(t) == jm.compute_homophily(t)


def test_walk_models_reject_a_mesh(graphs):
    _, tg = graphs
    m = DeepWalk(tg, seed=0, device=CPU)
    m.init(dim=8)
    with pytest.raises(TypeError, match="1-D DeviceMesh"):
        m.train(walk_times=1, verbose=False, mesh=object())
    with pytest.raises(ValueError, match="sharding must be"):
        m.train(walk_times=1, verbose=False, sharding="columns")


# -------------------------------------------------------------- weights
@pytest.mark.parametrize("model", sorted(MODELS))
def test_saved_weights_byte_equal(graphs, model, tmp_path):
    jg, tg = graphs
    jcls, tcls = MODELS[model]
    jm = jcls(jg, seed=0)
    jm.init(dim=8)
    tm = tcls(tg, seed=0, device=CPU)
    tm.load_state_numpy({k: np.asarray(v) for k, v in jm.state.items()})
    assert set(tm.state) == {"vertex", "context"}
    a, b = tmp_path / "jax.txt", tmp_path / "port.txt"
    jm.save_weights(str(a))
    tm.save_weights(str(b))
    assert a.read_bytes() == b.read_bytes()
    assert a.read_text().split("\n")[0] == f"{jg.n_vertices} 8"
