"""LINE's banded routes off the multiblock path (orders 1 and 2): the
PyTorch port against smore_tpu.

- The ``_make_banded_step`` closures on the same injected draws and rates,
  from smore_tpu's init, after several steps: rtol 2e-5, atol 1e-6 (f32 on
  both sides, differing only in sum order). Plain, scatter-only (K2) and
  fused (K3, order 2 group 1) routes; smore_tpu runs its Pallas kernels in
  interpret mode, the port their twins. The same for the held route's
  ``_make_banded_block_step`` (plain, grouped, K2, K3) and the banded-
  negative ``_make_banded_multiblock_nb_step`` (K5).
- The routing: for the same arguments the port picks the same route
  (multiblock with or without banded negatives, held or not, fused,
  scatter-only or plain), band size, negative window, 1D or 2D tables,
  batch and hoist as smore_tpu's ``train``.
- End to end on the 200-vertex community graph of
  tests/test_pallas_sgns_banded.py, with its probe and margins."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smore_tpu.graph.graph import Graph as JGraph
from smore_tpu.models.line import LINE as JLINE
from smore_tpu.ops.pallas_sgns_banded import fold_table, unfold_table
from smore_tpu_torch.graph.graph import Graph as TGraph
from smore_tpu_torch.models.line import LINE as TLINE
from smore_tpu_torch.ops.scatter import K2
from smore_tpu_torch.ops.sgns_banded import K3, K5

# one intra-op thread: test workers share the cores, and a thread pool
# in each of them oversubscribes the CPU on these tiny shapes
torch.set_num_threads(1)

CPU = torch.device("cpu")  # the port defaults to the card
RTOL, ATOL = 2e-5, 1e-6
BAND = 64


def _edges():
    """The 200-vertex 4-community graph of test_pallas_sgns_banded.py."""
    rng = np.random.default_rng(7)
    edges = []
    for _ in range(3000):
        c = rng.integers(0, 4)
        if rng.random() < 0.9:
            a, b = rng.integers(0, 50, 2) + 50 * c
        else:
            a, b = rng.integers(0, 200, 2)
        if a != b:
            edges.append((f"v{a}", f"v{b}", float(rng.integers(1, 4))))
    return edges


@pytest.fixture(scope="module")
def graphs():
    e = _edges()
    return JGraph.from_edges(e, undirected=True), TGraph.from_edges(
        e, undirected=True)


# ------------------------------------------------------- closure parity
class _Injected:
    """Banded-sampler stand-in: hands out prepared draws in order under the
    two draw methods ``_make_banded_step`` calls; ``wrap`` turns a numpy
    array into the package's array type."""

    def __init__(self, draws, wrap):
        self.draws = [tuple(wrap(a) for a in d) for d in draws]

    def _next(self, *_):
        return self.draws.pop(0)

    draw_banded_batches_hoisted = _next
    draw_banded_batch = _next


def _draws(rng, n_pad, calls, batch, group, ks, hoist, two_d):
    lead = (hoist,) if hoist > 1 else ()
    nb = n_pad // BAND
    out = []
    for _ in range(calls):
        db = rng.integers(0, nb, lead) * BAND
        sb = rng.integers(0, nb, lead) * BAND if two_d else np.zeros_like(db)
        s_hi = BAND if two_d else n_pad
        src = (np.asarray(sb)[..., None]
               + rng.integers(0, s_hi, lead + (batch // group,))).repeat(
                   group, axis=-1)
        # a hot range inside the band: duplicate rows in every batch
        pos = np.asarray(db)[..., None] + np.where(
            rng.random(lead + (batch,)) < 0.3,
            rng.integers(0, 4, lead + (batch,)),
            rng.integers(0, BAND, lead + (batch,)))
        negs = rng.integers(0, n_pad, lead + (ks,))
        out.append(tuple(np.asarray(a, np.int32)
                         for a in (sb, db, src, pos, negs)))
    return out


CLOSURES = {
    **{f"o{o}_g{g}_h{h}_{r}": dict(order=o, group=g, hoist=h, route=r)
       for o in (1, 2) for g in (1, 4) for h in (1, 2)
       for r in ("plain", "scatter")},
    **{f"o2_g1_h{h}_fused": dict(order=2, group=1, hoist=h, route="fused")
       for h in (1, 2)},
}


@pytest.mark.parametrize("case", sorted(CLOSURES))
def test_banded_step_closure_matches_jax(graphs, case):
    c = CLOSURES[case]
    order, group, hoist, route = c["order"], c["group"], c["hoist"], c["route"]
    jg, tg = graphs
    n, D, batch, Ks, calls = jg.n_vertices, 32, 128, 16, 3
    n_pad = -(-n // BAND) * BAND
    jm = JLINE(jg, seed=0)
    jm.init(dim=D, order=order)
    if order == 2:  # a non-zero context, so the first step is not trivial
        jc = JLINE(jg, seed=1)
        jc.init(dim=D, order=1)
        jm.state["context"] = jc.state["vertex"]
    tables = {k: np.pad(np.asarray(v), ((0, n_pad - n), (0, 0)))
              for k, v in jm.state.items()}
    tm = TLINE(tg, seed=0, device=CPU)
    tm.load_state_numpy(tables)
    tm.order = order
    two_d = order == 2
    jm.banded_tables = SimpleNamespace(band_size=BAND, two_d=two_d)
    tm.banded_tables = SimpleNamespace(band_size=BAND, two_d=two_d)

    rng = np.random.default_rng(len(case))
    draws = _draws(rng, n_pad, calls, batch, group, Ks, hoist, two_d)
    alphas = [np.linspace(0.05, 0.04, hoist).astype(np.float32)
              if hoist > 1 else np.float32(0.05 - 0.005 * i)
              for i in range(calls)]
    kw = dict(pallas_scatter=route == "scatter", fused=route == "fused")
    jstep = jm._make_banded_step(batch, 5, Ks, group, hoist, **kw)
    tstep = tm._make_banded_step(batch, 5, Ks, group, hoist, **kw)
    jt, tt = _Injected(draws, jnp.asarray), _Injected(draws, torch.from_numpy)
    jstate = {k: jnp.asarray(v) for k, v in tables.items()}
    tstate = tm.state
    launches = K2.launches, K3.launches
    for a in alphas:
        jstate, jl = jstep(jstate, jt, jax.random.PRNGKey(0),
                           jnp.asarray(a))
        tstate, tl = tstep(tstate, tt, None, torch.from_numpy(np.array(a)))
        np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL,
                                   atol=ATOL)
    # CPU: the twins, no kernel launch
    assert (K2.launches, K3.launches) == launches
    assert set(tstate) == set(jstate)
    for k in jstate:
        np.testing.assert_allclose(tstate[k].numpy(), np.asarray(jstate[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
        assert not np.allclose(tstate[k].numpy(), tables[k])


def _tables(jg, order, D, n_pad):
    """smore_tpu's init (context from another init, so that the first step
    is not trivial), padded to n_pad rows."""
    n = jg.n_vertices
    jm = JLINE(jg, seed=0)
    jm.init(dim=D, order=order)
    if order == 2:
        jc = JLINE(jg, seed=1)
        jc.init(dim=D, order=1)
        jm.state["context"] = jc.state["vertex"]
    return jm, {k: np.pad(np.asarray(v), ((0, n_pad - n), (0, 0)))
                for k, v in jm.state.items()}


class _InjectedBlock:
    def __init__(self, draws, wrap):
        self.draws = [tuple(wrap(a) for a in d) for d in draws]

    def draw_banded_block(self, *_):
        return self.draws.pop(0)


BLOCK_CLOSURES = {
    "g1_plain": (1, {}), "g4_plain": (4, {}),
    "g1_scatter": (1, dict(pallas_scatter=True)),
    "g4_scatter": (4, dict(pallas_scatter=True)),
    "g1_fused": (1, dict(fused=True)),
}


@pytest.mark.parametrize("case", sorted(BLOCK_CLOSURES))
def test_block_step_closure_matches_jax(graphs, case):
    """The held route's closure: one stratum per block of 4 micro-steps."""
    group, kw = BLOCK_CLOSURES[case]
    jg, tg = graphs
    D, batch, Ks, hold, calls = 32, 128, 16, 4, 2
    n_pad = -(-jg.n_vertices // BAND) * BAND
    jm, tables = _tables(jg, 2, D, n_pad)
    tm = TLINE(tg, seed=0, device=CPU)
    tm.load_state_numpy(tables)
    for m in (jm, tm):
        m.banded_tables = SimpleNamespace(band_size=BAND, two_d=True)
    rng = np.random.default_rng(len(case))
    draws = []
    for d in _draws(rng, n_pad, calls, batch, group, Ks, 1, True):
        sb, db, src, pos, _ = d
        # every micro-step of the block in the one stratum (sb, db)
        more = _draws(rng, n_pad, hold, batch, group, Ks, 1, True)
        src = np.stack([src] + [m[2] - m[0] + sb for m in more[1:]])
        pos = np.stack([pos] + [m[3] - m[1] + db for m in more[1:]])
        negs = np.stack([m[4] for m in more])
        negs[:, :2] = db + 1  # an in-band negative, duplicated
        draws.append((sb, db, src, pos, negs))
    jstep = jm._make_banded_block_step(batch, 5, Ks, group, hold, **kw)
    tstep = tm._make_banded_block_step(batch, 5, Ks, group, hold, **kw)
    jt = _InjectedBlock(draws, jnp.asarray)
    tt = _InjectedBlock(draws, torch.from_numpy)
    jstate = {k: jnp.asarray(v) for k, v in tables.items()}
    tstate = tm.state
    for i in range(calls):
        a = np.linspace(0.05, 0.04, hold).astype(np.float32) - 0.005 * i
        jstate, jl = jstep(jstate, jt, jax.random.PRNGKey(0), jnp.asarray(a))
        tstate, tl = tstep(tstate, tt, None, torch.from_numpy(a))
        np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL,
                                   atol=ATOL)
    for k in jstate:
        np.testing.assert_allclose(tstate[k].numpy(), np.asarray(jstate[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
        assert not np.allclose(tstate[k].numpy(), tables[k])


class _InjectedNb:
    """The banded-negative superstep's draws: stream pairs without global
    negatives, then the window draw."""

    stream = True  # the closures take the stream draw

    def __init__(self, draws, wrap, nb2):
        self.nb2 = nb2
        self.pairs = [tuple(wrap(a) for a in d[:4]) + (None,) for d in draws]
        self.negs = [tuple(wrap(a) for a in d[4:]) for d in draws]

    def draw_banded_stream(self, *_, **__):
        return self.pairs.pop(0)

    def draw_neg_banded(self, *_):
        return self.negs.pop(0)


def test_multiblock_nb_step_closure_matches_jax(graphs):
    """The neg_band route's closure, through K5 (smore_tpu in interpret
    mode on folded tables, the port through the twin); window 16 of band
    64, step 1's window in its own context band."""
    jg, tg = graphs
    D, batch, Ks, hoist, nb2, calls = 64, 128, 16, 4, 16, 2
    n_pad = -(-jg.n_vertices // BAND) * BAND
    jm, tables = _tables(jg, 2, D, n_pad)
    tm = TLINE(tg, seed=0, device=CPU)
    tm.load_state_numpy(tables)
    for m in (jm, tm):
        m.banded_tables = SimpleNamespace(band_size=BAND, two_d=True)
    rng = np.random.default_rng(5)
    nbands = n_pad // BAND
    draws = []
    for _ in range(calls):
        sb = rng.integers(0, nbands, hoist) * BAND
        db = rng.integers(0, nbands, hoist) * BAND
        nb = rng.integers(0, n_pad // nb2, hoist)
        nb[1] = db[1] // nb2 + 1
        draws.append(tuple(np.asarray(a, np.int32) for a in (
            sb, db, rng.integers(0, BAND, (hoist, batch)),
            rng.integers(0, BAND, (hoist, batch)), nb,
            rng.integers(0, nb2, (hoist, Ks)))))
    jstep = jm._make_banded_multiblock_nb_step(batch, 5, Ks, hoist)
    tstep = tm._make_banded_multiblock_nb_step(batch, 5, Ks, hoist)
    jt = _InjectedNb(draws, jnp.asarray, nb2)
    tt = _InjectedNb(draws, torch.from_numpy, nb2)
    jstate = {"wvf": fold_table(jnp.asarray(tables["vertex"])),
              "wcf": fold_table(jnp.asarray(tables["context"]))}
    tstate = tm.state
    before = K5.launches
    for i in range(calls):
        a = np.linspace(0.05, 0.04, hoist).astype(np.float32) - 0.005 * i
        jstate, jl = jstep(jstate, jt, jax.random.PRNGKey(0), jnp.asarray(a))
        tstate, tl = tstep(tstate, tt, None, torch.from_numpy(a))
        np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL,
                                   atol=ATOL)
    assert K5.launches == before  # CPU: the twin
    for k, jk in (("vertex", "wvf"), ("context", "wcf")):
        want = np.asarray(unfold_table(jstate[jk]))
        np.testing.assert_allclose(tstate[k].numpy(), want, rtol=RTOL,
                                   atol=ATOL, err_msg=k)
        assert not np.allclose(tstate[k].numpy(), tables[k])


# -------------------------------------------------------------- routing
class _Stop(Exception):
    pass


def _route_of(cls, g, order, dim, kw, monkeypatch, **init):
    """Train until the step closure is made; returns what routed there."""
    seen = {}

    def banded(self, batch, negatives, shared_negatives, group, hoist=1,
               pallas_scatter=False, fused=False):
        seen.update(kind="fused" if fused else
                    "scatter" if pallas_scatter else "plain",
                    batch=batch, ks=shared_negatives, group=group,
                    hoist=hoist)
        raise _Stop

    def multi(self, batch, negatives, shared_negatives, hoist):
        seen.update(kind="multiblock", batch=batch, ks=shared_negatives,
                    hoist=hoist)
        raise _Stop

    def multi_nb(self, batch, negatives, shared_negatives, hoist):
        seen.update(kind="multiblock_nb", batch=batch, ks=shared_negatives,
                    hoist=hoist)
        raise _Stop

    def held(self, batch, negatives, shared_negatives, group, hold,
             pallas_scatter=False, fused=False):
        seen.update(kind="held_fused" if fused else
                    "held_scatter" if pallas_scatter else "held_plain",
                    batch=batch, ks=shared_negatives, group=group,
                    hoist=hold)
        raise _Stop

    monkeypatch.setattr(cls, "_make_banded_step", banded)
    monkeypatch.setattr(cls, "_make_banded_multiblock_step", multi)
    monkeypatch.setattr(cls, "_make_banded_multiblock_nb_step", multi_nb)
    monkeypatch.setattr(cls, "_make_banded_block_step", held)
    m = cls(g, seed=0, **init)
    m.init(dim=dim, order=order)
    with pytest.raises(_Stop):
        m.train(sample_times=0.01, banded=True, verbose=False, **kw)
    bt = m.banded_tables
    seen.update(band=bt.band_size, two_d=bt.two_d, n_bands=bt.n_bands,
                nb2=bt.nb2)
    return seen


ROUTES = {
    "o2_auto": (2, 64, {}),
    "o2_multiband_true": (2, 64, dict(multiband=True, band_size=BAND)),
    "o2_multiblock_batch128": (2, 64, dict(multiband=True, batch=128,
                                           band_size=BAND)),
    "o2_multiband_true_dim16": (2, 16, dict(multiband=True)),
    "o2_multiband_true_band_not_16": (2, 64, dict(multiband=True,
                                                  band_size=72)),
    "o2_pallas_true": (2, 64, dict(multiband=False, use_pallas=True)),
    "o2_pallas_true_band64": (2, 64, dict(multiband=False, use_pallas=True,
                                          band_size=BAND)),
    "o2_pallas_true_batch128": (2, 16, dict(use_pallas=True, batch=128)),
    "o2_pallas_true_batch100": (2, 16, dict(use_pallas=True, batch=100,
                                            group=1)),
    "o2_pallas_true_group4": (2, 16, dict(use_pallas=True, group=4)),
    "o2_scatter": (2, 16, dict(use_pallas="scatter", multiband=False)),
    "o2_pallas_false_hoist1": (2, 16, dict(use_pallas=False, hoist=1)),
    "o1_auto": (1, 16, {}),
    "o1_pallas_true": (1, 16, dict(use_pallas=True)),
    "o1_pallas_true_group1_batch128": (1, 16, dict(use_pallas=True, group=1,
                                                   batch=128)),
    "o1_band64_hoist4": (1, 16, dict(band_size=BAND, hoist=4)),
    "o1_shared_negs_32": (1, 16, dict(shared_negatives=32, batch=64)),
    "o2_neg_band": (2, 64, dict(multiband=True, neg_band=True, batch=128,
                                band_size=BAND)),
    "o2_neg_band_ks12": (2, 64, dict(multiband=True, neg_band=True,
                                     batch=128, band_size=BAND,
                                     shared_negatives=12)),
    "o2_neg_band_no_multiband": (2, 64, dict(multiband=False,
                                             neg_band=True)),
    "o2_band_hold_hoist4": (2, 16, dict(multiband=False, band_hold=True,
                                        hoist=4)),
    "o2_band_hold_auto_hoist": (2, 16, dict(multiband=False,
                                            band_hold=True)),
    "o2_band_hold_fused": (2, 16, dict(multiband=False, band_hold=True,
                                       use_pallas=True, batch=128)),
    "o2_band_hold_group4": (2, 16, dict(multiband=False, band_hold=True,
                                        use_pallas=True, group=4)),
    "o2_band_hold_multiband": (2, 64, dict(multiband=True, band_hold=True,
                                           batch=128, band_size=BAND)),
    "o2_band_hold_hoist1": (2, 16, dict(multiband=False, band_hold=True,
                                        hoist=1)),
    "o1_band_hold": (1, 16, dict(band_hold=True, hoist=4)),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_banded_routing_matches_jax(graphs, route, monkeypatch):
    jg, tg = graphs
    order, dim, kw = ROUTES[route]
    want = _route_of(JLINE, jg, order, dim, kw, monkeypatch)
    got = _route_of(TLINE, tg, order, dim, kw, monkeypatch, device=CPU)
    assert got == want


# ----------------------------------------------------------- end to end
def _auc(wv, g):
    """Link AUC on cosine similarity (test_pallas_sgns_banded.py's probe)."""
    wv = wv / (np.linalg.norm(wv, axis=1, keepdims=True) + 1e-9)
    src = np.repeat(np.arange(g.n_vertices), np.diff(g.indptr))
    pos_s = (wv[src] * wv[g.indices]).sum(1)
    rng = np.random.default_rng(0)
    a = rng.integers(0, g.n_vertices, 500)
    b = rng.integers(0, g.n_vertices, 500)
    neg_s = (wv[a] * wv[b]).sum(1)
    return (pos_s[:, None] > neg_s[None, :]).mean()


def _train(tg, order, dim=16, **kw):
    m = TLINE(tg, seed=0, device=CPU)
    m.init(dim=dim, order=order)
    m.train(**dict(dict(sample_times=0.2, negative_samples=5, alpha=0.025,
                        batch=128, steps_per_call=32, banded=True,
                        band_size=BAND, verbose=False), **kw))
    wv = m.state["vertex"].numpy()
    assert wv.shape == (tg.n_vertices, dim) and np.isfinite(wv).all()
    for t in m.state.values():
        assert bool(torch.isfinite(t).all())
    return m, _auc(wv, tg)


def test_fused_route_quality(graphs):
    """test_line_banded_fused_e2e_quality's arguments: the fused route (K3's
    twin) learns the communities, within 0.08 of the plain route."""
    _, tg = graphs
    kw = dict(group=1, hoist=2, multiband=False)
    m, auc_fused = _train(tg, 2, use_pallas=True, **kw)
    assert m.banded_tables.two_d and m.last_driver.micro_steps == 2
    _, auc_plain = _train(tg, 2, use_pallas=False, **kw)
    assert auc_fused > 0.8, auc_fused
    assert abs(auc_fused - auc_plain) < 0.08, (auc_fused, auc_plain)


@pytest.mark.parametrize("use_pallas", ["auto", True])
def test_order1_banded_quality(graphs, use_pallas):
    """Order 1 on 1D band tables, plain ("auto" on the CPU) and through K2's
    twin (True), learns the communities."""
    _, tg = graphs
    m, auc = _train(tg, 1, use_pallas=use_pallas)
    assert "context" not in m.state and not m.banded_tables.two_d
    assert auc > 0.8, auc


@pytest.mark.parametrize("route,kw", [
    ("plain", dict(group=4)),
    ("fused", dict(group=1, use_pallas=True)),
])
def test_band_hold_quality(graphs, route, kw):
    """tests/test_banded.py's band-hold e2e arguments: the held route
    learns the communities, within 0.08 of the per-step route."""
    _, tg = graphs
    kw = dict(kw, multiband=False, hoist=4, sample_times=0.3,
              steps_per_call=64)
    m, auc_hold = _train(tg, 2, band_hold=True, **kw)
    assert m.last_driver.micro_steps == 4
    assert m.last_driver.step_fn.__qualname__.startswith(
        "LINE._make_banded_block_step")
    _, auc_step = _train(tg, 2, band_hold=False, **kw)
    assert auc_hold > 0.8, auc_hold
    assert abs(auc_hold - auc_step) < 0.08, (auc_hold, auc_step)


def test_neg_band_quality(graphs):
    """The neg_band route (K5's twin, whole-band windows at band 64)
    learns the communities, within 0.08 of the plain multiblock route."""
    _, tg = graphs
    kw = dict(multiband=True, hoist=4, dim=64)
    m, auc_nb = _train(tg, 2, neg_band=True, **kw)
    assert m.banded_tables.nb2 == BAND
    assert m.last_driver.step_fn.__qualname__.startswith(
        "LINE._make_banded_multiblock_nb_step")
    _, auc_multi = _train(tg, 2, **kw)
    assert auc_nb > 0.8, auc_nb
    assert abs(auc_nb - auc_multi) < 0.08, (auc_nb, auc_multi)
