"""LINE order 2 on the banded multiblock path: the PyTorch port against
smore_tpu.

One superstep on injected draws (rtol 2e-5, atol 1e-6: f32 on both sides,
differing only in sum order), TrainDriver's alpha schedule (bit-equal in
f32), the routing (same batch, band, micro-steps and steps per call), end
to end quality on a toy community graph, a ``mesh`` that is not a
DeviceMesh, the unbanded and the other banded routes that now train, and
the entry points' default device (the card)."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smore_tpu.graph.graph import Graph as JGraph
from smore_tpu.models.base import TrainDriver as JDriver
from smore_tpu.models.line import LINE as JLINE
from smore_tpu.ops.pallas_sgns_banded import (
    fold_table,
    sgns_banded_multiblock as jax_multiblock,
    unfold_table,
)
from smore_tpu_torch.graph.graph import Graph as TGraph
from smore_tpu_torch.models.base import TrainDriver as TDriver
from smore_tpu_torch.models.base import init_embedding, zeros_embedding
from smore_tpu_torch.models.line import LINE as TLINE
from smore_tpu_torch.models.line import multiblock_apply
from smore_tpu_torch.sampling.banded import BandedTables
from smore_tpu_torch.sampling.tables import SamplerTables, build_negative_table
from smore_tpu_torch.utils.checkpoint import save_checkpoint

# one intra-op thread: test workers share the cores, and a thread pool
# in each of them oversubscribes the CPU on these tiny shapes
torch.set_num_threads(1)

BAND = 64
RTOL, ATOL = 2e-5, 1e-6

CPU = torch.device("cpu")  # the port defaults to the card


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


def test_one_superstep_matches_jax(graphs):
    jg, tg = graphs
    n = jg.n_vertices
    n_pad = -(-n // BAND) * BAND
    S, B, Ks, D = 4, 128, 16, 64
    jm = JLINE(jg, seed=0)
    jm.init(dim=D, order=2)
    jc = JLINE(jg, seed=1)
    jc.init(dim=D, order=2)

    def pad(a):
        out = np.zeros((n_pad, D), np.float32)
        out[:n] = np.asarray(a)
        return out

    # context from another JAX init, so the first step is not trivial
    tables = {"vertex": pad(jm.state["vertex"]),
              "context": pad(jc.state["vertex"])}
    rng = np.random.default_rng(11)
    sb = np.asarray([1, 0, 1, 2], np.int32) * BAND  # band START rows
    db = np.asarray([2, 2, 2, 2], np.int32) * BAND  # step 3: sb == db
    src_l = rng.integers(0, BAND, (S, B)).astype(np.int32)
    pos_l = rng.integers(0, BAND, (S, B)).astype(np.int32)
    negs = rng.integers(0, n, (S, Ks)).astype(np.int32)  # also in-band rows
    alphas = np.asarray([0.025, 0.02, 0.015, 0.01], np.float32)

    # smore_tpu's superstep (line.py _make_banded_multiblock_step): cn
    # snapshot -> kernel on folded tables -> deferred d_neg apply
    wv, wc = jnp.asarray(tables["vertex"]), jnp.asarray(tables["context"])
    cn = wc[negs.reshape(-1)].reshape(S, Ks, D)
    wvf, wcf, d_neg, loss_sum = jax_multiblock(
        fold_table(wv), fold_table(wc), jnp.asarray(sb // BAND),
        jnp.asarray(db // BAND), jnp.asarray(src_l), jnp.asarray(pos_l), cn,
        jnp.asarray(alphas), band_size=BAND, k_equiv=5, interpret=True,
    )
    want_v = unfold_table(wvf)
    want_c = unfold_table(wcf).at[negs.reshape(-1)].add(d_neg.reshape(-1, D))

    m = TLINE(tg, seed=0, device=CPU)
    m.load_state_numpy(tables)
    assert m.dim == D and m.state["vertex"].dtype == torch.float32
    t = [torch.from_numpy(a) for a in (sb, db, src_l, pos_l, negs, alphas)]
    loss = multiblock_apply(m.state, BAND, *t, k_equiv=5)
    got = m.state_numpy()
    np.testing.assert_allclose(got["vertex"], np.asarray(want_v),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["context"], np.asarray(want_c),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(loss), float(loss_sum) / (S * B),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("micro_steps", [1, 4])
@pytest.mark.parametrize("total,per_step,spc,alpha", [
    (100_000, 128, 32, 0.025),
    (77_777, 96, 5, 0.0173),
])
def test_alpha_schedule_equals_jax(micro_steps, total, per_step, spc, alpha):
    sps = per_step * micro_steps
    steps = -(-(-(-total // sps)) // spc) * spc
    M = micro_steps

    def jstep(st, ctx, key, a):
        a = jnp.reshape(a, (-1,))
        log = jax.lax.dynamic_update_slice(st["log"], a, (st["i"][0] * M,))
        return {"log": log, "i": st["i"] + 1}, jnp.float32(0)

    jd = JDriver(jstep, ctx=None, samples_per_step=sps, alpha=alpha,
                 total_samples=total, steps_per_call=spc, micro_steps=M)
    out = jd.train({"log": jnp.zeros(steps * M, jnp.float32),
                    "i": jnp.zeros(1, jnp.int32)},
                   jax.random.PRNGKey(0), verbose=False)
    want = np.asarray(out["log"])

    seen = []

    def tstep(state, ctx, gen, a):
        assert a.dtype == torch.float32
        assert a.shape == ((M,) if M > 1 else ())
        seen.append(a.reshape(-1).clone())
        return state, torch.zeros(())

    td = TDriver(tstep, ctx=None, samples_per_step=sps, alpha=alpha,
                 total_samples=total, steps_per_call=spc, micro_steps=M,
                 device=CPU)
    td.train({}, torch.Generator(), verbose=False)
    got = torch.cat(seen).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert td.executed_samples == jd.executed_samples == steps * sps


@pytest.mark.parametrize("hoist,spc", [(0, 128), (4, 32)])
def test_routing_matches_jax(graphs, hoist, spc):
    """Same route parameters as smore_tpu for the same arguments."""
    jg, tg = graphs
    kw = dict(sample_times=0.01, negative_samples=5, alpha=0.025, batch=128,
              hoist=hoist, steps_per_call=spc, banded=True, multiband=True,
              band_size=BAND, verbose=False)
    jm = JLINE(jg, seed=0)
    jm.init(dim=64, order=2)
    jm.train(**kw)
    tm = TLINE(tg, seed=0, device=CPU)
    tm.init(dim=64, order=2)
    tm.train(**kw)
    jd, td = jm.last_driver, tm.last_driver
    for f in ("samples_per_step", "steps_per_call", "micro_steps",
              "total_samples", "executed_samples"):
        assert getattr(jd, f) == getattr(td, f), f
    jb, tb = jm.banded_tables, tm.banded_tables
    assert (jb.band_size, jb.n_bands) == (tb.band_size, tb.n_bands)
    assert np.array_equal(np.asarray(jb.stream), tb.stream.numpy())


def test_line_end_to_end_quality(graphs, tmp_path):
    """Port and smore_tpu trained with the same arguments learn the same
    structure (the e2e probe and margins of test_pallas_sgns_banded.py)."""
    jg, tg = graphs
    kw = dict(banded=True, multiband=True, band_size=BAND, batch=128,
              hoist=4, sample_times=0.2, negative_samples=5, alpha=0.025,
              group=1, steps_per_call=32, verbose=False)
    m = TLINE(tg, seed=0, device=CPU)
    m.init(dim=64, order=2)
    m.train(**kw)
    wv = m.state["vertex"].numpy()
    assert wv.shape == (tg.n_vertices, 64)
    assert np.isfinite(wv).all() and np.isfinite(m.state["context"].numpy()).all()
    auc = _auc(wv, tg)

    jm = JLINE(jg, seed=0)
    jm.init(dim=64, order=2)
    jm.train(**kw)
    auc_jax = _auc(np.asarray(jm.state["vertex"]), jg)
    assert auc > 0.8, auc
    assert abs(auc - auc_jax) < 0.08, (auc, auc_jax)

    p = tmp_path / "emb.txt"
    m.save_weights(str(p))
    lines = p.read_text().splitlines()
    assert lines[0] == f"{tg.n_vertices} 64"
    first = lines[1].split()
    assert first[0] == tg.names[0] and len(first) == 65
    np.testing.assert_allclose(np.asarray(first[1:], np.float32), wv[0],
                               rtol=1e-5, atol=1e-6)


_BANDED_KW = dict(sample_times=0.01, batch=128, band_size=BAND, banded=True,
                  multiband=True, verbose=False)


@pytest.mark.parametrize("route", ["mesh"])
def test_unported_routes_raise(graphs, route):
    """Every route is ported; a mesh that is not a 1-D DeviceMesh raises
    (tests/test_torch_parallel.py trains on real ones)."""
    _, tg = graphs
    m = TLINE(tg, seed=0, device=CPU)
    m.init(dim=64, order=2)
    kw = dict(_BANDED_KW, **{
        "mesh": dict(mesh=object()),
    }[route])
    with pytest.raises(TypeError, match="1-D DeviceMesh"):
        m.train(**kw)


@pytest.mark.parametrize("route,order,kw", [
    ("fused", 2, dict(multiband=False, use_pallas=True)),
    ("order1", 1, {}),
    ("order1_scatter", 1, dict(use_pallas=True)),
    ("no_multiband", 2, dict(multiband=False, use_pallas=False)),
    ("scatter_group4", 2, dict(multiband=False, use_pallas=True, group=4)),
    ("band_hold", 2, dict(multiband=False, band_hold=True, use_pallas=False)),
    ("neg_band", 2, dict(neg_band=True)),
])
def test_banded_routes_train(graphs, route, order, kw):
    """The routes that raised before the banded routes were ported: they
    train on band tables (1D for order 1, 2D for order 2); neg_band on the
    multiblock route's 16 micro-steps per superstep."""
    _, tg = graphs
    m = TLINE(tg, seed=0, device=CPU)
    m.init(dim=64, order=order)
    m.train(**dict(_BANDED_KW, **kw))
    bt = m.banded_tables
    assert bt is not None and bt.two_d == (order == 2)
    assert m.last_driver.ctx is bt
    assert m.last_driver.micro_steps == (16 if route == "neg_band" else 8)
    assert m.last_driver.executed_samples >= 10_000
    for v in m.state.values():
        assert v.shape == (tg.n_vertices, 64) and torch.isfinite(v).all()


def test_scatter_route_rejects_untiled_batch(graphs):
    """batch 100 does not tile: smore_tpu routes it to its scatter kernel
    and fails that kernel's assert; the port's K2 shape check raises."""
    _, tg = graphs
    m = TLINE(tg, seed=0, device=CPU)
    m.init(dim=64, order=2)
    with pytest.raises(ValueError, match="tile"):
        m.train(**dict(_BANDED_KW, multiband=False, use_pallas=True, group=1,
                       batch=100))


@pytest.mark.parametrize("route", ["banded_false", "auto_small_graph",
                                   "order1_banded_false"])
def test_unbanded_routes_train(graphs, route):
    """The routes that raised before the unbanded path was ported: a graph
    under 262,144 vertices (or banded=False) trains on SamplerTables, with
    orders 1 and 2."""
    _, tg = graphs
    m = TLINE(tg, seed=0, device=CPU)
    m.init(dim=64, order=1 if route.startswith("order1") else 2)
    kw = dict(sample_times=0.01, batch=128, verbose=False)
    if route != "auto_small_graph":
        kw.update(banded=False, multiband=True, band_size=BAND)
    m.train(**kw)
    assert m.banded_tables is None
    assert isinstance(m.last_driver.ctx, SamplerTables)
    assert m.last_driver.executed_samples >= 10_000
    for v in m.state.values():
        assert v.shape == (tg.n_vertices, 64) and torch.isfinite(v).all()


def test_driver_checkpoint_raises(tmp_path):
    """Checkpoints are ported: a resume from a checkpoint whose tables
    differ in shape from the run's raises instead of training on."""
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, {"vertex": torch.zeros(3, 2)}, step=1,
                    extra={"gen": torch.Generator().get_state()})
    d = TDriver(lambda *a: None, ctx=None, samples_per_step=1, alpha=0.1,
                total_samples=4, checkpoint_path=ckpt, device=CPU)
    with pytest.raises(ValueError, match="holds tables"):
        d.train({"vertex": torch.zeros(4, 2)}, torch.Generator(),
                verbose=False)


def test_entry_points_default_to_the_card(graphs):
    """No device given: the model and the driver are on the CUDA card.
    Neither constructor allocates, so this holds without a card too."""
    _, tg = graphs
    assert TLINE(tg).device.type == "cuda"
    d = TDriver(lambda *a: None, ctx=None, samples_per_step=1, alpha=0.1,
                total_samples=1)
    assert d.device.type == "cuda"
    for fn in (SamplerTables.build, BandedTables.build, build_negative_table,
               init_embedding, zeros_embedding):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():  # no fallback to the CPU
        with pytest.raises((AssertionError, RuntimeError)):
            TLINE(tg).init(dim=8, order=2)
        with pytest.raises((AssertionError, RuntimeError)):
            BandedTables.build(tg, band_size=BAND)
