"""The port's banded draws on the device (the CPU here) against the exact
sampling law.

torch's generator and JAX's threefry give different numbers, so the draws
are held to the law, as tests/test_banded.py and tests/test_hoisted_draws.py
hold the JAX package's: stratum frequencies against the stratum mass,
band-local rows in range, every drawn pair a real edge of its stratum, the
conditional pair law inside a stratum, and the negatives against deg^0.75.
The grouped and per-step draws of the other banded routes, on 2D and 1D
tables: the repeat layout of src, sb == 0 on 1D tables, the stratum mass,
the joint law of each group's first pair and the within-(src, stratum)
context law of its other pairs. The held route's block draw (one stratum
for every micro-step of a block), and the banded negatives of the
``neg_band`` route: window frequencies against window mass, the
window-local draws against deg^0.75 within the window, and the stream draw
without global negatives."""

import numpy as np
import pytest
import torch

from smore_tpu_torch.graph.graph import Graph
from smore_tpu_torch.models.line import multiblock_draw
from smore_tpu_torch.sampling.banded import BandedTables
from smore_tpu_torch.sampling.tables import _vertex_distribution

# one intra-op thread: test workers share the cores, and a thread pool
# in each of them oversubscribes the CPU on these tiny shapes
torch.set_num_threads(1)

BAND = 64

CPU = torch.device("cpu")  # the port defaults to the card


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
    bt = BandedTables.build(g, band_size=BAND, two_d=True, device=CPU)
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


# --------------------------------------------- grouped and per-step draws
def _grouped(bt, gen, batch, group, n_negs, steps, per_step):
    """``steps`` draws of either form, stacked as the hoisted draw's."""
    if not per_step:
        return bt.draw_banded_batches_hoisted(gen, batch, group, n_negs,
                                              steps)
    xs = [bt.draw_banded_batch(gen, batch, group, n_negs)
          for _ in range(steps)]
    assert xs[0][0].shape == xs[0][1].shape == ()
    return tuple(torch.stack(col) for col in zip(*xs))


def _strata(bt, sb, db):
    nb = bt.n_bands
    if bt.two_d:
        return (sb.numpy() // BAND) * nb + db.numpy() // BAND
    return db.numpy() // BAND


@pytest.mark.parametrize("two_d", [True, False])
@pytest.mark.parametrize("per_step", [False, True])
def test_grouped_layout(graph, two_d, per_step):
    """src is the repeat layout of batch // group sources, every pair is an
    edge of its stratum, and sb is 0 on 1D tables."""
    g, G = graph, 4
    bt = BandedTables.build(g, band_size=BAND, two_d=two_d, device=CPU)
    sb, db, src, pos, negs = _grouped(bt, _gen(4), 64, G, 8, 50, per_step)
    assert src.shape == pos.shape == (50, 64) and negs.shape == (50, 8)
    assert all(t.dtype == torch.int32 for t in (sb, db, src, pos, negs))
    assert torch.equal(src, src[:, ::G].repeat_interleave(G, dim=1))
    assert bool(((pos >= db[:, None]) & (pos < db[:, None] + BAND)).all())
    if two_d:
        assert bool(((src >= sb[:, None])
                     & (src < sb[:, None] + BAND)).all())
    else:
        assert int(sb.abs().max()) == 0
    esrc = np.repeat(np.arange(g.n_vertices), np.diff(g.indptr))
    edges = set(zip(esrc.tolist(), g.indices.tolist()))
    assert all(p in edges for p in zip(src.numpy().ravel().tolist(),
                                       pos.numpy().ravel().tolist()))


@pytest.mark.parametrize("two_d", [True, False])
def test_grouped_stratum_frequencies_match_mass(graph, two_d):
    g = graph
    bt = BandedTables.build(g, band_size=BAND, two_d=two_d, device=CPU)
    nb = bt.n_bands
    src, dst, jw = _joint_law(g)
    strat = (src // BAND) * nb + dst // BAND if two_d else dst // BAND
    ns = nb * nb if two_d else nb
    strat_p = np.zeros(ns)
    np.add.at(strat_p, strat, jw)
    steps = 6000
    sb, db, *_ = bt.draw_banded_batches_hoisted(_gen(5), 16, 4, 8, steps)
    emp = np.bincount(_strata(bt, sb, db), minlength=ns) / steps
    sd = np.sqrt(strat_p * (1 - strat_p) / steps)
    assert (np.abs(emp - strat_p) < 4 * sd + 1e-12).all()


def _tv_bound(want, n):
    """Twice the total variation distance that n iid draws from ``want``
    show on average (0.5 * sum sqrt(2 p (1 - p) / (pi n))), plus 0.01."""
    p = want / want.sum()
    return 2 * 0.5 * np.sqrt(2 * p * (1 - p) / (np.pi * n)).sum() + 0.01


@pytest.mark.parametrize("two_d", [True, False])
def test_grouped_pair_laws_in_a_stratum(graph, two_d):
    """In the most drawn stratum: the first pair of each group follows the
    stratum's joint edge law, and the group's other contexts follow the
    source's within-(src, stratum) context law (weight^0.75)."""
    g, G = graph, 4
    bt = BandedTables.build(g, band_size=BAND, two_d=two_d, device=CPU)
    nb, n = bt.n_bands, g.n_vertices
    esrc, edst, jw = _joint_law(g)
    estrat = (esrc // BAND) * nb + edst // BAND if two_d else edst // BAND
    sb, db, src, pos, _ = bt.draw_banded_batches_hoisted(
        _gen(6), 2048, G, 8, 1200)
    s = _strata(bt, sb, db)
    top = int(np.bincount(s).argmax())
    rows = s == top
    sel = estrat == top

    first_s = src[:, ::G].numpy()[rows].ravel()
    first_p = pos[:, ::G].numpy()[rows].ravel()
    emp = np.bincount(first_s * n + first_p, minlength=n * n).astype(float)
    want = np.zeros(n * n)
    np.add.at(want, esrc[sel] * n + edst[sel], jw[sel])
    tv = 0.5 * np.abs(emp / emp.sum() - want / want.sum()).sum()
    assert tv < _tv_bound(want, emp.sum()), f"first-pair TV {tv:.4f}"

    extra = np.ones(src.shape[1], bool)
    extra[::G] = False
    xs = src.numpy()[rows][:, extra].ravel()
    xp = pos.numpy()[rows][:, extra].ravel()
    emp = np.bincount(xs * n + xp, minlength=n * n).astype(float)
    # want: the drawn sources' marginal times their context law in-stratum
    w = np.asarray(g.weights, np.float64)[sel] ** 0.75
    z = np.zeros(n)
    np.add.at(z, esrc[sel], w)
    src_marg = np.bincount(xs, minlength=n) / len(xs)
    want = np.zeros(n * n)
    np.add.at(want, esrc[sel] * n + edst[sel],
              src_marg[esrc[sel]] * w / z[esrc[sel]])
    tv = 0.5 * np.abs(emp / emp.sum() - want / want.sum()).sum()
    assert tv < _tv_bound(want, emp.sum()), f"extra-context TV {tv:.4f}"


# ----------------------------------------------------- held-block draws
@pytest.mark.parametrize("group", [1, 4])
def test_banded_block_draw_law(graph, group):
    """tests/test_banded.py's block-draw law: one stratum per block, the
    stratum marginal, in-band rows, and the pair law inside the most drawn
    stratum (every pair of a group, the extra contexts included, follows
    the stratum's joint edge law)."""
    g = graph
    bt = BandedTables.build(g, band_size=BAND, two_d=True, device=CPU)
    nb, n = bt.n_bands, g.n_vertices
    esrc, edst, jw = _joint_law(g)
    estrat = (esrc // BAND) * nb + edst // BAND
    strat_p = np.zeros(nb * nb)
    np.add.at(strat_p, estrat, jw)
    B, S, reps = 1024, 4, 150
    gen = _gen(7 + group)
    strat_n = np.zeros(nb * nb)
    counts = {}
    for _ in range(reps):
        sb, db, src, pos, negs = bt.draw_banded_block(gen, B, group, 8, S)
        assert sb.shape == db.shape == () and sb.dtype == torch.int32
        assert src.shape == pos.shape == (S, B) and negs.shape == (S, 8)
        assert torch.equal(src, src[:, ::group].repeat_interleave(group, 1))
        src, pos = src.numpy(), pos.numpy()
        s = (int(sb) // BAND) * nb + int(db) // BAND
        strat_n[s] += 1
        assert ((pos >= int(db)) & (pos < int(db) + BAND)).all()
        assert ((src >= int(sb)) & (src < int(sb) + BAND)).all()
        counts.setdefault(s, np.zeros(n * n))
        np.add.at(counts[s], src.ravel() * n + pos.ravel(), 1.0)
    sd = np.sqrt(strat_p * (1 - strat_p) / reps)
    assert (np.abs(strat_n / reps - strat_p) < 4 * sd + 1e-12).all()
    top = int(strat_n.argmax())
    want = np.zeros(n * n)
    sel = estrat == top
    np.add.at(want, esrc[sel] * n + edst[sel], jw[sel])
    emp = counts[top]
    tv = 0.5 * np.abs(emp / emp.sum() - want / want.sum()).sum()
    assert tv < 0.05, f"pair TV {tv:.4f} in stratum {top}"


# ---------------------------------------------------- banded negatives
NB2 = 16


def _neg_tables(g):
    return BandedTables.build(g, band_size=BAND, two_d=True,
                              device=CPU).build_neg_bands(g, nb2=NB2)


def _neg_mass(g, n_pad):
    p = np.zeros(n_pad)
    p[:g.n_vertices] = (g.out_degree + g.in_degree) ** 0.75
    return p / p.sum()


def test_neg_window_frequencies_match_mass(graph):
    g = graph
    bt = _neg_tables(g)
    steps = 20000
    nb, negs_l = bt.draw_neg_banded(_gen(8), 4, steps)
    assert nb.shape == (steps,) and negs_l.shape == (steps, 4)
    assert nb.dtype == negs_l.dtype == torch.int32
    assert int(negs_l.min()) >= 0 and int(negs_l.max()) < NB2
    win_p = _neg_mass(g, bt.n_rows_padded).reshape(-1, NB2).sum(1)
    emp = np.bincount(nb.numpy(), minlength=len(win_p)) / steps
    sd = np.sqrt(win_p * (1 - win_p) / steps)
    assert (np.abs(emp - win_p) < 4 * sd + 1e-12).all()
    assert emp[win_p == 0].sum() == 0  # padded windows are never drawn


def test_neg_window_conditional_follows_degree_law(graph):
    """Within the most drawn window, chi-squared of the window-local rows
    against deg^0.75 restricted to the window (bound: the statistic's mean
    plus 5 standard deviations); and, one negative per step so that the
    draws are iid, the lifted global rows against the global law, which
    the window law telescopes to."""
    g = graph
    bt = _neg_tables(g)
    nb, negs_l = bt.draw_neg_banded(_gen(9), 64, 4000)
    nb, negs_l = nb.numpy(), negs_l.numpy()
    p = _neg_mass(g, bt.n_rows_padded)
    top = int(np.bincount(nb).argmax())
    counts = np.bincount(negs_l[nb == top].ravel(), minlength=NB2)
    q = p[top * NB2:(top + 1) * NB2]
    q = q / q.sum()
    live = q > 0
    assert counts[~live].sum() == 0
    exp = q[live] * counts.sum()
    chi2 = ((counts[live] - exp) ** 2 / exp).sum()
    dof = int(live.sum()) - 1
    assert chi2 < dof + 5 * np.sqrt(2 * dof), chi2

    nb, negs_l = bt.draw_neg_banded(_gen(10), 1, 40000)
    rows = (nb[:, None] * NB2 + negs_l).numpy().ravel()
    counts = np.bincount(rows, minlength=g.n_vertices)[:g.n_vertices]
    exp = p[:g.n_vertices] * counts.sum()
    chi2 = ((counts - exp) ** 2 / exp).sum()
    dof = g.n_vertices - 1
    assert chi2 < dof + 5 * np.sqrt(2 * dof), chi2


def test_stream_draw_without_negatives(graph):
    """with_negs=False returns negs None and the same pairs and strata as
    the draw with negatives from the same generator state."""
    bt = _tables(graph, True)
    a = bt.draw_banded_stream(_gen(11), 64, 16, 8)
    b = bt.draw_banded_stream(_gen(11), 64, 16, 8, with_negs=False)
    assert a[4].shape == (8, 16) and b[4] is None
    for x, y in zip(a[:4], b[:4]):
        assert torch.equal(x, y)
    sb, db, src_l, pos_l, negs = multiblock_draw(bt, _gen(11), 64, 0, 8)
    assert negs is None and torch.equal(src_l, a[2])
