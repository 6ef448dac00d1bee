"""The port's walk generators and pair mappers against smore_tpu's.

The JAX functions draw their uniforms from a key; the same uniforms, drawn
here from that key in the JAX function's own shapes, go to the port's
function through its ``u`` / ``u_first`` / ``u_stop`` / ``reduce``
arguments. Given them, walks, neighbour lookups and pairs are bit-equal.
The one exception is APP's geometric stop index, floor(log(u) / log(1 -
jump)): torch's and XLA's float32 logarithms may round a quotient that
lies next to an integer to either side, so rows whose quotient is within
1e-4 of an integer are left out of that comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smore_tpu.graph.graph import Graph as JGraph
from smore_tpu.sampling import mappers as JM
from smore_tpu.sampling import walks as JW
from smore_tpu.sampling.tables import SamplerTables as JTables
from smore_tpu_torch.graph.graph import Graph as TGraph
from smore_tpu_torch.ops import random_walk as walk_kernel
from smore_tpu_torch.sampling import mappers as TM
from smore_tpu_torch.sampling import walks as TW
from smore_tpu_torch.sampling.tables import SamplerTables as TTables
from torch_walk_inputs import dead_end_graph, walk_inputs

# one intra-op thread: test workers share the cores, and a thread pool
# in each of them oversubscribes the CPU on these tiny shapes
torch.set_num_threads(1)

CPU = torch.device("cpu")  # the port defaults to the card


def _ring_edges():
    """tests/test_walks.py's directed ring 0->...->9->0 plus a dead end
    (0->10)."""
    edges = [(f"v{i}", f"v{(i + 1) % 10}", 1.0) for i in range(10)]
    edges.append(("v0", "v10", 1.0))
    return edges, False


def _comm_edges():
    """tests/test_walk_models.py's two 12-vertex communities and a bridge,
    with integer weights so that the alias tables are not uniform."""
    rng = np.random.default_rng(7)
    edges = []
    for base in (0, 12):
        for i in range(12):
            for j in range(i + 1, 12):
                if rng.random() < 0.6:
                    edges.append((f"v{base + i}", f"v{base + j}",
                                  float(rng.integers(1, 4))))
    edges.append(("v0", "v12", 1.0))
    return edges, True


def _star_edges():
    """tests/test_walks.py's star: centre c and four leaves, undirected."""
    return [("c", f"l{i}", 1.0) for i in range(4)], True


def _dead_end_edges():
    """A weighted directed graph where a fifth of the vertices have no
    out-edge: walks restart (random_walk) or stop (jumping walks)."""
    rng = np.random.default_rng(3)
    edges = []
    for _ in range(300):
        a, b = rng.integers(0, 60, 2)
        if a != b and a % 5:
            edges.append((f"v{a}", f"v{b}", float(rng.uniform(0.5, 3.0))))
    return edges, False


GRAPHS = {"ring": _ring_edges, "comm": _comm_edges, "star": _star_edges,
          "dead_end": _dead_end_edges}


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def both(request):
    edges, undirected = GRAPHS[request.param]()
    jg = JGraph.from_edges(edges, undirected=undirected)
    tg = TGraph.from_edges(edges, undirected=undirected)
    return (jg, JTables.build(jg), tg,
            TTables.build(tg, device=CPU))


def _starts(n, B, seed):
    return np.random.default_rng(seed).integers(0, n, B).astype(np.int32)


def _u(key, shape):
    return torch.from_numpy(np.array(jax.random.uniform(key, shape)))


@pytest.mark.parametrize("restart", [True, False])
def test_random_walk_bit_equal(both, restart):
    jg, jt, tg, tt = both
    B, steps = 64, 12
    starts = _starts(jg.n_vertices, B, 0)
    key = jax.random.PRNGKey(5)
    jw, jm = JW.random_walk(jt, key, jnp.asarray(starts), steps,
                            restart_on_deadend=restart)
    tw, tm = TW.random_walk(tt, None, torch.from_numpy(starts), steps,
                            restart_on_deadend=restart,
                            u=_u(key, (steps, B, 2)))
    assert tw.dtype == torch.int32 and tw.shape == (B, steps + 1)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_random_walk_draws_its_own_uniforms(both):
    """Without ``u`` the walk draws from the generator: the same generator
    state gives the same walk, and the walk follows edges."""
    _, _, tg, tt = both
    starts = torch.from_numpy(_starts(tg.n_vertices, 32, 1))
    walks = [TW.random_walk(tt, torch.Generator().manual_seed(3), starts,
                            8)[0] for _ in range(2)]
    assert torch.equal(walks[0], walks[1])
    w = walks[0].numpy()
    for b in range(w.shape[0]):
        for t in range(8):
            a, c = w[b, t], w[b, t + 1]
            if tg.branch(a):
                assert c in tg.neighbors(a)
            else:  # dead end: restart from the start, or a dead start
                assert c in tg.neighbors(w[b, 0]) or c == w[b, 0]


@pytest.mark.parametrize("restart", [True, False])
def test_random_walk_on_the_cpu_is_its_twin(both, restart):
    """On CPU tensors ``random_walk`` is ``random_walk_ref`` on the uniforms
    that one draw of the generator gives, and launches no kernel."""
    _, _, tg, tt = both
    B, steps = 48, 9
    starts = torch.from_numpy(_starts(tg.n_vertices, B, 4))
    launches = walk_kernel.KERNEL.launches
    got = TW.random_walk(tt, torch.Generator().manual_seed(11), starts,
                         steps, restart_on_deadend=restart)
    u = torch.rand((steps, B, 2), generator=torch.Generator().manual_seed(11))
    want = TW.random_walk_ref(tt, starts, steps, u, restart)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert walk_kernel.KERNEL.launches == launches


@pytest.fixture(scope="module")
def dead_end_tables():
    arrays = dead_end_graph()
    return (JTables.build(JGraph.from_arrays(*arrays)),
            TTables.build(TGraph.from_arrays(*arrays), device=CPU))


@pytest.mark.parametrize("restart", [True, False])
def test_random_walk_bit_equal_on_the_kernel_tests_inputs(
        dead_end_tables, monkeypatch, restart):
    """The JAX package's random_walk and the port's, on the graph and the
    uniforms that the card tests feed the kernel: dead starts, a dead
    vertex whose indptr is E, u0 at the float just below 1. JAX's walk
    draws its uniforms inside; the draw is made to return these."""
    jt, tt = dead_end_tables
    n = tt.n_vertices
    assert tt.vert_meta[n - 1].tolist() == [tt.n_edges, 0]
    B, steps = 640, 40
    starts, u = walk_inputs(n, B, steps, seed=7)

    def uniform(key, shape):
        assert tuple(shape) == u.shape
        return jnp.asarray(u)

    monkeypatch.setattr(JW.jax.random, "uniform", uniform)
    jw, jm = JW.random_walk(jt, jax.random.PRNGKey(0), jnp.asarray(starts),
                            steps, restart_on_deadend=restart)
    tw, tm = TW.random_walk(tt, None, torch.from_numpy(starts), steps,
                            restart_on_deadend=restart,
                            u=torch.from_numpy(u))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert (np.asarray(jm) == 0).any()


def _walk_args(device):
    tables = TTables.build(TGraph.from_edges(*_ring_edges()), device=CPU)
    tables = TTables(*(t.to(device) for t in (
        tables.vertex_pa, tables.neg_pa, tables.vert_meta, tables.ctx_pa,
        tables.edge_pa)))
    starts = torch.zeros(8, dtype=torch.int32, device=device)
    return tables, starts, torch.zeros(5, 8, 2, device=device)


def test_random_walk_has_no_fallback_off_cpu():
    """A device that is neither the CPU nor a CUDA card gets an error, never
    the twin, and before the generator is drawn from."""
    tables, starts, u = _walk_args("meta")
    with pytest.raises(ValueError, match="no kernel"):
        TW.random_walk(tables, None, starts, 5, u=u)
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    with pytest.raises(ValueError, match="no kernel"):
        TW.random_walk(tables, gen, starts, 5)
    assert torch.equal(gen.get_state(), state)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_walk_kernel_wrapper_launches_only_on_the_card(device):
    """``ops/random_walk.random_walk`` is the launch alone: off a CUDA card
    it raises and counts nothing (``sampling/walks`` runs the twin)."""
    tables, starts, u = _walk_args(device)
    launches = walk_kernel.KERNEL.launches
    with pytest.raises(ValueError, match="no kernel"):
        walk_kernel.random_walk(starts, u, tables.vert_meta, tables.ctx_pa)
    assert walk_kernel.KERNEL.launches == launches


@pytest.mark.parametrize("bad", ["starts_int64", "starts_2d", "u_shape",
                                 "u_float64"])
def test_random_walk_rejects_what_the_kernel_does_not_take(bad):
    """The kernel's contract holds on the CPU too, so a caller that breaks
    it fails in the CPU tests and not first on the card."""
    tables, starts, u = _walk_args(CPU)
    if bad == "starts_int64":
        starts = starts.long()
    elif bad == "starts_2d":
        starts, u = starts.reshape(2, 4), u.reshape(5, 2, 4, 2)
    elif bad == "u_shape":
        u = u[:, :4]
    else:
        u = u.double()
    with pytest.raises(ValueError):
        TW.random_walk(tables, None, starts, 5, u=u)


@pytest.mark.parametrize("jump", [0.15, 0.5])
def test_jumping_walk_endpoints_equal_off_integer_quotients(both, jump):
    jg, jt, tg, tt = both
    B, max_steps = 512, 16
    starts = _starts(jg.n_vertices, B, 2)
    key = jax.random.PRNGKey(9)
    je, jm = JW.jumping_walk_endpoints(jt, key, jnp.asarray(starts), jump,
                                       max_steps)
    k_w, k_g = jax.random.split(key)
    u_stop = np.array(jax.random.uniform(k_g, (B,)))
    te, tm = TW.jumping_walk_endpoints(
        tt, None, torch.from_numpy(starts), jump, max_steps,
        u=_u(k_w, (max_steps, B, 2)), u_stop=torch.from_numpy(u_stop))
    q = (np.log(np.clip(u_stop.astype(np.float64), 1e-12, 1.0))
         / np.log(1.0 - jump))
    off = np.abs(q - np.round(q)) > 1e-4
    assert off.mean() > 0.99
    np.testing.assert_array_equal(te.numpy()[off], np.asarray(je)[off])
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_neighbor_index_contains_bit_equal(both):
    jg, _, tg, _ = both
    jn, tn = JW.NeighborIndex.build(jg), TW.NeighborIndex.build(tg, CPU)
    assert tn.n_iters == jn.n_iters
    np.testing.assert_array_equal(tn.indptr.numpy(), np.asarray(jn.indptr))
    np.testing.assert_array_equal(tn.sorted_nbrs.numpy(),
                                  np.asarray(jn.sorted_nbrs))
    n = tg.n_vertices
    a = np.repeat(np.arange(n, dtype=np.int32), n)
    b = np.tile(np.arange(n, dtype=np.int32), n)
    got = tn.contains(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jn.contains(jnp.asarray(a), jnp.asarray(b))))
    truth = np.array([y in set(tg.neighbors(x)) for x, y in zip(a, b)])
    np.testing.assert_array_equal(got, truth)


@pytest.mark.parametrize("p,q", [(1.0, 1.0), (0.5, 2.0)])
@pytest.mark.parametrize("steps", [1, 10])
def test_node2vec_walk_bit_equal(both, p, q, steps):
    jg, jt, tg, tt = both
    B, trials = 64, 4
    starts = _starts(jg.n_vertices, B, 4)
    key = jax.random.PRNGKey(11)
    jn, tn = JW.NeighborIndex.build(jg), TW.NeighborIndex.build(tg, CPU)
    jw, jm = JW.node2vec_walk(jt, jn, key, jnp.asarray(starts), steps, p, q,
                              trials)
    tw, tm = TW.node2vec_walk(
        tt, tn, None, torch.from_numpy(starts), steps, p, q, trials,
        u_first=_u(key, (B, 2)),
        u=_u(jax.random.fold_in(key, 1), (max(steps - 1, 0), B, trials, 3)))
    assert tw.shape == (B, steps + 1)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_node2vec_unbiased_is_random_walk_law(both):
    """p = q = 1 accepts every first candidate: the walk is random_walk's
    given the same first-step and index/alias uniforms."""
    _, _, tg, tt = both
    B, steps = 32, 8
    starts = torch.from_numpy(_starts(tg.n_vertices, B, 6))
    g = torch.Generator().manual_seed(0)
    u_first = torch.rand(B, 2, generator=g)
    u = torch.rand(steps - 1, B, 4, 3, generator=g)
    nw, _ = TW.node2vec_walk(tt, TW.NeighborIndex.build(tg, CPU), None,
                             starts, steps, u_first=u_first, u=u)
    rw, _ = TW.random_walk(tt, None, starts, steps,
                           u=torch.cat([u_first[None], u[:, :, 0, 0:2]]))
    assert torch.equal(nw, rw)


# ------------------------------------------------------------- mappers
def _walk(B, L, n, seed):
    return np.random.default_rng(seed).integers(0, n, (B, L)).astype(
        np.int32)


def _row_mask(B, seed):
    m = (np.random.default_rng(seed).random(B) < 0.8).astype(np.float32)
    return jnp.asarray(m), torch.from_numpy(m)


def _eq(got, want):
    for g, w in zip(got, want):
        assert g.dtype == {np.dtype(np.int32): torch.int32,
                           np.dtype(np.float32): torch.float32}[
                               np.asarray(w).dtype]
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("window", [1, 3, 5])
@pytest.mark.parametrize("masked", [False, True])
def test_skipgram_pairs_bit_equal(window, masked):
    B, L = 7, 11
    walk = _walk(B, L, 50, window)
    key = jax.random.PRNGKey(window)
    jr, tr = _row_mask(B, 1) if masked else (None, None)
    want = JM.skipgram_pairs(jnp.asarray(walk), key, window, jr)
    reduce = torch.from_numpy(np.array(
        jax.random.randint(key, (B, L), 1, window + 1)))
    got = TM.skipgram_pairs(torch.from_numpy(walk), None, window, tr,
                            reduce=reduce)
    _eq(got, want)


def test_skipgram_pairs_valid_bit_equal():
    B, L, window = 5, 9, 3
    walk = _walk(B, L, 50, 0)
    valid = (np.random.default_rng(2).random((B, L)) < 0.7).astype(
        np.float32)
    key = jax.random.PRNGKey(4)
    jr, tr = _row_mask(B, 3)
    want = JM.skipgram_pairs(jnp.asarray(walk), key, window, jr,
                             valid=jnp.asarray(valid))
    reduce = torch.from_numpy(np.array(
        jax.random.randint(key, (B, L), 1, window + 1)))
    got = TM.skipgram_pairs(torch.from_numpy(walk), None, window, tr,
                            valid=torch.from_numpy(valid), reduce=reduce)
    _eq(got, want)


@pytest.mark.parametrize("wmin,wmax", [(1, 1), (2, 5), (1, 3)])
@pytest.mark.parametrize("masked", [False, True])
def test_scale_skipgram_pairs_bit_equal(wmin, wmax, masked):
    B, L = 6, 13
    walk = _walk(B, L, 40, wmax)
    jr, tr = _row_mask(B, 5) if masked else (None, None)
    _eq(TM.scale_skipgram_pairs(torch.from_numpy(walk), wmin, wmax, tr),
        JM.scale_skipgram_pairs(jnp.asarray(walk), wmin, wmax, jr))


@pytest.mark.parametrize("masked", [False, True])
def test_ordinal_pairs_bit_equal(masked):
    walk = _walk(5, 8, 30, 9)
    jr, tr = _row_mask(5, 6) if masked else (None, None)
    _eq(TM.ordinal_pairs(torch.from_numpy(walk), tr),
        JM.ordinal_pairs(jnp.asarray(walk), jr))


@pytest.mark.parametrize("window", [1, 2, 4])
def test_cbow_groups_bit_equal(window):
    B, L = 4, 10
    walk = _walk(B, L, 30, window + 10)
    key = jax.random.PRNGKey(window + 20)
    jr, tr = _row_mask(B, 7)
    want = JM.cbow_groups(jnp.asarray(walk), key, window, jr)
    reduce = torch.from_numpy(np.array(
        jax.random.randint(key, (B, L), 1, window + 1)))
    got = TM.cbow_groups(torch.from_numpy(walk), None, window, tr,
                         reduce=reduce)
    _eq(got, want)


def test_mappers_draw_their_own_windows():
    """Without ``reduce`` the window is drawn from the generator: every
    shrunk window lies in 1..window and distance-1 pairs are always on."""
    walk = torch.arange(10, dtype=torch.int32)[None]
    src, ctx, mask = TM.skipgram_pairs(walk, torch.Generator().manual_seed(0),
                                       3)
    on = {(int(a), int(b)) for a, b, m in zip(src, ctx, mask) if m > 0}
    assert all(1 <= abs(a - b) <= 3 for a, b in on)
    assert all((i, i + 1) in on and (i + 1, i) in on for i in range(9))
