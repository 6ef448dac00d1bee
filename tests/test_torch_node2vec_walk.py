"""node2vec's second-order walk and step in the port against the plain
reference (tests/node2vec_reference.py: a per-walk loop that scans the
neighbour lists, and the SGNS formulas), on seeded random uniforms and
tables on the CPU; the benchmark's byte count of the walk on a graph worked
by hand; the benchmark's frozen copy of the reference."""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

import node2vec_reference as reference
from smore_tpu_torch.graph.graph import Graph
from smore_tpu_torch.models.node2vec import Node2Vec
from smore_tpu_torch.ops import node2vec_walk as n2v_kernel
from smore_tpu_torch.sampling import walks as W
from smore_tpu_torch.sampling.tables import SamplerTables
from torch_walk_inputs import dead_end_graph, node2vec_inputs

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def dead_end():
    """A weighted directed graph with dead ends (every fifth vertex and the
    last one have no out-edge), its tables, neighbour index and the
    reference's neighbour lists from the same edges."""
    src, dst, w, names, name2id = dead_end_graph(400)
    g = Graph.from_arrays(src, dst, w, names, name2id)
    t = SamplerTables.build(g, device=CPU)
    row = np.repeat(np.arange(g.n_vertices), np.diff(g.indptr))
    indptr, nbrs = reference.adjacency(row, g.indices, g.n_vertices)
    return g, t, W.NeighborIndex.build(g, CPU), indptr, nbrs


def _inputs(t, B, steps, trials, seed):
    return tuple(torch.from_numpy(a) for a in node2vec_inputs(
        t.n_vertices, B, steps, trials, seed))


def _reference_walks(t, indptr, nbrs, starts, steps, u_first, u, p, q,
                     trials):
    return reference.walks(starts.numpy(), steps, u_first.numpy(),
                           u.numpy(), t.vert_meta.numpy(),
                           t.ctx_pa.numpy(), indptr, nbrs, p, q, trials)


@pytest.mark.parametrize("p,q", [(1.0, 1.0), (0.5, 2.0), (4.0, 0.25)])
@pytest.mark.parametrize("trials", [1, 2, 3, 4])
@pytest.mark.parametrize("steps", [1, 2, 7, 40])
def test_twin_equals_the_reference(dead_end, p, q, trials, steps):
    """The twin's walks are the reference's entry for entry, given the same
    uniforms: dead starts, dead ends mid-walk, index uniforms at the float
    below 1."""
    _, t, nbr, indptr, nbrs = dead_end
    B = 48
    starts, u_first, u = _inputs(t, B, steps, trials, 7 * steps + trials)
    got, mask = W.node2vec_walk_ref(t, nbr, starts, steps, p, q, trials,
                                    u_first, u)
    want = _reference_walks(t, indptr, nbrs, starts, steps, u_first, u, p,
                            q, trials)
    assert torch.equal(got.long(), want)
    live = t.vert_meta[starts.long(), 1] > 0
    assert torch.equal(mask, live.to(torch.float32))
    # the inputs reach what they are there for
    assert not live.all() and live.any()
    if steps >= 7:  # a live walk reached a dead end and restarted
        dead = t.vert_meta[got.long(), 1] == 0
        assert bool(dead[:, 1:-1][live].any())


@pytest.mark.parametrize("p,q", [(0.5, 2.0), (4.0, 0.25)])
def test_the_walk_launches_nothing_on_the_cpu(dead_end, p, q):
    """``node2vec_walk`` on CPU tensors is the twin on the uniforms it
    draws from the generator, the first step's first, and launches no
    kernel."""
    _, t, nbr, _, _ = dead_end
    B, steps, trials = 32, 10, 4
    starts = torch.arange(B, dtype=torch.int32)
    launches = n2v_kernel.KERNEL.launches
    got = W.node2vec_walk(t, nbr, torch.Generator().manual_seed(3), starts,
                          steps, p, q, trials)
    gen = torch.Generator().manual_seed(3)
    u_first = torch.rand((B, 2), generator=gen)
    u = torch.rand((steps - 1, B, trials, 3), generator=gen)
    want = W.node2vec_walk_ref(t, nbr, starts, steps, p, q, trials, u_first,
                               u)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert n2v_kernel.KERNEL.launches == launches


def test_the_walk_has_no_fallback_off_the_cpu(dead_end):
    _, t, nbr, _, _ = dead_end
    starts = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        W.node2vec_walk(t, nbr, None, starts, 5)
    s, uf, u = _inputs(t, 4, 5, 4, 0)
    with pytest.raises(ValueError, match="no kernel"):
        n2v_kernel.node2vec_walk(s, uf, u, t.vert_meta, t.ctx_pa, nbr.indptr,
                                 nbr.sorted_nbrs, 5, 0.5, 2.0, 4)


@pytest.mark.parametrize("bad", ["starts", "u", "u_first", "trials",
                                 "index"])
def test_the_walk_rejects_what_the_kernel_does_not_take(dead_end, bad):
    _, t, nbr, _, _ = dead_end
    starts, u_first, u = _inputs(t, 8, 5, 4, 1)
    kw = dict(u_first=u_first, u=u)
    trials = 4
    if bad == "starts":
        starts = starts.long()
    elif bad == "u":
        kw["u"] = u[:, :, :3]
    elif bad == "u_first":
        kw["u_first"] = u_first.double()
    elif bad == "trials":
        trials = 0
        kw["u"] = u[:, :, :0]
    else:
        nbr = W.NeighborIndex(nbr.indptr[:-1], nbr.sorted_nbrs, nbr.n_iters)
    with pytest.raises(ValueError):
        W.node2vec_walk(t, nbr, None, starts, 5, 0.5, 2.0, trials, **kw)


# ------------------------------------------------- the kernel's instances #
def _kernel_source():
    with open(os.path.join(ROOT, "smore_tpu_torch", "csrc",
                           "node2vec_walk.cu")) as f:
        return f.read()


def test_lanes_for_picks_only_instances_the_kernel_has():
    """``LANES`` are the instances the kernel's launch dispatches to and its
    graph count reads, and ``lanes_for`` returns nothing else, from one walk
    to past the crossover, on cards of 1 to 144 SMs."""
    src = _kernel_source()
    extern = src.split('extern "C"', 1)[1]
    cases = re.findall(r"case (\d+):\s*return \(int\)launch<(\d+)>", extern)
    assert [int(a) for a, b in cases] == [int(b) for a, b in cases]
    assert tuple(int(a) for a, _ in cases) == n2v_kernel.LANES
    counted = re.findall(r"node2vec_walk_steps<(\d+)>", extern)
    assert tuple(int(n) for n in counted) == n2v_kernel.LANES
    for sms in (1, 66, 114, 132, 144):
        top = 2 * n2v_kernel.WARP_WALKS_PER_SM * sms
        seen = {n2v_kernel.lanes_for(B, sms) for B in range(1, top, 7)}
        assert seen == set(n2v_kernel.LANES), sms


@pytest.mark.parametrize("sms", [1, 66, 132])
def test_lanes_for_narrows_as_the_batch_grows(sms):
    """Monotone in B: a larger batch never takes more lanes a walk."""
    top = 3 * n2v_kernel.WARP_WALKS_PER_SM * sms
    lanes = [n2v_kernel.lanes_for(B, sms) for B in range(1, top)]
    assert all(a >= b for a, b in zip(lanes, lanes[1:]))
    assert lanes[0] == max(n2v_kernel.LANES)
    assert lanes[-1] == 1


def test_lanes_for_at_the_cells_shapes_on_an_h100():
    """On an H100 (132 SMs): a warp a walk at ``node2vec.youtube``'s 128
    walks a launch, one thread a walk at ``node2vec.flickr``'s 80,640 (an
    epoch's hoisted starts)."""
    assert n2v_kernel.lanes_for(128, 132) == 32
    assert n2v_kernel.lanes_for(80640, 132) == 1


def test_the_launch_signature_is_unchanged():
    """The one launcher, ``node2vec_walk_launch_lanes``, takes the device
    index, the lane count, then the walk's arguments as before, as its
    registered ``Kernel`` passes them."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    assert n2v_kernel.KERNEL.symbol == "node2vec_walk_launch_lanes"
    assert n2v_kernel.KERNEL.argtypes == (
        [I, I] + [P] * 9 + [I] * 4 + [F] * 3 + [P])
    extern = _kernel_source().split('extern "C"', 1)[1]
    m = re.search(r"\bint\s+node2vec_walk_launch_lanes\s*\(([^)]*)\)",
                  extern)
    kinds = []
    for param in m.group(1).split(","):
        param = " ".join(param.split())
        kinds.append(P if "*" in param else
                     F if re.match(r"(const )?float\b", param) else
                     I if re.match(r"(const )?int\b", param) else param)
    assert kinds == n2v_kernel.KERNEL.argtypes
    assert re.findall(r"\bint\s+(\w+_launch\w*)\s*\(", extern) == [
        "node2vec_walk_launch_lanes"]


def test_the_class_law_sums_to_one_and_keeps_the_first_order_law():
    for back, near in [(0.2, 0.3), (0.0, 0.9), (1.0, 0.0), (0.05, 0.0)]:
        for p, q in [(0.5, 2.0), (4.0, 0.25)]:
            assert sum(reference.class_law(back, near, p, q, 4)) == \
                pytest.approx(1.0)
        law = reference.class_law(back, near, 1.0, 1.0, 4)
        assert law == pytest.approx((back, near, 1.0 - back - near))
    # one trial: the first-order law whatever p and q
    assert reference.class_law(0.2, 0.3, 0.5, 2.0, 1) == pytest.approx(
        (0.2, 0.3, 0.5))


# ------------------------------------------------------- a training step #
def test_a_step_equals_the_reference_step():
    """One node2vec step of the model (``WalkSGNSBase._make_step``: starts,
    walks, skip-gram pairs, the shared negatives, the masked update) on
    random tables against the reference's step on the same draws, which
    are taken from a copy of the step's generator in the step's order.
    Tolerance: the same float32 products and sums, but the port sums a
    dense masked pair grid by ``index_add_`` and the reference the list of
    valid pairs in another order, so the changes differ by round-off: a
    few ulps of the largest change (rtol 1e-5 of it)."""
    src, dst, w, names, name2id = dead_end_graph(300)
    g = Graph.from_arrays(src, dst, w, names, name2id)
    m = Node2Vec(g, seed=0, p=0.5, q=2.0, device=CPU)
    m.init(dim=16)
    gen = torch.Generator().manual_seed(5)
    m.state["vertex"] = torch.randn(g.n_vertices, 16, generator=gen) * 0.3
    m.state["context"] = torch.randn(g.n_vertices, 16, generator=gen) * 0.3
    B, negs_n, steps, window, trials = 24, 32, 12, 3, 4
    m.walk_steps, m.window_size = steps, window
    ctx = m._make_ctx()
    t = ctx[0]
    step = m._make_step(B, 5, negs_n, "sum")
    before = {k: v.clone() for k, v in m.state.items()}
    alpha = 0.025
    out, _ = step({k: v.clone() for k, v in m.state.items()}, ctx,
                  torch.Generator().manual_seed(11), torch.tensor(alpha))

    draw = torch.Generator().manual_seed(11)
    starts = torch.randint(0, g.n_vertices, (B,), generator=draw,
                           dtype=torch.int32)
    u_first = torch.rand((B, 2), generator=draw)
    u = torch.rand((steps - 1, B, trials, 3), generator=draw)
    reduce = torch.randint(1, window + 1, (B, steps + 1), generator=draw)
    un = torch.rand((negs_n, 2), generator=draw)
    # the negatives by the negative alias table, drawn as its slots read
    n = t.neg_pa.shape[0]
    slot = torch.clamp((un[:, 0] * n).to(torch.int64), max=n - 1)
    row = t.neg_pa[slot]
    negs = torch.where(un[:, 1] < row[:, 0], slot, row[:, 1].long())

    row_of = np.repeat(np.arange(g.n_vertices), np.diff(g.indptr))
    indptr, nbrs = reference.adjacency(row_of, g.indices, g.n_vertices)
    wv, wc = before["vertex"].clone(), before["context"].clone()
    reference.train_step(wv, wc, starts, steps, u_first.numpy(), u.numpy(),
                         reduce, negs, alpha, t.vert_meta.numpy(),
                         t.ctx_pa.numpy(), indptr, nbrs, 0.5, 2.0, trials, 5)
    for k, want in (("vertex", wv), ("context", wc)):
        d_ref = want - before[k]
        d_got = out[k] - before[k]
        scale = float(d_ref.abs().max())
        assert scale > 1e-4  # the step moved the table
        assert float((d_got - d_ref).abs().max()) <= 1e-5 * scale, k


# ------------------------------------------------------- the benchmark #
def _family():
    from perfbench.harness import spec

    return spec.family("node2vec", ROOT)


def test_the_byte_count_on_a_graph_worked_by_hand():
    """The triangle a, b, c with a tail c - d (undirected, unit weights;
    vertex ids a 0, b 1, c 2, d 3), one walk of 2 steps from a at p 2,
    q 4 (max_bias 1: a step to a neighbour of prev is accepted, a return
    with probability 1/2, a far step 1/4). Worked by hand: the first draw
    goes to b; the second step's trials draw a (the return, rejected at
    0.6), then c (a neighbour of a: accepted). The bytes: starts 4, the
    walk 3 x 4, its row mask 4, the first step's uniforms 8, two trials'
    24; sectors: vert_meta rows of a and b (one sector: rows 0-3 share
    32 B), the alias rows of a's slot 0 and of b's slots 2 and 3 (16 B
    each: sectors 0 and 1), a's indptr pair (sector 0) and a's sorted list
    (slots 0-1, sector 0) for the one search (trial 1 drew prev itself: no
    search)."""
    fam = _family()
    edges = [("a", "b", 1.0), ("b", "c", 1.0), ("a", "c", 1.0),
             ("c", "d", 1.0)]
    g = Graph.from_edges(edges, undirected=True)
    t = SamplerTables.build(g, device=CPU)
    assert t.vert_meta.tolist() == [[0, 2], [2, 2], [4, 3], [7, 1]]
    assert sorted(t.ctx_pa[2:4, 1].tolist()) == [0.0, 2.0]  # b: a, c
    # index uniforms: a's slot 0 (b); then b's slot 2 (a), slot 3 (c)
    walk_of = {int(t.ctx_pa[s, 1]): s for s in (2, 3)}
    u_first = torch.tensor([[0.0, 0.0]])
    u = torch.zeros((1, 1, 4, 3))
    u[0, 0, 0] = torch.tensor([(walk_of[0] - 2) * 0.5 + 0.1, 0.0, 0.6])
    u[0, 0, 1] = torch.tensor([(walk_of[2] - 2) * 0.5 + 0.1, 0.0, 0.6])
    starts = torch.tensor([0], dtype=torch.int32)
    nbr = W.NeighborIndex.build(g, CPU)
    walk, _ = W.node2vec_walk(t, nbr, None, starts, 2, 2.0, 4.0, 4,
                              u_first=u_first, u=u)
    assert walk.tolist() == [[0, 1, 2]]
    draws = [{"starts": starts, "u_first": u_first, "u": u}]
    got = fam.launch_bytes_of(draws, [walk], t.vert_meta, t.ctx_pa, 2.0, 4.0,
                              4)
    assert got == 4 + 3 * 4 + 4 + 8 + 2 * 12 + 32 * (1 + 2 + 1 + 1)
    # the same walk twice in one launch reads no sector more
    two = [{"starts": starts.repeat(2), "u_first": u_first.repeat(2, 1),
            "u": u.repeat(1, 2, 1, 1)}]
    got2 = fam.launch_bytes_of(two, [walk.repeat(2, 1)], t.vert_meta,
                               t.ctx_pa, 2.0, 4.0, 4)
    assert got2 == 2 * (4 + 3 * 4 + 4 + 8 + 2 * 12) + 32 * 5
    # two launches of it: the mean of a launch
    got3 = fam.launch_bytes_of(draws * 2, [walk] * 2, t.vert_meta, t.ctx_pa,
                               2.0, 4.0, 4)
    assert got3 == got


def test_the_benchmarks_reference_is_this_reference():
    """perfbench/reference/node2vec.py is a frozen copy of this file."""
    with open(os.path.join(ROOT, "tests", "node2vec_reference.py")) as f:
        ours = f.read()
    with open(os.path.join(ROOT, "perfbench", "reference",
                           "node2vec.py")) as f:
        assert f.read() == ours
