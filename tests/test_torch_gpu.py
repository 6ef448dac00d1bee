"""The port's CUDA kernels on the card, against their PyTorch twins, and
the captured calls (CUDA graphs) against eager ones, the mesh modes' on a
one-rank NCCL group included.

Needs a CUDA card and nvcc; skipped elsewhere. This file imports neither JAX
nor smore_tpu, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
"""

import functools
import socket
from collections import defaultdict

import numpy as np
import pytest
import torch

from smore_tpu_torch.graph.graph import Graph
from smore_tpu_torch.models.line import LINE
from smore_tpu_torch.ops.scatter import (
    K2,
    band_scatter_add,
    band_scatter_add_ref,
)
from smore_tpu_torch.ops.sgns import (
    K1,
    sgns_shared_grads,
    sgns_shared_grads_ref,
)
from smore_tpu_torch.ops.sgns_banded import (
    K3,
    K4,
    K5,
    sgns_banded_fused,
    sgns_banded_fused_ref,
    sgns_banded_multiblock,
    sgns_banded_multiblock_nb,
    sgns_banded_multiblock_nb_ref,
    sgns_banded_multiblock_ref,
)
from torch_graph_call_cases import CASES as CAPTURED
from torch_graph_call_cases import (
    LINE_ROUTES,
    MESH_CASES,
    OWN_LOOP,
    OWN_LOOP_CHUNK,
    SEQ,
    build_mesh,
    build_own_loop,
    field_graph,
    optax_adam,
    own_loop_state,
    seq_edges,
    toy_graph,
)
from torch_graph_call_cases import build as build_case
from torch_superstep_inputs import (
    ALL_COLLIDE,
    ALL_COLLIDE_FUSED,
    ALL_COLLIDE_NB,
    fused_inputs,
    multiblock_inputs,
    multiblock_nb_inputs,
)
from torch_walk_inputs import (
    dead_end_graph,
    hub_graph,
    node2vec_inputs,
    walk_inputs,
)

# Atomics sum duplicate rows in an order that changes from run to run, and
# later tiles gather those sums: f32 round-off scale, not bit-equal.
RTOL, ATOL = 1e-4, 1e-5
_ARGS = ("wv", "wc", "sb", "db", "src_l", "pos_l", "cn", "alpha")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, S, B, band, n_bands, Ks, D, idx_hi):
    rng = np.random.default_rng(seed)
    n = band * n_bands
    x = dict(
        wv=(rng.standard_normal((n, D)) * 0.1).astype(np.float32),
        wc=(rng.standard_normal((n, D)) * 0.1).astype(np.float32),
        sb=rng.integers(0, n_bands, S).astype(np.int32),
        db=rng.integers(0, n_bands, S).astype(np.int32),
        src_l=rng.integers(0, idx_hi, (S, B)).astype(np.int32),
        pos_l=rng.integers(0, idx_hi, (S, B)).astype(np.int32),
        cn=(rng.standard_normal((S, Ks, D)) * 0.1).astype(np.float32),
        alpha=np.linspace(0.05, 0.03, S).astype(np.float32),
    )
    x["db"][-1] = x["sb"][-1]  # a step with sb == db
    return x


CASES = {
    "s4_b128_ks16": dict(S=4, B=128, band=64, n_bands=4, Ks=16, D=64,
                         idx_hi=64),
    "s3_b2048_ks128": dict(S=3, B=2048, band=64, n_bands=3, Ks=128, D=64,
                           idx_hi=64),
    "s2_b2048_duplicates": dict(S=2, B=2048, band=64, n_bands=2, Ks=32, D=64,
                                idx_hi=16),
    "d32_ks40": dict(S=2, B=256, band=96, n_bands=3, Ks=40, D=32,
                     idx_hi=96),
    "d128_ks128_big_smem": dict(S=2, B=1024, band=64, n_bands=3, Ks=128,
                                D=128, idx_hi=64),
    # tile 1 gathers exactly the rows tile 0 scattered, and step 1 those of
    # step 0 (the same band pair and rows): a stale read shows here
    "s2_b2048_tile_reuse": dict(S=2, B=2048, band=4096, n_bands=2, Ks=128,
                                D=64, idx_hi=4096, reuse=True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_twin(cuda, case):
    c = dict(CASES[case])
    reuse = c.pop("reuse", False)
    x = _inputs(len(case), **c)
    if reuse:
        for k in ("src_l", "pos_l"):
            x[k][:, 1024:] = x[k][:, :1024]
            x[k][1] = x[k][0]
        x["sb"][1], x["db"][1] = x["sb"][0], x["db"][0]
    a = {k: torch.from_numpy(v.copy()).to(cuda) for k, v in x.items()}
    b = {k: v.clone() for k, v in a.items()}
    before = K4.launches
    kv, kc, kd, kl = sgns_banded_multiblock(*(a[k] for k in _ARGS),
                                            band_size=c["band"])
    assert K4.launches == before + 1
    assert kv is a["wv"] and kc is a["wc"]
    rv, rc, rd, rl = sgns_banded_multiblock_ref(*(b[k] for k in _ARGS),
                                                band_size=c["band"])
    torch.cuda.synchronize()
    for got, want in ((kv, rv), (kc, rc), (kd, rd)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(kl), float(rl), rtol=RTOL)
    assert not np.allclose(kv.cpu().numpy(), x["wv"])


def _link_auc(m, g):
    wv = m.state["vertex"].cpu().numpy()
    assert np.isfinite(wv).all()
    wv = wv / (np.linalg.norm(wv, axis=1, keepdims=True) + 1e-9)
    src = np.repeat(np.arange(g.n_vertices), np.diff(g.indptr))
    pos_s = (wv[src] * wv[g.indices]).sum(1)
    r = np.random.default_rng(0)
    neg_s = (wv[r.integers(0, g.n_vertices, 500)]
             * wv[r.integers(0, g.n_vertices, 500)]).sum(1)
    return (pos_s[:, None] > neg_s[None, :]).mean()


@pytest.mark.gpu
def test_line_trains_through_the_kernel(cuda):
    """On a CUDA device LINE o2 takes the multiblock route by default when
    the shapes fit, launches the kernel and learns the communities."""
    g = toy_graph()
    m = LINE(g, seed=0, device=cuda)
    m.init(dim=64, order=2)
    before = K4.launches
    m.train(banded=True, band_size=64, batch=128, hoist=4, sample_times=0.2,
            steps_per_call=32, verbose=False)
    assert K4.launches > before
    assert _link_auc(m, g) > 0.8


# K1: the twin's matmuls and the kernel sum in other orders, and d_neg's
# atomics in an order that changes from run to run. The kernel's edges: B
# ragged against its 64-row tile (200, 1000, 320), Ks not a multiple of 8
# (37, 13), D = 128 (32-row tiles), D not a multiple of 8 (36)
K1_CASES = [(32768, 128, 64), (1024, 64, 32), (2048, 128, 128),
            (200, 40, 64), (1000, 37, 64), (320, 13, 36)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,Ks,D", K1_CASES)
def test_k1_kernel_matches_twin(cuda, B, Ks, D):
    rng = np.random.default_rng(B + Ks + D)
    v, cp, cn = (torch.from_numpy((rng.standard_normal(s) * 0.3).astype(
        np.float32)).to(cuda) for s in ((B, D), (B, D), (Ks, D)))
    alpha = torch.tensor(0.025, device=cuda)
    before = K1.launches
    got = sgns_shared_grads(v, cp, cn, alpha, k_equiv=5)
    assert K1.launches == before + 1
    want = sgns_shared_grads_ref(v, cp, cn, alpha, k_equiv=5)
    torch.cuda.synchronize()
    for name, x, y in zip(("d_src", "d_pos", "d_neg"), got, want):
        assert x.shape == y.shape and x.dtype == torch.float32, name
        np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    assert float(got[2].abs().max()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("order", [1, 2])
def test_line_unbanded_trains_through_k1(cuda, order):
    """LINE's unbanded route with use_pallas=True launches K1 on a CUDA
    device and learns the communities."""
    g = toy_graph()
    m = LINE(g, seed=0, device=cuda)
    m.init(dim=64, order=order)
    before = K1.launches
    m.train(sample_times=0.2, batch=128, use_pallas=True, verbose=False)
    assert m.banded_tables is None and m.last_driver.micro_steps == 32
    assert K1.launches > before
    assert _link_auc(m, g) > 0.8


# K3: one fused micro-step, (B, band, Ks, D) at the fused route's shapes
# (two tiles at 4096, sixteen at 32768) and a small band with heavy
# duplicates; atomics as in K4. d_neg is summed in phase A's registers up to
# Ks/8 x D/4 = 256 tiles (a ragged Ks=37 among them) and by the kept-rows
# reduction above (D=128)
K3_CASES = [(4096, 16392, 128, 64), (128, 64, 16, 64), (32768, 16392, 128,
                                                         64),
            (2048, 96, 37, 32), (4096, 64, 128, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,band,Ks,D", K3_CASES)
def test_k3_kernel_matches_twin(cuda, B, band, Ks, D):
    rng = np.random.default_rng(B + band)
    n = 3 * band
    x = dict(
        wv=(rng.standard_normal((n, D)) * 0.1).astype(np.float32),
        wc=(rng.standard_normal((n, D)) * 0.1).astype(np.float32),
        sb=np.int32(band), db=np.int32(2 * band),
        src_l=rng.integers(0, min(band, 512), B).astype(np.int32),
        pos_l=rng.integers(0, band, B).astype(np.int32),
        cn=(rng.standard_normal((Ks, D)) * 0.1).astype(np.float32),
        alpha=np.float32(0.025),
    )
    a = {k: torch.from_numpy(np.array(v)).to(cuda) for k, v in x.items()}
    b = {k: v.clone() for k, v in a.items()}
    args = ("wv", "wc", "sb", "db", "src_l", "pos_l", "cn", "alpha")
    before = K3.launches
    kv, kc, kd, kl = sgns_banded_fused(*(a[k] for k in args))
    assert K3.launches == before + 1
    assert kv is a["wv"] and kc is a["wc"]
    rv, rc, rd, rl = sgns_banded_fused_ref(*(b[k] for k in args))
    torch.cuda.synchronize()
    for got, want in ((kv, rv), (kc, rc), (kd, rd)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(kl), float(rl), rtol=RTOL)
    assert not np.allclose(kc.cpu().numpy(), x["wc"])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["random", "all_same", "iota"])
def test_k2_kernel_matches_twin(cuda, kind):
    """Rows into the third band of a four-band table (rtol 2e-5, atol 2e-4,
    as the Pallas kernel's own test against np.add.at). Table and deltas lie
    on a 2^-10 grid, so every sum is exact in f32 and the atomics' changing
    order cannot round the 8192 all-same deltas past the tolerance."""
    rng = np.random.default_rng(5)
    band, D, B = 128, 64, 8192
    idx = {"random": rng.integers(0, band, B),
           "all_same": np.full(B, 7),
           "iota": np.arange(B) % band}[kind].astype(np.int32)

    def grid(shape):
        return np.round(rng.normal(size=shape) * 1024) / 1024

    table = torch.from_numpy(grid((4 * band, D)).astype(np.float32)).to(cuda)
    delta = torch.from_numpy(grid((B, D)).astype(np.float32)).to(cuda)
    start = torch.tensor(2 * band, dtype=torch.int32, device=cuda)
    idx = torch.from_numpy(idx).to(cuda)
    want = band_scatter_add_ref(table.clone(), start, idx, delta)
    before = K2.launches
    got = band_scatter_add(table, start, idx, delta)
    assert got is table and K2.launches == before + 1
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-5, atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("order,kw,counter", [
    (2, dict(multiband=False, use_pallas=True), K3),
    (1, {}, K2),
])
def test_line_banded_routes_train_through_k3_k2(cuda, order, kw, counter):
    """On a CUDA device LINE o2 with multiband=False, use_pallas=True takes
    the fused route (K3), and banded order 1 ("auto") the scatter-only
    route (K2); both learn the communities."""
    g = toy_graph()
    m = LINE(g, seed=0, device=cuda)
    m.init(dim=64, order=order)
    before = counter.launches
    m.train(banded=True, band_size=64, batch=128, sample_times=0.2,
            steps_per_call=32, verbose=False, **kw)
    assert counter.launches > before
    assert m.banded_tables.two_d == (order == 2)
    assert _link_auc(m, g) > 0.8


# K5: (S, B, band, n_bands, nb2, Ks, D, idx_hi): a small case with heavy
# duplicates, and the neg_band route's shapes (16 micro-steps of two
# 1024-row tiles, band 16400, window 3280) on a 6-band table
K5_CASES = [(4, 128, 64, 4, 16, 16, 64, 16),
            (16, 2048, 16400, 6, 3280, 128, 64, 16400),
            (4, 1024, 64, 4, 16, 128, 128, 64),  # D=128, Ks=128: big smem
            (4, 256, 96, 3, 32, 40, 32, 96)]  # ragged Ks=40, D=32


@pytest.mark.gpu
@pytest.mark.parametrize("S,B,band,n_bands,nb2,Ks,D,idx_hi", K5_CASES)
def test_k5_kernel_matches_twin(cuda, S, B, band, n_bands, nb2, Ks, D,
                                idx_hi):
    rng = np.random.default_rng(S + B)
    n = band * n_bands
    ratio = band // nb2
    db = rng.integers(0, n_bands, S)
    nb = rng.integers(0, n // nb2, S)
    nb[1] = db[1] * ratio + 1  # the window inside its own context band
    nb[2] = db[1] * ratio  # inside the previous step's context band
    nb[3] = nb[0]  # a window revisited
    x = dict(
        wv=(rng.standard_normal((n, D)) * 0.1).astype(np.float32),
        wc=(rng.standard_normal((n, D)) * 0.1).astype(np.float32),
        sb=rng.integers(0, n_bands, S), db=db, nb=nb,
        src_l=rng.integers(0, idx_hi, (S, B)),
        pos_l=rng.integers(0, idx_hi, (S, B)),
        negs_l=rng.integers(0, min(nb2, 64), (S, Ks)),
        alpha=np.linspace(0.05, 0.03, S).astype(np.float32),
    )
    args = ("wv", "wc", "sb", "db", "nb", "src_l", "pos_l", "negs_l",
            "alpha")
    a = {k: torch.from_numpy(np.asarray(
        v, np.float32 if v.dtype.kind == "f" else np.int32)).to(cuda)
        for k, v in x.items()}
    b = {k: v.clone() for k, v in a.items()}
    before = K5.launches
    kv, kc, kl = sgns_banded_multiblock_nb(*(a[k] for k in args),
                                           band_size=band, nb2=nb2)
    assert K5.launches == before + 1
    assert kv is a["wv"] and kc is a["wc"]
    rv, rc, rl = sgns_banded_multiblock_nb_ref(*(b[k] for k in args),
                                               band_size=band, nb2=nb2)
    torch.cuda.synchronize()
    for got, want in ((kv, rv), (kc, rc)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(kl), float(rl), rtol=RTOL)
    rows = (x["nb"][:, None] * nb2 + x["negs_l"]).ravel()
    assert not np.allclose(kc.cpu().numpy()[rows], x["wc"][rows])


@pytest.mark.gpu
@pytest.mark.parametrize("kw,counter", [
    (dict(neg_band=True), K5),
    (dict(multiband=False, band_hold=True, hoist=4), K3),
    (dict(multiband=False, band_hold=True, hoist=4, use_pallas="scatter"),
     K2),
])
def test_line_neg_band_and_band_hold_train(cuda, kw, counter):
    """On a CUDA device LINE o2 with neg_band=True takes the multiblock
    route with banded negatives (K5, not K4); band_hold=True off it holds
    one stratum per block, through K3 ("auto") or K2 ("scatter"). Each
    learns the communities."""
    g = toy_graph()
    m = LINE(g, seed=0, device=cuda)
    m.init(dim=64, order=2)
    before = counter.launches, K4.launches
    m.train(banded=True, band_size=64, batch=128, sample_times=0.2,
            steps_per_call=32, verbose=False, **kw)
    assert counter.launches > before[0]
    if counter is K5:
        assert K4.launches == before[1]
        assert m.banded_tables.nb2 == 64
    else:
        assert m.last_driver.micro_steps == 4
    assert _link_auc(m, g) > 0.8


def _all_collide_calls(kernel, x, device):
    """(call, twin call) of K4, K5 or K3 on copies of the all-collide
    inputs."""
    a = {k: torch.from_numpy(v.copy()).to(device) for k, v in x.items()}
    b = {k: v.clone() for k, v in a.items()}
    if kernel == "k4":
        band = dict(band_size=ALL_COLLIDE["band"])
        return (lambda: sgns_banded_multiblock(*(a[k] for k in _ARGS), **band),
                lambda: sgns_banded_multiblock_ref(*(b[k] for k in _ARGS),
                                                   **band))
    if kernel == "k3":
        return (lambda: sgns_banded_fused(*(a[k] for k in _ARGS)),
                lambda: sgns_banded_fused_ref(*(b[k] for k in _ARGS)))
    args = ("wv", "wc", "sb", "db", "nb", "src_l", "pos_l", "negs_l", "alpha")
    kw = dict(band_size=ALL_COLLIDE_NB["band"], nb2=ALL_COLLIDE_NB["nb2"])
    return (lambda: sgns_banded_multiblock_nb(*(a[k] for k in args), **kw),
            lambda: sgns_banded_multiblock_nb_ref(*(b[k] for k in args), **kw))


def _all_collide(kernel):
    return {"k4": lambda: multiblock_inputs(**ALL_COLLIDE),
            "k5": lambda: multiblock_nb_inputs(**ALL_COLLIDE_NB),
            "k3": lambda: fused_inputs(**ALL_COLLIDE_FUSED)}[kernel]()


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["k4", "k5", "k3"])
def test_all_collide_matches_twin(cuda, kernel):
    """Every source and positive row of the superstep is one vertex: the
    inputs tests/test_torch_sgns_banded*.py hold the twins to the Pallas
    kernels with. Every tile and step gathers what the one before it
    scattered (K3: two 2048-row tiles of one micro-step)."""
    x = _all_collide(kernel)
    call, twin = _all_collide_calls(kernel, x, cuda)
    got, want = call(), twin()
    torch.cuda.synchronize()
    for g, w in zip(got[:-1], want[:-1]):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(got[-1]), float(want[-1]), rtol=RTOL)
    row = ALL_COLLIDE["sb"][0] * ALL_COLLIDE["band"]
    assert not np.allclose(got[0].cpu().numpy()[row], x["wv"][row])


def _k1_call(device, B=32768, Ks=128, D=64):
    rng = np.random.default_rng(0)
    v, cp, cn = (torch.from_numpy((rng.standard_normal(s) * 0.3).astype(
        np.float32)).to(device) for s in ((B, D), (B, D), (Ks, D)))
    alpha = torch.tensor(0.025, device=device)
    return lambda: sgns_shared_grads(v, cp, cn, alpha, k_equiv=5)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["k4", "k5", "k3", "k1"])
def test_one_cuda_launch_per_call(cuda, kernel):
    """One wrapper call of K4, K5, K3 or K1 (int32 indices, f32 contiguous
    inputs) is ONE CUDA kernel launch, as torch.profiler counts the host's
    calls that put work on the card: no memset, no copy, no separate sum;
    the whole call runs in one cooperative launch. The device side records
    no other kernel (it may miss a record of a cooperative launch)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if kernel == "k1":
        call, name = _k1_call(cuda), "shared_grads_persistent"
    else:
        call, _ = _all_collide_calls(kernel, _all_collide(kernel), cuda)
        name = "superstep"
    call()  # build and warm up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    host = [e.name for e in prof.events() if e.name.startswith(
        ("cudaLaunch", "cuLaunch", "cudaMemset", "cudaMemcpy"))]
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    assert host == ["cudaLaunchCooperativeKernel"], host
    assert len(kernels) <= 1 and all(name in k for k in kernels), kernels


@pytest.mark.gpu
def test_k3_k4_k5_launch_in_one_process(cuda):
    """K3, K4 and K5 instantiate the one superstep kernel in three
    libraries; a kernel that two libraries of one process define refuses
    its cooperative launch. All three, launched one after another (K3 both
    first and last), match their twins."""
    results = []
    for kernel in ("k3", "k4", "k5", "k3"):
        call, twin = _all_collide_calls(kernel, _all_collide(kernel), cuda)
        results.append((call(), twin()))
    torch.cuda.synchronize()
    for got, want in results:
        for g, w in zip(got[:-1], want[:-1]):
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                       rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(float(got[-1]), float(want[-1]),
                                   rtol=RTOL)


# ------------------------------------------------------------ walk family
def _walk_graph():
    """A weighted directed graph with dead ends (a fifth of the vertices
    have no out-edge)."""
    from smore_tpu_torch.sampling.tables import SamplerTables

    rng = np.random.default_rng(3)
    edges = [(f"v{a}", f"v{b}", float(rng.uniform(0.5, 3.0)))
             for a, b in rng.integers(0, 500, (4000, 2)) if a != b and a % 5]
    g = Graph.from_edges(edges, undirected=False)
    return g, SamplerTables.build(g, device="cpu")


@pytest.mark.gpu
def test_walks_on_the_card_match_the_cpu(cuda):
    """The walk generators and the skip-gram mapper give the CPU's walks
    and pairs on the card, given the same uniforms (APP's stop index off
    integer quotients, where float32 log may round either way)."""
    from smore_tpu_torch.sampling import mappers, walks
    from smore_tpu_torch.sampling.tables import SamplerTables

    g, tc = _walk_graph()
    tg = SamplerTables.build(g, device=cuda)
    B, steps = 4096, 40
    gen = torch.Generator().manual_seed(0)
    starts = torch.randint(0, g.n_vertices, (B,), generator=gen,
                           dtype=torch.int32)
    u = torch.rand(steps, B, 2, generator=gen)
    got = walks.random_walk(tg, None, starts.to(cuda), steps, u=u.to(cuda))
    want = walks.random_walk(tc, None, starts, steps, u=u)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    reduce = torch.randint(1, 6, (B, steps + 1), generator=gen)
    for a, b in zip(
            mappers.skipgram_pairs(got[0], None, 5, got[1],
                                   reduce=reduce.to(cuda)),
            mappers.skipgram_pairs(want[0], None, 5, want[1],
                                   reduce=reduce)):
        assert torch.equal(a.cpu(), b)

    nc, ng = (walks.NeighborIndex.build(g, d) for d in ("cpu", cuda))
    u_first = torch.rand(B, 2, generator=gen)
    u3 = torch.rand(steps - 1, B, 4, 3, generator=gen)
    got = walks.node2vec_walk(tg, ng, None, starts.to(cuda), steps, 0.5, 2.0,
                              u_first=u_first.to(cuda), u=u3.to(cuda))
    want = walks.node2vec_walk(tc, nc, None, starts, steps, 0.5, 2.0,
                               u_first=u_first, u=u3)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)

    u64 = torch.rand(64, B, 2, generator=gen)
    u_stop = torch.rand(B, generator=gen)
    got = walks.jumping_walk_endpoints(tg, None, starts.to(cuda), 0.15,
                                       u=u64.to(cuda), u_stop=u_stop.to(cuda))
    want = walks.jumping_walk_endpoints(tc, None, starts, 0.15, u=u64,
                                        u_stop=u_stop)
    q = np.log(np.clip(u_stop.double().numpy(), 1e-12, 1)) / np.log(0.85)
    off = np.abs(q - np.round(q)) > 1e-4
    np.testing.assert_array_equal(got[0].cpu().numpy()[off],
                                  want[0].numpy()[off])
    assert torch.equal(got[1].cpu(), want[1])


def _walk_kernel_tables(device):
    """Sampler tables of ``torch_walk_inputs.dead_end_graph``: every fifth
    vertex and the last one have no out-edge, the last one's indptr E."""
    from smore_tpu_torch.sampling.tables import SamplerTables

    g = Graph.from_arrays(*dead_end_graph())
    t = SamplerTables.build(g, device=device)
    n = g.n_vertices
    assert t.vert_meta[n - 1].tolist() == [t.n_edges, 0]
    assert t.vert_meta[0, 1].item() == 0
    return t


def _walk_inputs(t, B, steps, seed):
    """``torch_walk_inputs.walk_inputs`` on the tables' device."""
    device = t.vert_meta.device
    return tuple(torch.from_numpy(a).to(device)
                 for a in walk_inputs(t.n_vertices, B, steps, seed))


WALK_KERNEL_CASES = [(B, steps) for B in (1, 128, 4096, 80640)
                     for steps in (1, 40, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("restart", [True, False])
@pytest.mark.parametrize("B,steps", WALK_KERNEL_CASES)
def test_walk_kernel_matches_twin(cuda, B, steps, restart):
    """The walk kernel's walks and row mask are the twin's, bit for bit,
    given the same uniforms: dead starts, a dead start past the last edge,
    restarts or held cursors at dead ends, one pass (40 steps) or two (64)
    of the kernel's staging."""
    from smore_tpu_torch.ops import random_walk as walk_kernel
    from smore_tpu_torch.sampling import walks

    t = _walk_kernel_tables(cuda)
    starts, u = _walk_inputs(t, B, steps, seed=B * 1000 + steps)
    before = walk_kernel.KERNEL.launches
    got = walks.random_walk(t, None, starts, steps, restart, u=u)
    assert walk_kernel.KERNEL.launches == before + 1
    want = walks.random_walk_ref(t, starts, steps, u, restart)
    assert got[0].shape == (B, steps + 1) and got[0].dtype == torch.int32
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_walk_kernel_captured_matches_eager(cuda):
    """Two walk launches (both restart modes) captured into one CUDA graph:
    the graph's nodes hold two launches of the walk kernel, and a replay on
    new uniforms, copied into the captured input, gives the twin's walks on
    those uniforms."""
    from smore_tpu_torch.ops import launches
    from smore_tpu_torch.sampling import walks

    t = _walk_kernel_tables(cuda)
    B, steps = 4096, 40
    starts, u = _walk_inputs(t, B, steps, seed=1)

    def call():
        return [walks.random_walk(t, None, starts, steps, restart, u=u)
                for restart in (True, False)]

    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        got = call()
    assert launches.in_graph(graph.raw_cuda_graph()) == {"random_walk": 2}
    u.copy_(_walk_inputs(t, B, steps, seed=2)[1])
    graph.replay()
    torch.cuda.synchronize()
    for (walk, mask), restart in zip(got, (True, False)):
        want = walks.random_walk_ref(t, starts, steps, u, restart)
        assert torch.equal(walk, want[0]) and torch.equal(mask, want[1])


def _node2vec_inputs(t, B, steps, trials, seed):
    """``torch_walk_inputs.node2vec_inputs`` on the tables' device."""
    device = t.vert_meta.device
    return tuple(torch.from_numpy(a).to(device) for a in node2vec_inputs(
        t.n_vertices, B, steps, trials, seed))


_NODE2VEC_GRAPHS = {"dead_end": dead_end_graph, "hub": hub_graph}


@functools.cache
def _node2vec_tables(graph, device):
    """Sampler tables and neighbour index of a ``torch_walk_inputs`` graph
    (``_NODE2VEC_GRAPHS``) on the device: dead starts (vertex 0, and the
    last vertex, whose indptr is E), and on "hub" a vertex of 4,499
    out-neighbours."""
    from smore_tpu_torch.sampling import walks
    from smore_tpu_torch.sampling.tables import SamplerTables

    g = Graph.from_arrays(*_NODE2VEC_GRAPHS[graph]())
    t = SamplerTables.build(g, device=device)
    n = g.n_vertices
    assert t.vert_meta[n - 1].tolist() == [t.n_edges, 0]
    assert t.vert_meta[0, 1].item() == 0
    return t, walks.NeighborIndex.build(g, device)


def _node2vec_instances(monkeypatch, run):
    """``run()`` under each instance of the node2vec walk kernel, forced
    through ``lanes_for``: {lanes: its result}."""
    from smore_tpu_torch.ops import node2vec_walk as n2v_kernel

    out = {}
    for lanes in n2v_kernel.LANES:
        with monkeypatch.context() as mp:
            mp.setattr(n2v_kernel, "lanes_for",
                       lambda B, sms, lanes=lanes: lanes)
            out[lanes] = run()
    return out


NODE2VEC_PQ = [(0.5, 2.0), (4.0, 0.25), (1.0, 1.0), (2.0, 0.5)]
# the cells' batches, and each side of lanes_for's crossover, sized on the
# card: "warp" the largest batch of the 32-lane instance, "warp+1" the next
NODE2VEC_BATCHES = (1, 128, "warp", "warp+1", 80640)


def _node2vec_batch(B, device):
    """A batch of ``NODE2VEC_BATCHES`` on the card."""
    from smore_tpu_torch.ops import node2vec_walk as n2v_kernel

    if isinstance(B, int):
        return B
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return n2v_kernel.WARP_WALKS_PER_SM * sms + (B == "warp+1")


@pytest.mark.gpu
@pytest.mark.parametrize("graph", sorted(_NODE2VEC_GRAPHS))
@pytest.mark.parametrize("p,q", NODE2VEC_PQ)
@pytest.mark.parametrize("steps", [1, 2, 40])
@pytest.mark.parametrize("B", NODE2VEC_BATCHES)
def test_node2vec_kernel_matches_twin(cuda, monkeypatch, B, steps, p, q,
                                      graph):
    """Both instances of the node2vec walk kernel (a thread and a warp a
    walk) give the twin's walks and row mask, bit for bit, given the same
    uniforms: dead starts, dead ends mid-walk (the cursor back at the
    start), index uniforms that round up to the degree, every p/q regime
    (returns favoured, far steps favoured, none, near steps favoured), and
    on the hub graph searches of several rounds, lists read whole and
    cand == prev; at the cells' batches and on both sides of the
    crossover."""
    from smore_tpu_torch.ops import node2vec_walk as n2v_kernel
    from smore_tpu_torch.sampling import walks

    t, nbr = _node2vec_tables(graph, cuda)
    B = _node2vec_batch(B, cuda)
    starts, u_first, u = _node2vec_inputs(t, B, steps, 4, B * 100 + steps)
    want = walks.node2vec_walk_ref(t, nbr, starts, steps, p, q, 4, u_first,
                                   u)

    def run():
        before = n2v_kernel.KERNEL.launches
        got = walks.node2vec_walk(t, nbr, None, starts, steps, p, q,
                                  u_first=u_first, u=u)
        assert n2v_kernel.KERNEL.launches == before + 1
        return got

    for lanes, got in _node2vec_instances(monkeypatch, run).items():
        assert got[0].shape == (B, steps + 1) and got[0].dtype == torch.int32
        assert torch.equal(got[0], want[0]), lanes
        assert torch.equal(got[1], want[1]), lanes


@pytest.mark.gpu
@pytest.mark.parametrize("trials", [1, 2, 3, 5, 6, 9, 33])
def test_node2vec_kernel_matches_twin_at_fewer_trials(cuda, monkeypatch,
                                                      trials):
    """Other trial counts than the cells' 4, on the hub graph, each
    instance: in the warp one group a trial (groups of 32, 16, 8, 4 and 2
    lanes), and more trials than the warp has groups (33: two rounds)."""
    from smore_tpu_torch.sampling import walks

    t, nbr = _node2vec_tables("hub", cuda)
    B, steps = 4096, 40
    starts, u_first, u = _node2vec_inputs(t, B, steps, trials, trials)
    want = walks.node2vec_walk_ref(t, nbr, starts, steps, 0.5, 2.0, trials,
                                   u_first, u)
    for lanes, got in _node2vec_instances(
            monkeypatch, lambda: walks.node2vec_walk(
                t, nbr, None, starts, steps, 0.5, 2.0, trials,
                u_first=u_first, u=u)).items():
        assert torch.equal(got[0], want[0]), lanes
        assert torch.equal(got[1], want[1]), lanes


@pytest.mark.gpu
def test_node2vec_kernel_captured_matches_eager(cuda, tracer):
    """Node2vec walk launches of two instances captured into one CUDA
    graph, as ``lanes_for`` picks them on the card (128 walks a warp each,
    80,640 a thread each): its nodes hold both launches, a replay on new
    uniforms, copied into the captured inputs, gives the twin's walks on
    those uniforms, and the tracer's ``node2vec_walk.warp_launches`` counts
    the multi-lane launch of the eager call and of the capture, not the
    replay's."""
    from smore_tpu_torch.ops import launches
    from smore_tpu_torch.ops import node2vec_walk as n2v_kernel
    from smore_tpu_torch.sampling import walks

    t, nbr = _node2vec_tables("hub", cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    batches, steps, pqs = (128, 80640), 40, NODE2VEC_PQ[:2]
    assert [n2v_kernel.lanes_for(B, sms) for B in batches] == [32, 1]
    inputs = [_node2vec_inputs(t, B, steps, 4, seed=B) for B in batches]
    tracer.enable()
    warp = "node2vec_walk.warp_launches"

    def call():
        return [walks.node2vec_walk(t, nbr, None, starts, steps, p, q,
                                    u_first=u_first, u=u)
                for (starts, u_first, u), (p, q) in zip(inputs, pqs)]

    call()
    torch.cuda.synchronize()
    assert tracer._counters[warp] == 1
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        got = call()
    assert launches.in_graph(graph.raw_cuda_graph()) == {"node2vec_walk": 2}
    assert tracer._counters[warp] == 2
    for B, (_, u_first, u) in zip(batches, inputs):
        _, u_first2, u2 = _node2vec_inputs(t, B, steps, 4, seed=B + 1)
        u_first.copy_(u_first2)
        u.copy_(u2)
    graph.replay()
    torch.cuda.synchronize()
    assert tracer._counters[warp] == 2
    for (walk, mask), (starts, u_first, u), (p, q) in zip(got, inputs, pqs):
        want = walks.node2vec_walk_ref(t, nbr, starts, steps, p, q, 4,
                                       u_first, u)
        assert torch.equal(walk, want[0]) and torch.equal(mask, want[1])


@pytest.mark.gpu
def test_node2vec_draws_its_walks_with_the_kernel(cuda):
    """Node2Vec on captured calls launches the node2vec walk kernel once a
    step (its replays credited), and no other kernel."""
    from smore_tpu_torch import models
    from smore_tpu_torch.ops import launches

    m = models.Node2Vec(_walk_graph()[0], seed=0, device=cuda)
    m.init(dim=16)
    before = launches.read()
    m.train(walk_times=4, steps_per_call=4, p=0.5, q=2.0, verbose=False)
    d = m.last_driver
    assert d.replays >= 1
    moved = launches.moved(before)
    assert moved == {"node2vec_walk":
                     d.executed_samples // d.samples_per_step}, moved


@pytest.mark.gpu
def test_deepwalk_draws_its_walks_with_the_kernel(cuda):
    """DeepWalk on captured calls launches the walk kernel once a step (its
    replays credited), and no update kernel."""
    from smore_tpu_torch import models
    from smore_tpu_torch.ops import launches

    m = models.DeepWalk(_walk_graph()[0], seed=0, device=cuda)
    m.init(dim=16)
    before = launches.read()
    m.train(walk_times=4, steps_per_call=4, verbose=False)
    d = m.last_driver
    assert d.replays >= 1
    moved = launches.moved(before)
    assert moved == {"random_walk":
                     d.executed_samples // d.samples_per_step}, moved


@pytest.mark.gpu
def test_checkpoint_round_trips_a_cuda_generator(cuda, tmp_path):
    """A CUDA generator's state is a CPU byte tensor: saved and restored, it
    draws what the saved generator draws next; tables come back to the
    card from the CPU."""
    from smore_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    gen = torch.Generator(device=cuda)
    gen.manual_seed(7)
    torch.rand(1000, generator=gen, device=cuda)
    table = torch.rand(50, 8, generator=gen, device=cuda)
    state = gen.get_state()
    assert state.device.type == "cpu" and state.dtype == torch.uint8
    save_checkpoint(str(tmp_path / "ck"), {"vertex": table}, step=3,
                    extra={"gen": state})
    want = torch.rand(4096, generator=gen, device=cuda)
    loaded, step, extra = load_checkpoint(str(tmp_path / "ck"))
    g2 = torch.Generator(device=cuda)
    g2.set_state(extra["gen"])
    assert step == 3
    assert torch.equal(torch.rand(4096, generator=g2, device=cuda), want)
    assert torch.equal(loaded["vertex"].to(cuda), table)


@pytest.mark.gpu
def test_deepwalk_kill_and_resume_on_the_card(cuda, tmp_path, monkeypatch):
    """DeepWalk on the card, killed after its 2nd checkpoint and resumed in
    a fresh model: the restored tables and generator state are the saved
    ones, and the resumed run ends finite with the steps left."""
    from smore_tpu_torch.models import DeepWalk
    from smore_tpu_torch.models.base import TrainDriver
    from smore_tpu_torch.utils.checkpoint import load_checkpoint

    g, _ = _walk_graph()
    ck = str(tmp_path / "ck")
    orig = TrainDriver._save_ckpt
    saves = []

    def killing_save(self, state, gen, done):
        orig(self, state, gen, done)
        saves.append(done)
        if len(saves) == 2:
            raise KeyboardInterrupt

    kw = dict(walk_times=8, walk_steps=10, steps_per_call=4, verbose=False)
    m = DeepWalk(g, seed=0, device=cuda)
    m.init(dim=32)
    m.set_checkpoint(ck)
    monkeypatch.setattr(TrainDriver, "_save_ckpt", killing_save)
    with pytest.raises(KeyboardInterrupt):
        m.train(**kw)
    monkeypatch.undo()
    saved, done, extra = load_checkpoint(ck)
    restored = {}
    orig_resume = TrainDriver._maybe_resume

    def spy(self, state, gen):
        out = orig_resume(self, state, gen)
        restored.update({k: v.clone() for k, v in state.items()},
                        gen=gen.get_state())
        return out

    monkeypatch.setattr(TrainDriver, "_maybe_resume", spy)
    m2 = DeepWalk(g, seed=0, device=cuda)
    m2.init(dim=32)
    m2.set_checkpoint(ck)
    m2.train(**kw)
    assert torch.equal(restored.pop("gen"), extra["gen"])
    for k, v in saved.items():
        assert torch.equal(restored[k].cpu(), v)
    d = m2.last_driver
    steps = -(-d.total_samples // d.samples_per_step)
    assert d.executed_samples == (-(-steps // d.steps_per_call)
                                  * d.steps_per_call - done) * d.samples_per_step
    assert all(bool(torch.isfinite(t).all()) for t in m2.state.values())


@pytest.mark.gpu
@pytest.mark.parametrize("two_d", [True, False])
def test_edge_stream_built_on_the_card_matches_the_cpu(cuda, two_d):
    """build_stream draws numpy's uniforms and does the rest on the tables'
    device: the card's stream is the CPU's (which tests/test_torch_host.py
    holds to the JAX package's) entry for entry."""
    from smore_tpu_torch.sampling.banded import BandedTables

    g, _ = _walk_graph()
    kw = dict(band_size=64, two_d=two_d)
    cpu = BandedTables.build(g, device="cpu", **kw).build_stream(mult=8)
    card = BandedTables.build(g, device=cuda, **kw).build_stream(mult=8)
    assert torch.equal(card.stream.cpu(), cpu.stream)
    assert torch.equal(card.stream_meta.cpu(), cpu.stream_meta)


# ------------------------------------------------------------- rec family
def _rec_inputs(device, seed=0, N=40, D=8, B=256, K=5, Ks=16):
    """Unit-scale tables (margins violated and not, Skew-OPT rounds skipped
    and taken) and indices into N rows (duplicates everywhere)."""
    rng = np.random.default_rng(seed)
    x = dict(
        wv=rng.standard_normal((N, D)) * 0.7,
        wc=rng.standard_normal((N, D)) * 0.7,
        src=rng.integers(0, N, B), pos=rng.integers(0, N, B),
        negs=rng.integers(0, N, (B, K)), negs16=rng.integers(0, N, (B, 16)),
        pool=rng.integers(0, N, Ks), u=rng.random((B, Ks + 1)),
        mask=(rng.random(B) < 0.7) * 1.0,
        alpha_b=rng.uniform(0.01, 0.05, B), margin_b=rng.uniform(0.2, 1, B),
    )
    return {k: torch.from_numpy(np.asarray(
        v, np.float32 if v.dtype.kind == "f" else np.int32)).to(device)
        for k, v in x.items()}


def _rec_call(name, a, shared):
    from smore_tpu_torch.ops import update as U

    wv = a["wv"]
    wc = wv if shared else a["wc"]
    alpha = torch.tensor(0.05, device=wv.device)
    kw = dict(shared_table=shared, collision="sum")
    m = dict(mask=a["mask"])
    skew = dict(xi=0.5, omega=1.0, eta=3)
    s, p = a["src"], a["pos"]
    return {
        "mf_step": lambda: U.mf_step(wv, wc, s, p, a["negs"], alpha, **m,
                                     **kw),
        "bpr_step": lambda: U.bpr_step(wv, wc, s, p, a["negs"], alpha, **m,
                                       **kw),
        "warp_step": lambda: U.warp_step(wv, wc, s, p, a["negs16"], alpha,
                                         **m, **kw),
        "skewbpr_step": lambda: U.skewbpr_step(wv, wc, s, p, a["negs16"],
                                               alpha, **skew, **m, **kw),
        "fbpr_step": lambda: U.fbpr_step(wv, wc, s, p, a["negs"][:, :1],
                                         a["alpha_b"], a["margin_b"], **m,
                                         **kw),
        "bpr_shared_negs_step": lambda: U.bpr_shared_negs_step(
            wv, wc, s, p, a["pool"], alpha, **kw),
        "mf_shared_negs_step": lambda: U.mf_shared_negs_step(
            wv, wc, s, p, a["pool"], alpha, **kw),
        "warp_shared_pool_step": lambda: U.warp_shared_pool_step(
            wv, wc, s, p, a["pool"], a["u"], alpha, trials=3, **kw),
        "skewbpr_shared_negs_step": lambda: U.skewbpr_shared_negs_step(
            wv, wc, s, p, a["pool"], alpha, **skew, **kw),
    }[name]()


@pytest.mark.gpu
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("name", [
    "mf_step", "bpr_step", "warp_step", "skewbpr_step", "fbpr_step",
    "bpr_shared_negs_step", "mf_shared_negs_step", "warp_shared_pool_step",
    "skewbpr_shared_negs_step"])
def test_rec_update_on_the_card_matches_the_cpu(cuda, name, shared):
    """Each rec update on CUDA tensors against the same call on the CPU
    (index_add_'s atomics sum duplicate rows in another order)."""
    got = _rec_call(name, _rec_inputs(cuda), shared)
    want = _rec_call(name, _rec_inputs("cpu"), shared)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.gpu
def test_negative_field_sample_on_the_card_matches_the_cpu(cuda):
    from smore_tpu_torch.sampling.fields import FieldTables

    g, _ = _walk_graph()
    g.fields = (np.arange(g.n_vertices) % 3).astype(np.int32)
    g.n_fields = 3
    tc, tg = (FieldTables.build(g, weights=g.out_degree, device=d)
              for d in ("cpu", cuda))
    for name in ("field_indptr", "field_pa", "field_vid", "field_of"):
        assert torch.equal(getattr(tg, name).cpu(), getattr(tc, name))
    gen = torch.Generator().manual_seed(0)
    fids = torch.randint(0, 3, (4096, 16), generator=gen, dtype=torch.int32)
    u2 = torch.rand(4096, 16, 2, generator=gen)
    got = tg.negative_field_sample(None, fids.to(cuda), u2=u2.to(cuda))
    want = tc.negative_field_sample(None, fids, u2=u2)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(tc.field_of_v(want), fids)


@pytest.mark.gpu
def test_bpr_checkpoint_on_the_card_restores_byte_equal(cuda, tmp_path,
                                                        monkeypatch):
    """BPR on the card (the hoisted shared pool), killed after its 2nd
    checkpoint and resumed in a fresh model: the restored table and CUDA
    generator state are the saved bytes."""
    from smore_tpu_torch.models import BPR
    from smore_tpu_torch.models.base import TrainDriver
    from smore_tpu_torch.utils.checkpoint import load_checkpoint

    g, _ = _walk_graph()
    ck = str(tmp_path / "ck")
    orig = TrainDriver._save_ckpt
    saves = []

    def killing_save(self, state, gen, done):
        orig(self, state, gen, done)
        saves.append(done)
        if len(saves) == 2:
            raise KeyboardInterrupt

    kw = dict(sample_times=0.5, steps_per_call=32, verbose=False)
    m = BPR(g, seed=0, device=cuda)
    m.init(dim=32)
    m.set_checkpoint(ck)
    monkeypatch.setattr(TrainDriver, "_save_ckpt", killing_save)
    with pytest.raises(KeyboardInterrupt):
        m.train(**kw)
    monkeypatch.undo()
    saved, done, extra = load_checkpoint(ck)
    restored = {}
    orig_resume = TrainDriver._maybe_resume

    def spy(self, state, gen):
        out = orig_resume(self, state, gen)
        restored.update({k: v.clone() for k, v in state.items()},
                        gen=gen.get_state())
        return out

    monkeypatch.setattr(TrainDriver, "_maybe_resume", spy)
    m2 = BPR(g, seed=0, device=cuda)
    m2.init(dim=32)
    m2.set_checkpoint(ck)
    m2.train(**kw)
    assert done == 2 * m2.last_driver.steps_per_call
    assert torch.equal(restored.pop("gen"), extra["gen"])
    assert torch.equal(restored["vertex"].cpu(), saved["vertex"])
    assert m2.last_driver.executed_samples > 0
    assert bool(torch.isfinite(m2.state["vertex"]).all())


# ------------------------------------------------------- community family
def _community_inputs(device, seed=0, N=40, D=8, B=256, K=4, S=3, Kp=16,
                      nf=2):
    """Tables at the community updates' scale (the exp-based choice updates
    need small dot products), indices into N rows with duplicates
    everywhere, a two-field projection (shadow tables of N * nf rows)."""
    rng = np.random.default_rng(seed)
    fields_of = rng.integers(0, nf, N)
    x = dict(
        w=rng.standard_normal((N, D)) * 0.3,
        w2=rng.standard_normal((N, D)) * 0.3,
        sv=rng.standard_normal((N * nf, D)) * 0.3,
        sc=rng.standard_normal((N * nf, D)) * 0.3,
        a=rng.integers(0, N, B), b=rng.integers(0, N, B),
        c=rng.integers(0, N, B), negs=rng.integers(0, N, (B, K)),
        bs=rng.integers(0, N, (B, S)), bs2=rng.integers(0, N, (B, S)),
        sets=rng.integers(0, N, (B, K, S)),
        rounds=rng.integers(0, N, (B, 5, K)),
        pool=rng.integers(0, N, Kp), pool_s=rng.integers(0, N, (Kp, S)),
        walk_negs=rng.integers(0, N, (B, S, K)),
        field_pool=np.stack([rng.choice(np.flatnonzero(fields_of == f), Kp)
                             for f in range(nf)]),
        fields_of=fields_of,
        walk_mask=np.cumprod(rng.random((B, S)) < 0.85, axis=1) * 1.0,
        mask=(rng.random(B) < 0.7) * 1.0,
        labels=(rng.random(B) < 0.5) * 1.0,
    )
    return {k: torch.from_numpy(np.asarray(
        v, np.float32 if v.dtype.kind == "f" else np.int32)).to(device)
        for k, v in x.items()}


def _community_call(name, x):
    from smore_tpu_torch.ops import community as C
    from smore_tpu_torch.ops import update as U

    alpha = torch.tensor(0.05, device=x["w"].device)
    w, w2, m = x["w"], x["w2"], x["mask"]
    a, b, c = x["a"], x["b"], x["c"]
    field = (x["sv"], x["sc"], a, x["bs"], x["walk_mask"])
    return {
        "cbow_step": lambda: C.cbow_step(w, x["bs"], x["bs2"], x["sets"],
                                         alpha, mask=m),
        "cbow_step_shared_negs": lambda: C.cbow_step_shared_negs(
            w, x["bs"], x["bs2"], x["pool_s"], alpha, mask=m),
        "dchoice_step": lambda: C.dchoice_step(w, a, b, c, x["negs"], alpha),
        "dchoice_step_shared_negs": lambda: C.dchoice_step_shared_negs(
            w, a, b, c, x["pool"], alpha),
        "choice_softmax_step": lambda: C.choice_softmax_step(
            w, a, b, x["negs"], alpha, mask=m),
        "choice_softmax_step_shared_negs":
            lambda: C.choice_softmax_step_shared_negs(w, a, b, x["pool"],
                                                      alpha, mask=m),
        "raw_choice_step": lambda: C.raw_choice_step(w, w2, a, b, x["negs"],
                                                     alpha, mask=m),
        "choice_step": lambda: C.choice_step(w, w2, a, b, x["rounds"],
                                             x["negs"], alpha),
        "field_community_step": lambda: C.field_community_step(
            *field, x["walk_negs"], x["fields_of"], 2, alpha),
        "field_community_step_ms": lambda: C.field_community_step(
            *field, x["walk_negs"], x["fields_of"], 2, alpha,
            ms_variant=True),
        "field_community_step_shared_negs":
            lambda: C.field_community_step_shared_negs(
                *field, x["field_pool"], x["fields_of"], 2, alpha),
        "field_community_step_shared_negs_ms":
            lambda: C.field_community_step_shared_negs(
                *field, x["field_pool"], x["fields_of"], 2, alpha,
                ms_variant=True),
        "pu_sgd_step": lambda: U.pu_sgd_step(w, w2, a, b, x["labels"], alpha,
                                             mask=m),
        "pu_sigmoid_step": lambda: U.pu_sigmoid_step(w, w2, a, b, x["labels"],
                                                     alpha, mask=m),
        "pu_bpr_step": lambda: U.pu_bpr_step(w, w2, a, b, x["negs"], alpha,
                                             mask=m),
        "cosine_step": lambda: U.cosine_step(w, w2, a, b, x["negs"], alpha,
                                             mask=m),
        "length_step": lambda: U.length_step(w, w2, a, b, x["negs"], alpha,
                                             mask=m),
        "grouping_step": lambda: U.grouping_step(w, w2, x["bs"], x["bs2"],
                                                 x["labels"], alpha, mask=m),
    }[name]()


COMMUNITY_OPS = [
    "cbow_step", "cbow_step_shared_negs", "dchoice_step",
    "dchoice_step_shared_negs", "choice_softmax_step",
    "choice_softmax_step_shared_negs", "raw_choice_step", "choice_step",
    "field_community_step", "field_community_step_ms",
    "field_community_step_shared_negs", "field_community_step_shared_negs_ms",
    "pu_sgd_step", "pu_sigmoid_step", "pu_bpr_step", "cosine_step",
    "length_step", "grouping_step"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", COMMUNITY_OPS)
def test_community_update_on_the_card_matches_the_cpu(cuda, name):
    """Each community op and each of the last six updates on CUDA tensors
    against the same call on the CPU (index_add_'s atomics sum duplicate
    rows in another order)."""
    got = _community_call(name, _community_inputs(cuda))
    want = _community_call(name, _community_inputs("cpu"))
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("name,kw", [
    ("GCN", dict(walk_steps=2)), ("TEXTGCN", dict(walk_steps=2)),
    ("TEXTGCNdev", dict(num_events=2, num_words=2)), ("ECO", {}),
    ("ECO", dict(head="hop_choice")), ("ECO", dict(head="recall_rank")),
    ("FINE", dict(walk_steps=2)), ("MSFINE", dict(walk_steps=2))])
def test_community_model_trains_on_the_card(cuda, name, kw):
    """One train() call of each community model on the card: every table on
    the card, finite and moved, no kernel launched."""
    from smore_tpu_torch import models

    kw = dict(kw)
    ctor = {"head": kw.pop("head")} if "head" in kw else {}
    m = getattr(models, name)(field_graph(), seed=0, device=cuda, **ctor)
    m.init(dim=16)
    before = {k: v.clone() for k, v in m.state.items()}
    counters = (K4, K1, K3, K2, K5)
    for c in counters:
        c.launches = 0
    m.train(sample_times=0.02, steps_per_call=4, verbose=False, **kw)
    assert not any(c.launches for c in counters)
    moved = False
    for k, v in m.state.items():
        assert v.device.type == "cuda"
        assert bool(torch.isfinite(v).all()), k
        moved |= not torch.equal(v, before[k])
    assert moved and m.last_driver.executed_samples >= 20_000


_KERNELS = (K4, K1, K3, K2, K5)


def _moved_on_card(before, state):
    moved = False
    for k, v in state.items():
        assert v.device.type == "cuda"
        assert bool(torch.isfinite(v).all()), k
        moved |= not torch.equal(v, before[k])
    return moved


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["TransE", "RotatE", "ComplEx"])
def test_kg_model_trains_on_the_card(cuda, name, tmp_path):
    """Two epochs of each knowledge-graph model on the card (the smoke's
    KG set, cut to 4 clusters): tables on the card, finite and moved, no
    kernel launched, link prediction above chance."""
    from smore_tpu_torch import models
    from smore_tpu_torch.utils.oracle_data import make_kg

    path = make_kg(str(tmp_path / "kg.txt"), n_clusters=4, per=50, n_rel=3,
                   triples_per_rel=600)
    m = getattr(models, name).load_triples(path, seed=0, device=cuda)
    m.init(dim=16)
    before = {k: v.clone() for k, v in m.state.items()}
    for c in _KERNELS:
        c.launches = 0
    m.train(epochs=2, batch=128, alpha=0.01, verbose=False)
    assert not any(c.launches for c in _KERNELS)
    assert _moved_on_card(before, m.state)
    assert m.evaluate_link_prediction(test_triples=200)[0] > 1 / 11


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["SNE", "FastRP", "CPR", "TPR",
                                  "Metapath2Vec", "HAN", "CTDNE"])
def test_typed_model_trains_on_the_card(cuda, name, tmp_path):
    """A few steps of each typed-graph model on the card on the smoke's
    sets: tables on the card, finite and moved (FastRP: unit rows), no
    kernel launched."""
    from smore_tpu_torch import models
    from smore_tpu_torch.utils import oracle_data as od

    cls = getattr(models, name)
    d = str(tmp_path)
    if name == "SNE":
        m = cls.load_edge_list(od.make_signed(f"{d}/s.txt"),
                               undirected=False, device=cuda)
        run = dict(epochs=1, batch=512)
    elif name == "FastRP":
        m = cls.load_edge_list(od.make_community(f"{d}/c.txt"), device=cuda)
        m.generate(dim=16)
        x = m.state["vertex"]
        assert x.device.type == "cuda"
        torch.testing.assert_close(x.norm(dim=1),
                                   torch.ones(len(x), device=cuda))
        return
    elif name == "CPR":
        od.make_two_domains(f"{d}/t.txt", f"{d}/s.txt")
        m = cls.load_domains(f"{d}/t.txt", f"{d}/s.txt", device=cuda)
        run = dict(update_times=0.01)
    elif name == "TPR":
        od.make_text_rec(f"{d}/ui.txt", f"{d}/iw.txt")
        m = cls.load_graphs(f"{d}/ui.txt", f"{d}/iw.txt", device=cuda)
        run = dict(sample_times=0.01)
    elif name == "CTDNE":
        m = cls.load_edge_list(od.make_temporal(f"{d}/t.txt"),
                               time_window=20.0, device=cuda)
        run = dict(walk_times=1, walk_steps=10)
    else:
        m = cls.load_edge_list(od.make_hetero(f"{d}/h.txt"), device=cuda)
        for mp in od.RUNS["han"]["meta_paths"]:
            m.add_meta_path(mp)
        run = (dict(walk_times=2, walk_steps=4, epochs=1) if name == "HAN"
               else dict(walk_times=1, walk_steps=8))
    m.init(dim=16)
    before = {k: v.clone() for k, v in m.state.items()}
    for c in _KERNELS:
        c.launches = 0
    m.train(verbose=False, **run)
    assert not any(c.launches for c in _KERNELS)
    assert _moved_on_card(before, m.state)


def _jodie_inputs(tmp_path, dim, features, kind="narrow"):
    """JODIE on an 1,500-event clustered set (the smoke's generator, cut;
    40 users, 60 items: about 7 events a level), with two feature columns
    when ``features``; every event on one item when ``kind`` is
    "one_item" (one event a level); "wide": 3,000 events of 2,000 users
    and 1,000 items (``interaction_arrays``, levels of ~100 events). The
    model at init(dim) on the card."""
    from smore_tpu_torch.graph.bipartite import InteractionGraph
    from smore_tpu_torch.models import JODIE
    from smore_tpu_torch.utils.seq_data import (
        interaction_arrays,
        make_interactions,
    )

    if kind == "wide":
        ig = InteractionGraph.from_events(*interaction_arrays(
            users=2000, items=1000, events=3000,
            features=2 if features else 0))
        m = JODIE(ig, seed=0, device="cuda")
        m.init(dim)
        return m
    path = make_interactions(str(tmp_path / "ev.txt"), events=1500)
    lines = open(path).read().splitlines()
    if kind == "one_item":
        lines = [f"{u} i0 {t}" for u, _, t in (ln.split() for ln in lines)]
    if features:
        rng = np.random.default_rng(0)
        lines = [f"{ln} {a:.3f} {b:.3f}"
                 for ln, (a, b) in zip(lines, rng.random((len(lines), 2)))]
    with open(path, "w") as f:
        f.writelines(ln + "\n" for ln in lines)
    m = JODIE.load_interactions(path, seed=0, device="cuda")
    m.init(dim)
    return m


def _jodie_epoch_args(m, one_item=False):
    """One epoch's arguments after the four tables (negatives drawn with
    numpy, seed 1; among 60 items, whose tables replace the one item's,
    when ``one_item``), the level schedule and a fresh-tables maker."""
    from smore_tpu_torch.ops.jodie_epoch import level_schedule

    ig, st = m.ig, m.state
    dev = st["user_static"].device
    n_items = 60 if one_item else ig.n_items
    if one_item:
        st["item_static"] = torch.randn(60, m.dim, device=dev) / m.dim
    negs = torch.from_numpy(np.random.default_rng(1).integers(
        0, n_items, ig.n_interactions)).to(dev)
    uid, iid, cu, ci = m.scan_inputs(st)
    sched = level_schedule(ig.user_ids, ig.item_ids, negs, ig.n_users,
                           n_items, dev)

    def tables():
        ue, ie = st["user_static"].clone(), st["item_static"].clone()
        return [ue, ie, ue.clone(), ie.clone()]

    return ((uid, iid, negs, cu, ci, st["user_rnn"], st["item_rnn"], 0.05,
             0.2), sched, tables)


JODIE_DIMS = (16, 32, 48, 50, 64, 96, 100, 128, 256, 513)
# the kernel chooses its layout from D and the widest level: the narrow
# sets give 8 blocks an event, the wide set at dims 16, 64, 80, 128 gives
# 1, 1, 2, 4, and at 513 the weight rows a block's shared memory cannot
# hold are read from L2 (test_jodie_plans_cover_every_layout)
JODIE_CASES = (*((d, d % 2 == 0, "narrow") for d in JODIE_DIMS),
               (64, False, "one_item"), (128, True, "one_item"),
               (16, True, "wide"), (64, False, "wide"), (80, True, "wide"),
               (128, False, "wide"), (513, True, "wide"))


@pytest.mark.gpu
@pytest.mark.parametrize("dim,features,kind", JODIE_CASES)
def test_jodie_epoch_kernel_matches_the_twin(cuda, tmp_path, dim, features,
                                             kind):
    """One epoch through the kernel and through the plain loop, the same
    draws (events with neg == i among them): the four tables and the loss
    agree to f32 round-off (the dot products and cell products sum in
    another order), and the call launched the kernel once."""
    from smore_tpu_torch.ops.jodie_epoch import KERNEL as JODIE
    from smore_tpu_torch.ops.jodie_epoch import jodie_epoch, jodie_epoch_ref

    m = _jodie_inputs(tmp_path, dim, features, kind)
    args, sched, tables = _jodie_epoch_args(m, kind == "one_item")
    assert bool((args[2].cpu().numpy() == m.ig.item_ids).any())
    if kind == "one_item":
        assert sched.n_levels == m.ig.n_interactions
    b = tables()
    lb = jodie_epoch_ref(*b, *args)
    a = tables()
    before = JODIE.launches
    la = jodie_epoch(*a, *args, sched)
    torch.cuda.synchronize()
    assert JODIE.launches == before + 1
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(la, lb, rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_jodie_plans_cover_every_layout(cuda, tmp_path):
    """The cases of test_jodie_epoch_kernel_matches_the_twin reach every
    split (1, 2, 4 and 8 blocks an event) and the weight rows read from
    L2."""
    from smore_tpu_torch.ops.jodie_epoch import kernel_plan

    splits, from_l2 = set(), False
    for dim, features, kind in JODIE_CASES:
        m = _jodie_inputs(tmp_path, dim, features, kind)
        _, sched, _ = _jodie_epoch_args(m, kind == "one_item")
        p = kernel_plan(dim, sched.max_width)
        splits.add(p["split"])
        from_l2 |= p["cached_rows"] < 2 * -(-dim // p["split"])
    assert splits == {1, 2, 4, 8}
    assert from_l2


@pytest.mark.gpu
def test_jodie_launch_after_a_plan_of_another_dim(cuda, tmp_path):
    """A plan query for a smaller layout between two launches (it sets the
    kernel's shared-memory limit: 9,984 B at D=64 one event a level,
    against the launch's 70,464 B) leaves the next launch whole."""
    from smore_tpu_torch.ops.jodie_epoch import (
        jodie_epoch,
        jodie_epoch_ref,
        kernel_plan,
    )

    m = _jodie_inputs(tmp_path, 128, False, "wide")
    args, sched, tables = _jodie_epoch_args(m)
    b = tables()
    lb = jodie_epoch_ref(*b, *args)
    for _ in range(2):
        a = tables()
        la = jodie_epoch(*a, *args, sched)
        assert kernel_plan(64, 1)["smem_bytes"] < kernel_plan(
            128, sched.max_width)["smem_bytes"]
        kernel_plan(64, 1)
        torch.cuda.synchronize()
        for x, y in zip(a + [la], b + [lb]):
            torch.testing.assert_close(x, y, rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_jodie_trains_on_the_card_one_launch_an_epoch(cuda, tmp_path):
    from smore_tpu_torch.ops.jodie_epoch import KERNEL as JODIE

    m = _jodie_inputs(tmp_path, 64, False)
    before = m.state["user_static"].clone()
    n = JODIE.launches
    m.train(epochs=3, learning_rate=0.05, bce_lr=0.2, verbose=False)
    assert JODIE.launches == n + 3
    assert bool(torch.isfinite(m.user_dyn).all())
    assert not torch.equal(m.state["user_static"], before)
    assert m.evaluate_predictions() > 0.6


@pytest.mark.gpu
@pytest.mark.parametrize("dim", [16, 48, 50, 100, 128, 256, 513])
def test_jodie_kernel_takes_any_dim(cuda, tmp_path, dim):
    """Dims the earlier kernel refused (not a multiple of 32, or above 96)
    train through the kernel: one launch an epoch, finite tables that
    moved."""
    from smore_tpu_torch.ops.jodie_epoch import KERNEL as JODIE

    m = _jodie_inputs(tmp_path, dim, False)
    before = m.state["user_static"].clone()
    n = JODIE.launches
    m.train(epochs=2, learning_rate=0.05, bce_lr=0.2, verbose=False)
    assert JODIE.launches == n + 2
    assert m.user_dyn.shape == (m.ig.n_users, dim)
    assert bool(torch.isfinite(m.user_dyn).all())
    assert bool(torch.isfinite(m.item_dyn).all())
    assert not torch.equal(m.state["user_static"], before)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["SASRec", "GSASRec", "RecDenoiser"])
def test_seq_model_trains_on_the_card(cuda, name, tmp_path):
    """Two epochs of each SASRec-family model on the card on a cut Markov
    set: parameters on the card, finite and moved, no kernel launched,
    the ranking evaluated."""
    from smore_tpu_torch import models
    from smore_tpu_torch.ops.jodie_epoch import KERNEL as JODIE

    path = tmp_path / "seq.txt"
    rng = np.random.default_rng(0)
    path.write_text("".join(f"u{u} i{i} 1\n" for u in range(200)
                            for i in rng.integers(0, 100, 12)))
    m = getattr(models, name).load_edge_list(str(path), device=cuda,
                                              negative_samples=3)
    m.init(dim=32, max_seq_len=10)
    before = {k: v.clone() for k, v in m.net.state_dict().items()}
    counters = _KERNELS + (JODIE,)
    for c in counters:
        c.launches = 0
    m.train(epochs=2, batch_size=32, alpha=0.003, verbose=False,
            holdout=True)
    assert not any(c.launches for c in counters)
    assert _moved_on_card(before, m.net.state_dict())
    r = m.evaluate_ranking()
    assert 0.0 <= r["recall@10"] <= 1.0


# ------------------------------------------- the captured call (CUDA graph)


@pytest.mark.gpu
@pytest.mark.parametrize("case", CAPTURED)
def test_captured_calls_match_eager_calls(cuda, case, tmp_path):
    """Each LINE route and each family, from one seed, trained with every
    call after the first a replay of one captured CUDA graph and trained
    eagerly (``capture=False``): the tables agree within the kernels'
    tolerance (atomics reorder sums), the generator states are equal (the
    graph-safe Philox advances as the eager ops do), and every kernel was
    launched as often (its counter credited on each replay)."""
    from smore_tpu_torch.ops import launches

    runs = {}
    for capture in (True, False):
        m, kw = build_case(case, cuda, str(tmp_path))
        m.capture = capture
        before = launches.read()
        m.train(**kw)
        torch.cuda.synchronize()
        runs[capture] = (m, m.last_driver, launches.moved(before))
    (mc, dc, lc), (me, de, le) = runs[True], runs[False]
    assert dc.calls >= 2 and dc.replays == dc.calls - 1, (dc.calls,
                                                         dc.replays)
    assert de.replays == 0 and de.calls == dc.calls
    assert lc == le
    if case in LINE_ROUTES:
        assert lc.get(LINE_ROUTES[case][2], 0) > 0, lc
    assert torch.equal(dc.gen.get_state(), de.gen.get_state())
    for k, v in me.state.items():
        np.testing.assert_allclose(mc.state[k].cpu().numpy(),
                                   v.cpu().numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def _k1_pair(device, B=4096, Ks=128, D=64):
    rng = np.random.default_rng(0)
    v, cp, cn = (torch.from_numpy((rng.standard_normal(s) * 0.3).astype(
        np.float32)).to(device) for s in ((B, D), (B, D), (Ks, D)))
    alpha = torch.tensor(0.025, device=device)
    return (lambda: sgns_shared_grads(v, cp, cn, alpha, k_equiv=5),
            lambda: sgns_shared_grads_ref(v, cp, cn, alpha, k_equiv=5))


def _k2_pair(device):
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.standard_normal((4 * 2048, 64)).astype(
        np.float32)).to(device)
    twin_table = table.clone()
    start = torch.tensor([2048], dtype=torch.int32, device=device)
    idx = torch.from_numpy(rng.integers(0, 2048, 4096).astype(
        np.int32)).to(device)
    delta = torch.from_numpy(rng.standard_normal((4096, 64)).astype(
        np.float32)).to(device)
    return ((lambda: (band_scatter_add(table, start, idx, delta),)),
            (lambda: (band_scatter_add_ref(twin_table, start, idx, delta),)))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["k4", "k5", "k3", "k1", "k2"])
def test_each_kernel_captured_alone_matches_its_twin(cuda, kernel):
    """One wrapper call captured into a CUDA graph (after one eager call,
    as the driver's warm-up) and replayed: the graph's nodes hold one
    launch of the kernel, as its library counts them, and the outputs and
    the updated tables match the twin run as often (an in-place kernel ran
    twice)."""
    from smore_tpu_torch.ops import launches

    name = {"k4": "sgns_banded_multiblock", "k5": "sgns_banded_multiblock_nb",
            "k3": "sgns_banded_fused", "k1": "sgns_shared_grads",
            "k2": "band_scatter_add"}[kernel]
    if kernel == "k1":
        call, twin = _k1_pair(cuda)
    elif kernel == "k2":
        call, twin = _k2_pair(cuda)
    else:
        call, twin = _all_collide_calls(kernel, _all_collide(kernel), cuda)
    call(), twin()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        got = call()
    assert launches.in_graph(graph.raw_cuda_graph()) == {name: 1}
    graph.replay()
    want = twin()
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_a_captured_kill_and_resume_restores_byte_equal_tables(cuda,
                                                               tmp_path,
                                                               monkeypatch):
    """LINE multiblock on captured calls, killed after its 3rd checkpoint
    (the warm-up and two replays) and resumed in a fresh model: the
    restored tables and generator state are the saved bytes, and the
    resumed run replays its calls to the end."""
    from smore_tpu_torch.models.base import TrainDriver
    from smore_tpu_torch.utils.checkpoint import load_checkpoint

    ck = str(tmp_path / "ck")
    orig = TrainDriver._save_ckpt
    saves = []

    def killing_save(self, state, gen, done):
        orig(self, state, gen, done)
        saves.append(done)
        if len(saves) == 3:
            raise KeyboardInterrupt

    m, kw = build_case("line_multiblock", cuda, str(tmp_path))
    m.set_checkpoint(ck)
    monkeypatch.setattr(TrainDriver, "_save_ckpt", killing_save)
    with pytest.raises(KeyboardInterrupt):
        m.train(**kw)
    monkeypatch.undo()
    assert m.last_driver.replays == 2
    saved, done, extra = load_checkpoint(ck)
    restored = {}
    orig_resume = TrainDriver._maybe_resume

    def spy(self, state, gen):
        out = orig_resume(self, state, gen)
        restored.update({k: v.clone() for k, v in state.items()},
                        gen=gen.get_state())
        return out

    monkeypatch.setattr(TrainDriver, "_maybe_resume", spy)
    m2, kw = build_case("line_multiblock", cuda, str(tmp_path))
    m2.set_checkpoint(ck)
    m2.train(**kw)
    assert torch.equal(restored.pop("gen"), extra["gen"])
    for k, v in saved.items():
        assert torch.equal(restored[k].cpu(), v)
    d = m2.last_driver
    assert d.replays == d.calls - 1 >= 2
    assert all(bool(torch.isfinite(t).all()) for t in m2.state.values())


@pytest.mark.gpu
def test_a_step_that_syncs_raises_at_capture(cuda):
    """A step that reads a value back to the host trains eagerly (the
    warm-up call) and raises when the second call is captured: nothing
    falls back to eager."""
    from smore_tpu_torch.models.base import TrainDriver

    def step(state, ctx, gen, alpha):
        w = state["w"]
        w.add_(float(w.sum()) * 0.0 + alpha)
        return state, w.sum()

    d = TrainDriver(step, ctx=None, samples_per_step=1, alpha=0.1,
                    total_samples=8, steps_per_call=2, device=cuda)
    with pytest.raises(RuntimeError):
        d.train({"w": torch.ones(4, 3, device=cuda)},
                torch.Generator(device=cuda), verbose=False)
    assert d.calls == 1 and d.replays == 0
    torch.cuda.synchronize()
    assert float(torch.ones(2, device=cuda).sum()) == 2.0  # the card works


# ------------------------------- the mesh modes' calls on NCCL (CUDA graph)
@pytest.fixture
def nccl_mesh(cuda):
    """A one-rank NCCL group in this process on a free port, and its 1-D
    mesh; the group is destroyed after the test."""
    import torch.distributed as dist

    from smore_tpu_torch.parallel.mesh import init_distributed, make_mesh

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    init_distributed(f"127.0.0.1:{port}", 1, 0, backend="nccl")
    try:
        yield make_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("name", [n for n in sorted(MESH_CASES)
                                  if n.startswith("line")])
def test_mesh_captured_calls_match_eager_calls(cuda, nccl_mesh, name,
                                               tmp_path):
    """LINE "dp", "rows" and "hogwild" on a one-rank NCCL group, from one
    seed, trained with every call after the first a replay of one captured
    CUDA graph that holds the call's collectives, and eagerly
    (``capture=False``): the tables agree within the kernels' tolerance,
    the generator states are equal, the collectives' calls and bytes are
    equal (credited on each replay; not timed), and K1 or K4 was launched
    as often."""
    from smore_tpu_torch.ops import launches
    from smore_tpu_torch.parallel.mesh import full_table

    _, mode, _, kernel = MESH_CASES[name]
    runs = {}
    for capture in (True, False):
        m, kw = build_mesh(name, cuda, str(tmp_path), nccl_mesh)
        m.capture = capture
        before = launches.read()
        m.train(**kw)
        torch.cuda.synchronize()
        runs[capture] = (m, m.last_driver, launches.moved(before))
    (mc, dc, lc), (me, de, le) = runs[True], runs[False]
    assert dc.sharding == de.sharding == mode
    assert dc.calls >= 3 and dc.replays == dc.calls - 1, (dc.calls,
                                                         dc.replays)
    assert de.replays == 0 and de.calls == dc.calls
    assert lc == le and lc.get(kernel, 0) > 0, (lc, le)
    assert (dc.comm.calls, dc.comm.bytes) == (de.comm.calls, de.comm.bytes)
    assert dc.comm.calls > 0
    assert dc.comm.seconds is None and de.comm.seconds > 0
    assert torch.equal(dc.gen.get_state(), de.gen.get_state())
    for k, v in me.state.items():
        np.testing.assert_allclose(full_table(mc.state[k]).cpu().numpy(),
                                   full_table(v).cpu().numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


@pytest.mark.gpu
def test_row_shard_add_captured_alone_matches_the_boolean_form(cuda):
    """``RowShard``'s masked add of a 32,768-id batch into rows 1536:2048
    of 4,096 (seven ids in eight unowned), captured into a CUDA graph
    after one eager call and replayed: the shard as the boolean-index form
    leaves it after two adds."""
    from smore_tpu_torch.parallel.mesh import CommStats, RowShard

    rng = np.random.default_rng(0)
    n_rows, lo, rows, B, D = 4096, 1536, 512, 32768, 64
    local = torch.from_numpy(rng.standard_normal((rows, D)).astype(
        np.float32)).to(cuda)
    idx = torch.from_numpy(rng.integers(0, n_rows, B)).to(cuda)
    delta = torch.from_numpy(rng.standard_normal((B, D)).astype(
        np.float32)).to(cuda)
    shard = RowShard(local.clone(), n_rows, lo, CommStats())
    shard.index_add_(0, idx, delta)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        shard.index_add_(0, idx, delta)
    graph.replay()
    owned = (idx >= lo) & (idx < lo + rows)
    want = local.clone()
    for _ in range(2):
        want.index_add_(0, idx[owned] - lo, delta[owned])
    torch.cuda.synchronize()
    np.testing.assert_allclose(shard.local.cpu().numpy(),
                               want.cpu().numpy(), rtol=RTOL, atol=ATOL)


# ------------------------- the models with loops of their own (CUDA graph)
# A captured SASRec-family run against the eager one: the same kernels on
# the same inputs, each call's cuBLAS products and reductions in the same
# order, so the same f32 round-off bound as the tables'.
SEQ_RTOL, SEQ_ATOL = 1e-4, 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("steps", [None, "chunk"])
@pytest.mark.parametrize("name", OWN_LOOP)
def test_own_loop_captured_calls_match_eager_calls(cuda, name, steps,
                                                   tmp_path):
    """Each model with a loop of its own, 2 epochs from one seed, its calls
    (an epoch, or OWN_LOOP_CHUNK steps and a shorter last one) captured
    and replayed against ``capture=False``: the first call eager and every
    later one a replay; equal generator states; the tables within rtol
    1e-4 / atol 1e-5 (SASRec family: SEQ_RTOL / SEQ_ATOL); no kernel
    launched."""
    from smore_tpu_torch.ops import launches

    runs = {}
    for capture in (True, False):
        m, kw = build_own_loop(name, cuda, str(tmp_path), epochs=2,
                               steps_per_call=OWN_LOOP_CHUNK[name]
                               if steps else None)
        m.capture = capture
        before = launches.read()
        m.train(**kw)
        torch.cuda.synchronize()
        runs[capture] = (m, m.last_calls, launches.moved(before))
    (mc, cc, lc), (me, ce, le) = runs[True], runs[False]
    assert cc.calls >= 2 and cc.replays == cc.calls - 1, (cc.calls,
                                                         cc.replays)
    assert ce.replays == 0 and ce.calls == cc.calls
    assert lc == le == {}
    assert torch.equal(cc.gen.get_state(), ce.gen.get_state())
    rtol, atol = (SEQ_RTOL, SEQ_ATOL) if name in SEQ else (RTOL, ATOL)
    got = own_loop_state(mc)
    for k, v in own_loop_state(me).items():
        assert got[k].device.type == "cuda"
        np.testing.assert_allclose(got[k].cpu().numpy(), v.cpu().numpy(),
                                   rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.gpu
@pytest.mark.parametrize("name", SEQ)
def test_seq_adam_is_capturable_and_resumes_on_the_card(cuda, name,
                                                        tmp_path,
                                                        monkeypatch):
    """On the card the SASRec family's Adam is ``capturable`` (captured or
    not), and a resumed run's Adam step counts are on the card; the
    resumed run replays its later epochs."""
    from smore_tpu_torch import models

    cls = getattr(models, name)
    made, loaded = [], []
    orig_make = cls.make_optimizer

    def spy_make(self, *a, **k):
        made.append(orig_make(self, *a, **k))
        return made[-1]

    orig_load = torch.optim.Optimizer.load_state_dict

    def spy_load(self, sd):
        orig_load(self, sd)
        loaded.extend(s["step"] for s in self.state.values())

    monkeypatch.setattr(cls, "make_optimizer", spy_make)
    monkeypatch.setattr(torch.optim.Optimizer, "load_state_dict", spy_load)
    ck = str(tmp_path / "ck")
    m, kw = build_own_loop(name, cuda, str(tmp_path), epochs=2)
    m.train(checkpoint=ck, **kw)
    m2, kw = build_own_loop(name, cuda, str(tmp_path), epochs=4)
    m2.train(checkpoint=ck, **kw)
    assert all(o.defaults["capturable"] for o in made) and len(made) == 2
    assert loaded and all(t.device.type == "cuda" for t in loaded)
    c = m2.last_calls
    assert c.calls == 2 and c.replays == 1
    for k, v in own_loop_state(m2).items():
        assert bool(torch.isfinite(v).all()), k


@pytest.mark.gpu
@pytest.mark.parametrize("name", SEQ)
def test_seq_adam_on_the_card_is_optax_adam(cuda, name, tmp_path):
    """The card's update (``make_optimizer``: capturable, its bias
    corrections on the card and eps folded into its step size) against
    ``optax_adam``, optax.adam's formula (held to optax.adam itself in
    tests/test_torch_sasrec.py), as test_torch_sasrec.py's
    test_two_adam_steps holds the CPU's: two steps fed the same gradients
    (the CPU port's, which that file holds to JAX's), then the port's own
    step on the card from its own gradients, at atol 1e-3 * alpha. The
    card's gradients agree with the CPU's at that file's gradient
    tolerance; an entry that is float noise on either (the key bias, which
    the softmax cancels: exactly 0 on one, ~1e-10 on the other) makes a
    step of up to alpha and is left out of the own step's check."""
    from smore_tpu_torch import models

    alpha, k = 0.01, 3
    cls = getattr(models, name)
    path = seq_edges(str(tmp_path / "seq.txt"))

    def model(device):
        m = cls.load_edge_list(path, seed=0, negative_samples=k,
                               device=device)
        m.init(dim=16, max_seq_len=8, num_blocks=2, num_heads=2,
               dropout=0.0)
        return m

    m = model("cpu")
    batch = m.build_sequences()
    rng = np.random.default_rng(4)
    negs = rng.integers(0, m.graph.n_vertices, (len(batch), 8, k))
    us = [rng.uniform(1e-6, 1 - 1e-6, (2, 8, 8)).astype(np.float32)
          for _ in range(2)]

    def loss(m, device):
        return m.loss_fn(torch.from_numpy(batch).long().to(device),
                         negs=torch.from_numpy(negs).long().to(device),
                         gumbel_u=[torch.from_numpy(u).to(device)
                                   for u in us])

    params = {n: p.detach().numpy().copy()
              for n, p in m.net.named_parameters()}
    loss(m, "cpu").backward()
    grads = {n: p.grad.numpy() for n, p in m.net.named_parameters()}
    for steps in (2, 1):
        mc = model(cuda)
        mc.net.load_state_dict(m.net.state_dict())
        opt = mc.make_optimizer(alpha)
        assert opt.defaults["capturable"]
        if steps == 2:  # fed the CPU's gradients
            for _ in range(steps):
                for n, p in mc.net.named_parameters():
                    p.grad = torch.from_numpy(grads[n]).to(cuda)
                opt.step()
        else:  # the port's own step on the card
            loss(mc, cuda).backward()
            own = {n: p.grad.cpu().numpy()
                   for n, p in mc.net.named_parameters()}
            for n, g in own.items():
                np.testing.assert_allclose(g, grads[n], rtol=1e-4,
                                           atol=1e-6, err_msg=n)
            opt.step()
        want = optax_adam(params, grads, alpha, steps)
        for n, p in mc.net.named_parameters():
            got = p.detach().cpu().numpy()
            solid = np.ones(got.shape, bool)
            if steps == 1:
                g, gc = np.abs(grads[n]), np.abs(own[n])
                solid = (np.minimum(g, gc) > 1e3 * 1e-8) | (g + gc == 0)
            np.testing.assert_allclose(got[solid], want[n][solid], rtol=0,
                                       atol=1e-3 * alpha,
                                       err_msg=f"{n}, {steps} step(s)")


# ------------------------------------------------------------- the tracer
@pytest.fixture
def tracer():
    from smore_tpu_torch.utils import profiling

    profiling.disable()
    profiling.reset()
    yield profiling
    profiling.disable()
    profiling.reset()


@pytest.mark.gpu
def test_a_stamp_eager_and_captured(cuda, tracer):
    """The stamp writes (code, the card's ns) when the stream reaches it:
    eagerly, and on each replay of a graph that captured it (the capture
    itself writes nothing); the anchor maps the card's clock onto the
    host's."""
    import time

    tracer.enable()
    ring = tracer._ring(cuda)
    ring.cursor.zero_()
    code = tracer._code("probe")
    ring.stamp(code << 1)
    torch.cuda.synchronize()
    assert int(ring.cursor.item()) == 1
    c0, t0 = ring.records[0].tolist()
    assert c0 == code << 1 and t0 > 0
    g = torch.cuda.CUDAGraph()
    x = torch.zeros(1, device=cuda)
    with torch.cuda.graph(g):
        ring.stamp(code << 1)
        x += 1
        ring.stamp(code << 1 | 1)
    torch.cuda.synchronize()
    assert int(ring.cursor.item()) == 1
    for _ in range(3):
        g.replay()
    torch.cuda.synchronize()
    assert int(ring.cursor.item()) == 7 and float(x) == 3.0
    rec = ring.records[:7].cpu().numpy()
    assert rec[1:, 0].tolist() == [code << 1, code << 1 | 1] * 3
    assert (np.diff(rec[:, 1]) >= 0).all() and rec[-1, 1] > t0
    host, card = ring.anchor()
    torch.cuda.synchronize()
    h0 = time.perf_counter_ns()
    ring.stamp(code << 1)
    torch.cuda.synchronize()
    h1 = time.perf_counter_ns()
    at = int(ring.records[7, 1]) - card + host
    assert h0 - 1_000_000 < at < h1 + 1_000_000


_TRACED = {
    "line_multiblock": {"line.draw", "line.snapshot", "line.k4",
                        "line.neg_add"},
    "line_unbanded_g8": {"line.draw", "line.update"},
    "DeepWalk": {"walk.draw", "walk.starts", "walk.walk", "walk.pairs",
                 "walk.negatives", "walk.update"},
    "Node2Vec": {"walk.draw", "walk.starts", "walk.walk", "walk.pairs",
                 "walk.negatives", "walk.update"},
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(_TRACED))
def test_every_replay_writes_its_stamps(cuda, tracer, case, tmp_path):
    """Each call, the eager first one and every replay of the captured
    graph, writes its first and last node's stamps and its first step's
    segments, in the card's order, none dropped."""
    tracer.enable()
    m, kw = build_case(case, cuda, str(tmp_path))
    m.train(**kw)
    d = m.last_driver
    g = tracer.groups()[-1]
    calls = tracer.calls(g)
    assert d.replays == d.calls - 1 >= 2 and len(calls) == d.calls
    per_call = 4 + 2 * len(_TRACED[case])  # call, step, the segments
    assert per_call <= tracer.MAX_STAMPS
    assert g.counters["stamps_written"] == per_call * d.calls
    assert g.counters["stamps_dropped"] == 0
    for c in calls:
        assert set(c.seg) == _TRACED[case] | {"step"}
    assert all(a.t1 <= b.t0 for a, b in zip(calls, calls[1:]))
    assert len(tracer.replays(g)) == d.replays


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(_TRACED))
def test_a_steps_segments_fit_in_its_call(cuda, tracer, case, tmp_path):
    """In every replay: the segments directly inside the step sum to at
    most the step, a segment inside another to at most that one, and the
    step lasts at most its call."""
    tracer.enable()
    m, kw = build_case(case, cuda, str(tmp_path))
    m.train(**kw)
    g = tracer.groups()[-1]
    for c in tracer.replays(g):
        inner = defaultdict(int)
        for k, parent in c.parent.items():
            if parent is not None:
                inner[parent] += c.seg[k]
        assert 0 < c.seg["step"] <= c.t1 - c.t0
        for parent, total in inner.items():
            assert total <= c.seg[parent], (parent, dict(c.seg))
    assert 0 < tracer.coverage_pct(g) <= 100


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(_TRACED))
def test_graphs_captured_with_the_tracer_off_hold_no_stamp(cuda, tracer,
                                                           case, tmp_path):
    """With the tracer off a captured graph has the node count and launch
    credit it has without the tracer (before it was on and after); on,
    it holds one call's stamps more and the same kernel launches."""

    def run():
        m, kw = build_case(case, cuda, str(tmp_path))
        m.train(**kw)
        loop = m.last_driver.loop
        return (dict(loop.nodes),
                {k: sorted((kern.name, n) for kern, n in c)
                 for k, c in loop._credit.items()})

    off = run()
    tracer.enable()
    on = run()
    g = tracer.groups()[-1]
    tracer.disable()
    assert run() == off
    per_call = g.counters["stamps_written"] // g.info["calls"]
    assert per_call == 4 + 2 * len(_TRACED[case])
    assert on[0] == {k: v + per_call for k, v in off[0].items()}
    assert on[1] == off[1]
