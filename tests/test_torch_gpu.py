"""The port's CUDA kernels on the card, against their PyTorch twins.

Needs a CUDA card and nvcc; skipped elsewhere. This file imports neither JAX
nor smore_tpu, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch

from smore_tpu_torch.graph.graph import Graph
from smore_tpu_torch.models.line import LINE
from smore_tpu_torch.ops.scatter import band_scatter_add, band_scatter_add_ref
from smore_tpu_torch.ops.sgns import sgns_shared_grads, sgns_shared_grads_ref
from smore_tpu_torch.ops.sgns_banded import (
    sgns_banded_fused,
    sgns_banded_fused_ref,
    sgns_banded_multiblock,
    sgns_banded_multiblock_nb,
    sgns_banded_multiblock_nb_ref,
    sgns_banded_multiblock_ref,
)
from torch_superstep_inputs import (
    ALL_COLLIDE,
    ALL_COLLIDE_FUSED,
    ALL_COLLIDE_NB,
    fused_inputs,
    multiblock_inputs,
    multiblock_nb_inputs,
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
    before = sgns_banded_multiblock.launches
    kv, kc, kd, kl = sgns_banded_multiblock(*(a[k] for k in _ARGS),
                                            band_size=c["band"])
    assert sgns_banded_multiblock.launches == before + 1
    assert kv is a["wv"] and kc is a["wc"]
    rv, rc, rd, rl = sgns_banded_multiblock_ref(*(b[k] for k in _ARGS),
                                                band_size=c["band"])
    torch.cuda.synchronize()
    for got, want in ((kv, rv), (kc, rc), (kd, rd)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(kl), float(rl), rtol=RTOL)
    assert not np.allclose(kv.cpu().numpy(), x["wv"])


def _toy_graph():
    """The 200-vertex 4-community graph of tests/test_torch_line_slice.py."""
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
    return Graph.from_edges(edges, undirected=True)


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
    g = _toy_graph()
    m = LINE(g, seed=0, device=cuda)
    m.init(dim=64, order=2)
    before = sgns_banded_multiblock.launches
    m.train(banded=True, band_size=64, batch=128, hoist=4, sample_times=0.2,
            steps_per_call=32, verbose=False)
    assert sgns_banded_multiblock.launches > before
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
    before = sgns_shared_grads.launches
    got = sgns_shared_grads(v, cp, cn, alpha, k_equiv=5)
    assert sgns_shared_grads.launches == before + 1
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
    g = _toy_graph()
    m = LINE(g, seed=0, device=cuda)
    m.init(dim=64, order=order)
    before = sgns_shared_grads.launches
    m.train(sample_times=0.2, batch=128, use_pallas=True, verbose=False)
    assert m.banded_tables is None and m.last_driver.micro_steps == 32
    assert sgns_shared_grads.launches > before
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
    before = sgns_banded_fused.launches
    kv, kc, kd, kl = sgns_banded_fused(*(a[k] for k in args))
    assert sgns_banded_fused.launches == before + 1
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
    before = band_scatter_add.launches
    got = band_scatter_add(table, start, idx, delta)
    assert got is table and band_scatter_add.launches == before + 1
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-5, atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("order,kw,counter", [
    (2, dict(multiband=False, use_pallas=True), sgns_banded_fused),
    (1, {}, band_scatter_add),
])
def test_line_banded_routes_train_through_k3_k2(cuda, order, kw, counter):
    """On a CUDA device LINE o2 with multiband=False, use_pallas=True takes
    the fused route (K3), and banded order 1 ("auto") the scatter-only
    route (K2); both learn the communities."""
    g = _toy_graph()
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
    before = sgns_banded_multiblock_nb.launches
    kv, kc, kl = sgns_banded_multiblock_nb(*(a[k] for k in args),
                                           band_size=band, nb2=nb2)
    assert sgns_banded_multiblock_nb.launches == before + 1
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
    (dict(neg_band=True), sgns_banded_multiblock_nb),
    (dict(multiband=False, band_hold=True, hoist=4), sgns_banded_fused),
    (dict(multiband=False, band_hold=True, hoist=4, use_pallas="scatter"),
     band_scatter_add),
])
def test_line_neg_band_and_band_hold_train(cuda, kw, counter):
    """On a CUDA device LINE o2 with neg_band=True takes the multiblock
    route with banded negatives (K5, not K4); band_hold=True off it holds
    one stratum per block, through K3 ("auto") or K2 ("scatter"). Each
    learns the communities."""
    g = _toy_graph()
    m = LINE(g, seed=0, device=cuda)
    m.init(dim=64, order=2)
    before = counter.launches, sgns_banded_multiblock.launches
    m.train(banded=True, band_size=64, batch=128, sample_times=0.2,
            steps_per_call=32, verbose=False, **kw)
    assert counter.launches > before[0]
    if counter is sgns_banded_multiblock_nb:
        assert sgns_banded_multiblock.launches == before[1]
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
