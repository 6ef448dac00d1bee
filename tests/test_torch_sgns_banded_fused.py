"""Kernel K3 (fused banded SGNS micro-step): the port's plain twin against
smore_tpu's Pallas ``sgns_banded_fused`` in interpret mode, on the same
numpy inputs. The CUDA kernel is held to the same twin on the card by
tests/test_torch_gpu.py.

smore_tpu's kernel takes the two band slices; the port takes the whole
tables and the band start rows. Bands and d_neg within rtol 2e-5, atol
1e-6, the loss sum within rtol 1e-5: f32 on both sides, differing only in
the order of the dot-product and matmul sums."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smore_tpu.ops.pallas_sgns_banded import sgns_banded_fused as jax_fused
from smore_tpu_torch.ops.sgns_banded import K3, sgns_banded_fused
from torch_superstep_inputs import ALL_COLLIDE_FUSED, fused_inputs

# one intra-op thread: test workers share the cores, and a thread pool
# in each of them oversubscribes the CPU on these tiny shapes
torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 1e-6
N_BANDS = 3


def _inputs(seed, Nb, D, Ks, B, sb, db, idx_hi=None, alpha=0.05):
    return fused_inputs(seed, B, Nb, N_BANDS, Ks, D, sb, db, idx_hi, alpha)


def _collide_case():
    c = dict(ALL_COLLIDE_FUSED)
    assert c.pop("n_bands") == N_BANDS
    c["Nb"] = c.pop("band")
    return c


CASES = {
    "nb64_d64_ks16_b128": dict(seed=0, Nb=64, D=64, Ks=16, B=128, sb=1,
                               db=2),
    # two 2048-row tiles, 16 rows per side: heavy duplicates; the second
    # tile gathers the first tile's writes
    "nb64_d16_ks16_b4096_two_tiles": dict(seed=1, Nb=64, D=16, Ks=16,
                                          B=4096, sb=0, db=2, idx_hi=16),
    "nb200_d32_ks40_b2048": dict(seed=2, Nb=200, D=32, Ks=40, B=2048, sb=2,
                                 db=2),
    # three 2048-row tiles in order, each gathering the earlier ones' writes
    "nb64_d16_ks16_b6144_three_tiles": dict(seed=4, Nb=64, D=16, Ks=16,
                                            B=6144, sb=1, db=0, idx_hi=24),
    # one tile under 2048 rows, a ragged Ks
    "nb96_d32_ks37_b640": dict(seed=5, Nb=96, D=32, Ks=37, B=640, sb=0,
                               db=1),
    # every source and positive row one vertex: the card test holds the
    # CUDA kernel to these inputs too
    "all_collide_b4096": _collide_case(),
}


def _torch(x):
    return {k: torch.from_numpy(np.array(v)) for k, v in x.items()}


def _port(t):
    return sgns_banded_fused(t["wv"], t["wc"], t["sb"], t["db"], t["src_l"],
                             t["pos_l"], t["cn"], t["alpha"], k_equiv=5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_twin_matches_pallas_kernel(case):
    c = CASES[case]
    x = _inputs(**c)
    Nb, sb, db = c["Nb"], int(x["sb"]), int(x["db"])
    jv, jc, jd, jl = jax_fused(
        jnp.asarray(x["wv"][sb:sb + Nb]), jnp.asarray(x["wc"][db:db + Nb]),
        jnp.asarray(x["src_l"]), jnp.asarray(x["pos_l"]),
        jnp.asarray(x["cn"]), jnp.asarray(x["alpha"]), k_equiv=5,
        interpret=True,
    )
    t = _torch(x)
    before = K3.launches
    tv, tc, td, tl = _port(t)
    assert K3.launches == before  # CPU: twin, no kernel
    assert tv is t["wv"] and tc is t["wc"]  # updated in place
    for got, want, start, name in ((tv, jv, sb, "wv"), (tc, jc, db, "wc")):
        got = got.numpy()
        np.testing.assert_allclose(got[start:start + Nb], np.asarray(want),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
        rest = np.ones(len(got), bool)
        rest[start:start + Nb] = False
        assert np.array_equal(got[rest], x[name][rest]), name
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


def _whole_batch_gather(x):
    """The same micro-step with every row gathered before any scatter (the
    unfused step's order): what K3 must NOT compute when B > 2048."""
    wv, wc = x["wv"].astype(np.float64), x["wc"].astype(np.float64)
    rv = int(x["sb"]) + x["src_l"]
    rc = int(x["db"]) + x["pos_l"]
    v, cp, cn = wv[rv], wc[rc], x["cn"].astype(np.float64)
    a = float(x["alpha"])
    g_pos = (1 - 1 / (1 + np.exp(-(v * cp).sum(1)))) * a
    g_neg = -1 / (1 + np.exp(-(v @ cn.T))) * a * 5 / len(cn)
    np.add.at(wv, rv, g_pos[:, None] * cp + g_neg @ cn)
    np.add.at(wc, rc, g_pos[:, None] * v)
    return wv, wc


def test_tile_order_is_kept():
    """At B=4096 the second tile sees the first tile's writes: the twin
    differs from a whole-batch gather far beyond f32 round-off."""
    x = _inputs(**CASES["nb64_d16_ks16_b4096_two_tiles"])
    tv, tc, _, _ = _port(_torch(x))
    wv, wc = _whole_batch_gather(x)
    diff = max(np.abs(tv.numpy() - wv).max(), np.abs(tc.numpy() - wc).max())
    assert diff > 1e-3, diff


def _args(B=128, D=16, dtype=torch.float32, device="cpu", src_shape=None):
    f = dict(dtype=dtype, device=device)
    i = dict(dtype=torch.int32, device=device)
    return (torch.zeros(64, D, **f), torch.zeros(64, D, **f),
            torch.zeros((), **i), torch.zeros((), **i),
            torch.zeros(src_shape or (B,), **i), torch.zeros(B, **i),
            torch.zeros(8, D, **f), torch.tensor(0.05, device=device))


@pytest.mark.parametrize("case,match", [
    ("b100", "tile"),  # the TPU kernel's asserts
    ("b4100", "tile"),
    ("float64", "float32"),
    ("src_2d", r"\(B,\)"),
    ("meta", "no kernel"),
])
def test_check_rejects(case, match):
    args = {
        "b100": lambda: _args(B=100),
        "b4100": lambda: _args(B=4100),
        "float64": lambda: _args(dtype=torch.float64),
        "src_2d": lambda: _args(src_shape=(1, 128)),
        "meta": lambda: _args(device="meta"),
    }[case]()
    with pytest.raises(ValueError, match=match):
        sgns_banded_fused(*args)
