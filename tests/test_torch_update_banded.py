"""The banded SGNS step: the port's ``sgns_shared_negs_step_banded`` against
smore_tpu's on identical (band starts, src, pos, negs); and the held
route's ``sgns_banded_block`` against smore_tpu's on identical blocks, in
its plain, grouped, scatter-only (K2) and fused (K3) forms, with negatives
in and out of the context band and duplicated, so that the documented
deviation (out-of-band negatives read the block-start table and apply at
block end; every negative does in the fused form) is held too.

Order 1 (one table, 1D strata: sources anywhere) and order 2 (2D strata:
sources in their own band), source groups 1 and 4, the plain XLA-style
scatters and the scatter kernel K2 (``pallas_scatter``), and the fused
kernel K3 (order 2, group 1) at one and two tiles. smore_tpu runs its
Pallas kernels in interpret mode; the port runs their twins. Tables within
rtol 2e-5, atol 1e-6 (f32 on both sides, sums in another order); each loss
by its own convention (the unfused mean over the first min(1024, B) rows,
the fused sum over all rows / B)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smore_tpu.ops.update import sgns_banded_block as jax_block
from smore_tpu.ops.update import sgns_shared_negs_step_banded as jax_step
from smore_tpu_torch.ops.update import (
    sgns_banded_block,
    sgns_shared_negs_step_banded,
)

# one intra-op thread: test workers share the cores, and a thread pool
# in each of them oversubscribes the CPU on these tiny shapes
torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 1e-6
BAND, N_BANDS, D, KS = 64, 4, 32, 16


def _inputs(seed, order, B, group, sb=1, db=2):
    rng = np.random.default_rng(seed)
    n = BAND * N_BANDS
    lo = sb * BAND if order == 2 else 0
    hi = lo + BAND if order == 2 else n
    src = rng.integers(lo, hi, B // group).repeat(group)
    # a hot range inside the band: duplicate context rows
    pos = db * BAND + np.where(rng.random(B) < 0.3, rng.integers(0, 4, B),
                               rng.integers(0, BAND, B))
    # negatives anywhere, in-band rows included
    negs = rng.integers(0, n, KS)
    tables = {"vertex": (rng.standard_normal((n, D)) * 0.1)}
    if order == 2:
        tables["context"] = rng.standard_normal((n, D)) * 0.1
    return dict(tables={k: v.astype(np.float32) for k, v in tables.items()},
                sb=np.int32(sb * BAND), db=np.int32(db * BAND),
                src=src.astype(np.int32), pos=pos.astype(np.int32),
                negs=negs.astype(np.int32), alpha=np.float32(0.05))


def _run(step, x, order, group, wrap, **kw):
    t = {k: wrap(v) for k, v in x["tables"].items()}
    wv = t["vertex"]
    wc = t["context"] if order == 2 else wv
    extra = (dict(shared_table=True) if order == 1
             else dict(src_band_start=wrap(x["sb"])))
    wv, wc, loss = step(wv, wc, wrap(x["db"]), BAND, wrap(x["src"]),
                        wrap(x["pos"]), wrap(x["negs"]), wrap(x["alpha"]),
                        k_equiv=5, src_group=group, **extra, **kw)
    out = {"vertex": np.asarray(wv)}
    if order == 2:
        out["context"] = np.asarray(wc)
    return out, float(loss)


CASES = {
    **{f"o{o}_g{g}_{'k2' if p else 'plain'}": dict(order=o, group=g, B=512,
                                                    pallas_scatter=p)
       for o in (1, 2) for g in (1, 4) for p in (False, True)},
    "o2_fused_b128": dict(order=2, group=1, B=128, fused=True),
    "o2_fused_b4096_two_tiles": dict(order=2, group=1, B=4096, fused=True),
    "o2_sb_eq_db_k2": dict(order=2, group=4, B=2048, pallas_scatter=True,
                           sb=3, db=3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_matches_jax(case):
    c = dict(CASES[case])
    order, group, B = c.pop("order"), c.pop("group"), c.pop("B")
    bands = {k: c.pop(k) for k in ("sb", "db") if k in c}
    x = _inputs(len(case), order, B, group, **bands)
    want, jl = _run(jax_step, x, order, group, jnp.asarray, **c)
    got, tl = _run(sgns_shared_negs_step_banded, x, order, group,
                   lambda a: torch.from_numpy(np.array(a)), **c)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
        assert not np.allclose(got[k], x["tables"][k])
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kw,match", [
    (dict(fused=True, shared_table=True), "2D two-table"),
    (dict(fused=True, src_group=4), "ungrouped"),
    (dict(shared_table=True), "order 1 uses 1D"),
])
def test_invalid_combinations_raise(kw, match):
    """smore_tpu asserts these; the port raises ValueError."""
    x = _inputs(0, 2, 128, 4)
    t = {k: torch.from_numpy(v) for k, v in x["tables"].items()}
    with pytest.raises(ValueError, match=match):
        sgns_shared_negs_step_banded(
            t["vertex"], t["context"], torch.tensor(x["db"]), BAND,
            torch.from_numpy(x["src"]), torch.from_numpy(x["pos"]),
            torch.from_numpy(x["negs"]), 0.05,
            src_band_start=torch.tensor(x["sb"]), **kw)


# ------------------------------------------------------- held blocks
def _block_inputs(seed, S, B, group, sb=1, db=2):
    rng = np.random.default_rng(seed)
    n = BAND * N_BANDS
    src = (sb * BAND + rng.integers(0, BAND, (S, B // group))).repeat(
        group, axis=1)
    pos = db * BAND + np.where(rng.random((S, B)) < 0.3,
                               rng.integers(0, 4, (S, B)),
                               rng.integers(0, BAND, (S, B)))
    # half in the context band, half anywhere (in-band rows too), with a
    # hot row in and out of the band: duplicates within and across steps
    negs = np.where(rng.random((S, KS)) < 0.5,
                    db * BAND + rng.integers(0, BAND, (S, KS)),
                    rng.integers(0, n, (S, KS)))
    negs[:, :2] = db * BAND + 5
    negs[:, 2:4] = 3
    return dict(
        wv=(rng.standard_normal((n, D)) * 0.1).astype(np.float32),
        wc=(rng.standard_normal((n, D)) * 0.1).astype(np.float32),
        sb=np.int32(sb * BAND), db=np.int32(db * BAND),
        src=src.astype(np.int32), pos=pos.astype(np.int32),
        negs=negs.astype(np.int32),
        alphas=np.linspace(0.05, 0.03, S).astype(np.float32))


BLOCK_CASES = {
    "plain_g1": dict(B=512, group=1),
    "plain_g4": dict(B=512, group=4),
    "k2_g1": dict(B=512, group=1, pallas_scatter=True),
    "k2_g4": dict(B=512, group=4, pallas_scatter=True),
    "fused_b128": dict(B=128, group=1, fused=True),
    "fused_b4096_two_tiles": dict(B=4096, group=1, fused=True),
}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_block_matches_jax(case):
    c = dict(BLOCK_CASES[case])
    B, group = c.pop("B"), c.pop("group")
    x = _block_inputs(len(case), 3, B, group)
    args = ("wv", "wc", "sb", "db")

    def run(fn, wrap):
        wv, wc, sb, db = (wrap(x[k]) for k in args)
        wv, wc, loss = fn(wv, wc, sb, db, BAND, wrap(x["src"]),
                          wrap(x["pos"]), wrap(x["negs"]),
                          wrap(x["alphas"]), k_equiv=5, src_group=group,
                          **c)
        return np.asarray(wv), np.asarray(wc), float(loss)

    want = run(jax_block, jnp.asarray)
    got = run(sgns_banded_block, lambda a: torch.from_numpy(np.array(a)))
    for g, w, name in zip(got[:2], want[:2], ("vertex", "context")):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=name)
    np.testing.assert_allclose(got[2], want[2], rtol=RTOL, atol=ATOL)
    assert not np.allclose(got[1], x["wc"])
    # out-of-band negative rows moved (their deltas, applied at block end)
    out = x["negs"][(x["negs"] < x["db"]) | (x["negs"] >= x["db"] + BAND)]
    assert not np.allclose(got[1][out], x["wc"][out])


def test_fused_block_rejects_groups():
    x = _block_inputs(0, 2, 128, 4)
    t = {k: torch.from_numpy(np.array(v)) for k, v in x.items()}
    with pytest.raises(ValueError, match="ungrouped"):
        sgns_banded_block(t["wv"], t["wc"], t["sb"], t["db"], BAND, t["src"],
                          t["pos"], t["negs"], t["alphas"], src_group=4,
                          fused=True)
