"""The port's SGNS update core against smore_tpu.ops.update.

The same numpy tables, indices (with duplicate rows), masks and rates go
to both; the port updates its tables in place, smore_tpu returns new ones.
Tables and loss agree within rtol 1e-5, atol 1e-6: f32 on both sides,
differing only in the order of sums (index_add_ against XLA's scatter,
torch's matmul against XLA's dot).

smore_tpu's ``use_pallas=True`` route calls its Pallas kernel without
interpret mode, which the CPU backend refuses, so the port's
``use_pallas=True`` (its K1 twin on the CPU) is held against smore_tpu's
``use_pallas=False``: the same math."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smore_tpu.ops import update as J
from smore_tpu_torch.ops import update as T
from smore_tpu_torch.ops.sgns import K1

# one intra-op thread: test workers share the cores, and a thread pool
# in each of them oversubscribes the CPU on these tiny shapes
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
N, D = 300, 16


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _tables(seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(N, D)) * 0.3).astype(np.float32)
            for _ in range(2)]


def _idx(rng, *shape, hi=N):
    # a narrow range for part of the draws: duplicate rows in every batch
    x = rng.integers(0, hi, shape)
    hot = rng.random(shape) < 0.3
    return np.where(hot, rng.integers(0, 8, shape), x).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("collision,weighted", [("sum", False),
                                                ("mean", False),
                                                ("mean", True)])
def test_scatter_apply(collision, weighted):
    rng = np.random.default_rng(1)
    w = _tables(1)[0]
    i1, i2 = _idx(rng, 64), _idx(rng, 40)
    d1 = rng.normal(size=(64, D)).astype(np.float32)
    d2 = rng.normal(size=(40, D)).astype(np.float32)
    cw = (rng.random(64) < 0.7).astype(np.float32) if weighted else None
    want = J.scatter_apply(jnp.asarray(w), [(i1, d1, cw), (i2, d2)],
                           collision)
    tw = _t(w)
    got = T.scatter_apply(tw, [(_t(i1), _t(d1), None if cw is None
                                else _t(cw)), (_t(i2), _t(d2))], collision)
    assert got is tw  # in place
    _close(got, want)


@pytest.mark.parametrize("shared,update_vertex,collision", [
    (False, True, "sum"), (False, False, "sum"), (True, True, "mean"),
    (True, False, "sum")])
def test_apply_two_tables(shared, update_vertex, collision):
    rng = np.random.default_rng(4)
    wv, wc = _tables(4)
    i1, i2 = _idx(rng, 64), _idx(rng, 48)
    d1 = rng.normal(size=(64, D)).astype(np.float32)
    d2 = rng.normal(size=(48, D)).astype(np.float32)
    jv, jc = jnp.asarray(wv), jnp.asarray(wv if shared else wc)
    jv, jc = J.apply_two_tables(jv, jc, [(i1, d1)], [(i2, d2)],
                                shared_table=shared,
                                update_vertex=update_vertex,
                                collision=collision)
    tv = _t(wv)
    tc = tv if shared else _t(wc)
    gv, gc = T.apply_two_tables(tv, tc, [(_t(i1), _t(d1))],
                                [(_t(i2), _t(d2))], shared_table=shared,
                                update_vertex=update_vertex,
                                collision=collision)
    assert gv is tv and gc is tc
    _close(gv, jv)
    _close(gc, jc)


STEP_CASES = {
    "plain": {},
    "mask": dict(mask=True),
    "reg": dict(reg=0.01),
    "mask_reg": dict(mask=True, reg=0.01),
    "freeze_vertex": dict(update_vertex=False),
    "mean": dict(collision="mean"),
    "mean_mask": dict(collision="mean", mask=True),
}


def _mask(rng, B):
    return (rng.random(B) < 0.8).astype(np.float32)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_sgns_step(case):
    kw = dict(STEP_CASES[case])
    rng = np.random.default_rng(2)
    wv, wc = _tables(2)
    B, K = 128, 5
    src, pos, negs = _idx(rng, B), _idx(rng, B), _idx(rng, B, K)
    mask = _mask(rng, B) if kw.pop("mask", False) else None
    a = np.float32(0.05)
    jv, jc, jl = J.sgns_step(jnp.asarray(wv), jnp.asarray(wc), src, pos,
                             negs, a, mask=mask, **kw)
    tv, tc = _t(wv), _t(wc)
    gv, gc, gl = T.sgns_step(tv, tc, _t(src), _t(pos), _t(negs),
                             torch.tensor(a),
                             mask=None if mask is None else _t(mask), **kw)
    assert gv is tv and gc is tc
    _close(gv, jv)
    _close(gc, jc)
    _close(gl, jl)


@pytest.mark.parametrize("case", ["plain", "mask", "mean"])
def test_sgns_step_shared(case):
    kw = dict(STEP_CASES[case])
    rng = np.random.default_rng(3)
    w = _tables(3)[0]
    B, K = 128, 5
    src, pos, negs = _idx(rng, B), _idx(rng, B), _idx(rng, B, K)
    mask = _mask(rng, B) if kw.pop("mask", False) else None
    a = np.float32(0.05)
    jw, jl = J.sgns_step_shared(jnp.asarray(w), src, pos, negs, a,
                                mask=mask, **kw)
    gw, gl = T.sgns_step_shared(_t(w), _t(src), _t(pos), _t(negs),
                                torch.tensor(a),
                                mask=None if mask is None else _t(mask),
                                **kw)
    _close(gw, jw)
    _close(gl, jl)


SHARED_CASES = {
    **{f"o{o}_g{g}_{'k1' if p else 'plain'}": dict(order=o, group=g,
                                                    use_pallas=p)
       for o in (1, 2) for g in (1, 8) for p in (False, True)},
    "o2_b2048_k1": dict(order=2, group=8, use_pallas=True, B=2048),
    "o2_b2048_plain": dict(order=2, group=1, B=2048),
    "o2_mask": dict(order=2, mask=True, use_pallas=True),
    "o2_g8_mask": dict(order=2, group=8, mask=True),
    "o2_reg": dict(order=2, reg=0.01, use_pallas=True),
    "o2_mask_reg": dict(order=2, mask=True, reg=0.01),
    "o2_freeze_vertex": dict(order=2, update_vertex=False, use_pallas=True),
    "o2_mean": dict(order=2, collision="mean", group=8),
    "o1_mean_mask": dict(order=1, collision="mean", mask=True),
}


@pytest.mark.parametrize("case", sorted(SHARED_CASES))
def test_sgns_shared_negs_step(case):
    c = dict(SHARED_CASES[case])
    order, group = c.pop("order"), c.pop("group", 1)
    use_pallas = c.pop("use_pallas", False)
    B = c.pop("B", 256)
    rng = np.random.default_rng(len(case))
    wv, wc = _tables(len(case))
    Ks = 32
    src = np.repeat(_idx(rng, B // group), group)
    pos, negs = _idx(rng, B), _idx(rng, Ks)
    mask = _mask(rng, B) if c.pop("mask", False) else None
    a = np.float32(0.05)
    kw = dict(k_equiv=5, src_group=group, mask=mask, **c)
    jv, jc = jnp.asarray(wv), jnp.asarray(wc)
    if order == 1:
        jc = jv
        kw["shared_table"] = True
    jv, jc, jl = J.sgns_shared_negs_step(jv, jc, src, pos, negs, a,
                                         use_pallas=False, **kw)
    tv = _t(wv)
    tc = tv if order == 1 else _t(wc)
    if mask is not None:
        kw["mask"] = _t(mask)
    before = K1.launches
    gv, gc, gl = T.sgns_shared_negs_step(tv, tc, _t(src), _t(pos),
                                         _t(negs), torch.tensor(a),
                                         use_pallas=use_pallas, **kw)
    assert K1.launches == before  # CPU: twin, no kernel
    assert gv is tv and gc is tc
    _close(gv, jv)
    _close(gc, jc)
    _close(gl, jl)
    assert not np.allclose(gc.numpy(), wv if order == 1 else wc)
