"""The output check sees a broken program: whole runs at a tiny size on the
CPU (the look for a card skipped) with the timed path broken underneath,
once for each fault a training cell here can have (an update that returns
the tables unchanged; half of each batch left out, the mean taken over the
rest) and once for each fault that acts only in the calls the card
replays (``faults.REPLAY_FAULTS``: stale rates, a generator that does not
advance, a lost update), and the same runs unbroken. One card, so no
exchange between chips to leave out."""

import time

import pytest
import torch

from perfbench.harness import check, faults, main

import tiny

CELLS = list(tiny.TINY)


def _unchanged_shared(orig):
    def f(wv, wc, src, pos, negs, alpha, *a, **kw):
        out = orig(wv.clone(), wc.clone(), src, pos, negs, alpha, *a, **kw)
        return wv, wc, out[2]
    return f


def _half_shared(orig):
    def f(wv, wc, src, pos, negs, alpha, *a, **kw):
        g = kw.get("src_group", 1)
        h = src.shape[0] // 2 // g * g
        if kw.get("mask") is not None:
            kw = dict(kw, mask=kw["mask"][:h])
        return orig(wv, wc, src[:h], pos[:h], negs, alpha * 2, *a, **kw)
    return f


def _unchanged_block(orig):
    def f(state, band, sb, db, src_l, pos_l, negs, alphas, k_equiv):
        return orig({n: t.clone() for n, t in state.items()}, band, sb, db,
                    src_l, pos_l, negs, alphas, k_equiv)
    return f


def _half_block(orig):
    def f(state, band, sb, db, src_l, pos_l, negs, alphas, k_equiv):
        h = src_l.shape[1] // 2
        return orig(state, band, sb, db, src_l[:, :h], pos_l[:, :h], negs,
                    alphas * 2, k_equiv)
    return f


def _break(monkeypatch, name: str, fault: str):
    from smore_tpu_torch.models import line, walk_base

    if name == "line_o2.youtube":
        mod, attr = line, "multiblock_apply"
        make = {"unchanged": _unchanged_block, "half_batch": _half_block}
    else:
        mod = line if name.startswith("line") else walk_base
        attr = "sgns_shared_negs_step"
        make = {"unchanged": _unchanged_shared, "half_batch": _half_shared}
    monkeypatch.setattr(mod, attr, make[fault](getattr(mod, attr)))


def _run(name: str):
    return main.run_cell(tiny.cell(name), 7, 0.1, False,
                         torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_update_is_not_correct(monkeypatch, name, fault):
    _break(monkeypatch, name, fault)
    r = _run(name)
    assert r["correct"] is False
    failed = [k for k, c in r["checks"].items() if c["value"] > c["limit"]]
    assert set(failed) & {"grad_gap", "change_gap", "step_diff"}, r["checks"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", faults.REPLAY_FAULTS)
def test_a_broken_replay_is_not_correct(name, fault):
    with faults.plant(fault):
        r = _run(name)
    assert r["correct"] is False
    failed = [k for k, c in r["checks"].items() if c["value"] > c["limit"]]
    assert set(failed) & set(check.REPLAY), r["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_unbroken_program_is_correct(name):
    r = _run(name)
    assert r["correct"] is True, r["checks"]
