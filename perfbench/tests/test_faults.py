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

from perfbench.harness import check, faults, main, spec

import tiny

CELLS = tiny.names()


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


# the update boundaries that a family's hooks wrap, broken each way
BREAKS = {
    "sgns_shared_negs_step": {"unchanged": _unchanged_shared,
                              "half_batch": _half_shared},
    "multiblock_apply": {"unchanged": _unchanged_block,
                         "half_batch": _half_block},
}


class _Breaker:
    """Stands in for the recorder in a family's ``hooks``: breaks each
    update the family records, wherever its cell's route goes."""

    def __init__(self, monkeypatch, fault: str):
        self.monkeypatch, self.fault = monkeypatch, fault
        self.broken = []

    def patch(self, module, name: str, make) -> None:
        if name in BREAKS:
            self.monkeypatch.setattr(module, name, BREAKS[name][self.fault](
                getattr(module, name)))
            self.broken.append(name)


def _break(monkeypatch, name: str, fault: str):
    c = spec.cell(name)
    breaker = _Breaker(monkeypatch, fault)
    spec.family(c.family, c.root).hooks(breaker)
    assert breaker.broken, f"{c.family}'s hooks wrap no update in BREAKS"


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
