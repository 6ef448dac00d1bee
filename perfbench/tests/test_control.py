"""The control fails the output check on the card: the reference computed
in TF32 (the precision below the configurations' float32 with TF32 off),
put in the program's place, reads over the limits where the program, on
the same recorded updates, reads under them. At each cell's tiny sizes
(``tiny.py``); the readings at the cells' own sizes come from
``perfbench/calibrate.py`` (PERF.md)."""

import pytest

from perfbench.harness import main

import tiny


@pytest.mark.gpu
@pytest.mark.parametrize("name", tiny.names())
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_the_control_is_not_correct(card, name, seed):
    c = tiny.cell(name)
    st = main.set_up(c, seed, card)
    r = main.output_check(st, c, card, ("program", "control"))
    ok, _ = main.check.verdict(r["program"], c.limits, main.check.SETUP)
    assert ok, r["program"]
    ok, rows = main.check.verdict(r["control"], c.limits, main.check.SETUP)
    assert not ok, rows
