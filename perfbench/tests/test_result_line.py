"""The result line's shape, from whole runs at a tiny size on the CPU
(``run_cell``: everything after the look for a card): exactly the keys the
driver reads, ``breakdown`` only when traced, the compared numbers last;
names and units of the allowed characters."""

import io
import json
import re
import time

import pytest
import torch

from perfbench.harness import main

import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(name: str, traced: bool):
    c = tiny.cell(name)
    r = main.run_cell(c, 2**31 + 12345, 0.2, traced, torch.device("cpu"),
                      time.perf_counter())
    out, err = io.StringIO(), io.StringIO()
    assert main.emit(r, out, err) == 0
    return c, json.loads(out.getvalue().strip().splitlines()[-1]), \
        err.getvalue().strip().splitlines()


@pytest.mark.parametrize("traced", [False, True])
def test_result_line(traced):
    c, line, err = _line("line_o2.flickr", traced)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if traced else []
    assert list(line) == keys + ["checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    want = c.per_layer if traced else c.end_to_end
    assert set(line["metrics"]) <= {m["name"] for m in want}
    if not traced:
        assert set(line["metrics"]) == {m["name"] for m in want}
    for name, m in line["metrics"].items():
        assert NAME.match(name) and UNIT.match(m["unit"])
        assert isinstance(m["value"], float)
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if traced:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
    # the compared numbers: the result's last key and stderr's last lines
    assert list(line["checks"]) == list(main.check.NAMES)
    tail = err[-len(main.check.NAMES):]
    for (k, v), text in zip(line["checks"].items(), tail):
        assert text.startswith(f"check {k} ") and "limit" in text
        assert NAME.match(k)
