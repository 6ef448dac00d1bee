"""The port's profiling helpers (smore_tpu_torch/utils/profiling.py)
against smore_tpu/utils/profiling.py: the same phase accounting and report
text, the same throughput; ``trace`` writes a Chrome trace of the block
through torch.profiler."""

import json
import time

import pytest
import torch

from smore_tpu.utils import profiling as jprof
from smore_tpu_torch.utils import profiling as prof

torch.set_num_threads(1)


def test_phase_timer_counts_and_reports_like_the_jax_one():
    ours, theirs = prof.PhaseTimer(), jprof.PhaseTimer()
    for t in (ours, theirs):
        for name in ("draw", "update", "draw"):
            with t.phase(name):
                time.sleep(0.001)
    assert dict(ours.counts) == dict(theirs.counts) == {"draw": 2,
                                                       "update": 1}
    assert all(v >= 0.001 for v in ours.totals.values())
    # the same totals give the same report, line for line; fixed totals,
    # so that the row order tests the report and not how long each sleep
    # overran under a loaded scheduler
    for t in (ours, theirs):
        t.totals.update(draw=0.5, update=0.25)
    assert ours.report() == theirs.report()
    assert ours.report().splitlines()[1].startswith("draw")
    assert ours.report().splitlines()[2].startswith("update")


def test_phase_time_counts_when_the_block_raises():
    t = prof.PhaseTimer()
    with pytest.raises(ValueError):
        with t.phase("fails"):
            raise ValueError
    assert t.counts["fails"] == 1 and t.totals["fails"] >= 0.0


@pytest.mark.parametrize("n,s", [(1000, 0.5), (7, 0.0), (0, 2.0)])
def test_throughput(n, s):
    assert prof.throughput(n, s) == jprof.throughput(n, s)


def test_trace_writes_a_chrome_trace(tmp_path):
    d = tmp_path / "trace"
    with prof.trace(str(d)):
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    events = json.loads((d / "trace.json").read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
