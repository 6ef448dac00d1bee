"""The port's tracer (smore_tpu_torch/utils/profiling.py) on the CPU.

- Off, it records nothing and dispatches no op: no tensor, event or kernel.
- Host spans: nesting and parents, self time, a span closed by an
  exception; the records grouped by ``train()``.
- The ring of on-card stamps, decoded from a synthetic ring: the calls, the
  dropped stamps, the shares of the stamped step, the gaps between replays
  put down to the host span open when each began.
- The capture's spans, with a stand-in for the CUDA graph: the
  ``CapturedCalls`` counters read the spans' own clock readings.
- The output check's four patched names still wrap with the tracer on.
- The per-layer metrics of ``experiments/torch_layer_split.py`` on
  synthetic groups, and None where the CPU has no device figure.

The stamps themselves are held on the card (tests/test_torch_gpu.py).
"""

import importlib.util
import os
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from smore_tpu_torch.models import base, deepwalk, line, node2vec, walk_base
from smore_tpu_torch.models.base import TrainDriver
from smore_tpu_torch.ops import launches
from smore_tpu_torch.utils import profiling as P
from torch_graph_call_cases import build, toy_graph

torch.set_num_threads(1)

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _layer_split():
    spec = importlib.util.spec_from_file_location(
        "torch_layer_split",
        os.path.join(ROOT, "experiments", "torch_layer_split.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def fresh():
    P.disable()
    P.reset()
    yield
    P.disable()
    P.reset()


class Ops(TorchDispatchMode):
    """Counts the ops dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _line(**kw):
    m = line.LINE(toy_graph(), seed=0, device=CPU)
    m.init(dim=16)
    m.train(sample_times=0.02, banded=False, batch=1024, steps_per_call=4,
            verbose=False, **kw)
    return m


# ------------------------------------------------------------------- off #
@pytest.mark.parametrize("make", [lambda: P.span("x"),
                                  lambda: P.segment("x"),
                                  lambda: P.step(0)],
                         ids=["span", "segment", "step"])
def test_off_is_the_shared_no_op(make):
    ran = []
    with Ops() as ops:
        ctx = make()
        with ctx:
            ran.append(1)
    assert ctx is P.NOOP and ran == [1] and ops.n == 0
    assert P._spans == [] and not P._counters


def test_off_a_train_records_nothing_and_makes_no_ring():
    m = _line()
    assert m.last_driver.calls >= 2
    assert P.groups() == [] and P._spans == [] and P._rings == {}


# ------------------------------------------------------------ host spans #
def test_spans_nest_with_parents_and_self_time():
    P.enable()
    with P.span("a"):
        with P.span("b"):
            time.sleep(0.002)
        with P.span("b"):
            pass
        with P.span("c"):
            with P.span("d"):
                time.sleep(0.001)
    P.end()
    g = P.groups()[-1]
    assert [(s[0], s[3]) for s in g.spans] == [
        ("a", -1), ("b", 0), ("b", 0), ("c", 0), ("d", 3)]
    s = P.span_summary(g)
    assert s["b"]["count"] == 2 and s["b"]["total_s"] >= 0.002
    inner = s["b"]["total_s"] + s["c"]["total_s"]
    assert s["a"]["self_s"] == pytest.approx(s["a"]["total_s"] - inner)
    assert s["c"]["self_s"] == pytest.approx(
        s["c"]["total_s"] - s["d"]["total_s"])
    assert s["d"]["self_s"] == s["d"]["total_s"] >= 0.001
    assert P.span_s(g, ["b", "d"]) == pytest.approx(
        s["b"]["total_s"] + s["d"]["total_s"])
    assert P.span_s(g, ["nowhere"]) is None


def test_a_span_closed_by_an_exception_is_recorded():
    P.enable()
    with pytest.raises(ValueError):
        with P.span("outer"):
            with P.span("fails"):
                raise ValueError
    with P.span("after"):
        pass
    P.end()
    spans = P.groups()[-1].spans
    assert [s[0] for s in spans] == ["outer", "fails", "after"]
    assert all(t1 >= t0 > 0 for _, t0, t1, _ in spans)
    assert spans[2][3] == -1 and P._stack == []


def test_records_are_grouped_per_train():
    P.enable()
    m = _line()
    m.train(sample_times=0.02, banded=False, batch=1024, steps_per_call=4,
            verbose=False)
    g0, g1 = P.groups()
    s0, s1 = P.span_summary(g0), P.span_summary(g1)
    # the graph and the sampler come before the first train(), in its group
    assert "graph.from_arrays" in s0 and "sampler.build" in s0
    assert "graph.from_arrays" not in s1 and "sampler.build" not in s1
    for g, s in ((g0, s0), (g1, s1)):
        assert g.info["calls"] >= 2 and not g.info["captured"]
        assert s["driver.alphas"]["count"] == g.info["calls"]
        assert g.stamps is None and P.share_pct(g, ["line.update"]) is None


# ------------------------------------------------------------- the ring #
def _stamps(events):
    """(n, 2) records of (segment name, end?, ns)."""
    return np.array([[P._code(n) << 1 | e, t] for n, e, t in events],
                    dtype=np.int64).reshape(-1, 2)


def _replay(t, step=1000, seg=(("walk.draw", 600, "step"),
                               ("walk.walk", 400, "walk.draw"),
                               ("walk.update", 350, "step"))):
    """A call at ``t``: its step at t + 10, the segments laid out in it,
    each child at its parent's start, siblings one after another."""
    ev = [("call", 0, t), ("step", 0, t + 10)]
    at = {"step": t + 10}
    for name, d, parent in seg:
        t0 = at[parent]
        at[parent] = t0 + d
        at[name] = t0
        ev += [(name, 0, t0), (name, 1, t0 + d)]
    ev = sorted(ev, key=lambda e: (e[2], -e[1]))
    return ev + [("step", 1, t + 10 + step), ("call", 1, t + 20 + step)]


class FakeRing:
    def __init__(self, events, cursor):
        rec = np.zeros((P.RING, 2), dtype=np.int64)
        st = _stamps(events)
        rec[:len(st)] = st[:P.RING]
        self.records = torch.from_numpy(rec)
        self.cursor = torch.tensor([cursor])


def test_the_ring_is_decoded_and_its_dropped_stamps_counted(monkeypatch):
    monkeypatch.setattr(P, "RING", 16)
    events = _replay(100) + _replay(5000)
    assert len(events) == 20  # 16 kept: the second call is cut
    P.enable()
    monkeypatch.setattr(P, "_device_side",
                        (FakeRing(events, len(events)), (1_000_000, 40)))
    P.end(captured=True)
    g = P.groups()[-1]
    assert g.counters["stamps_written"] == 16
    assert g.counters["stamps_dropped"] == 4
    # the card's clock onto the host's: host = card - 40 + 1_000_000
    assert g.stamps[0, 1] == 100 - 40 + 1_000_000
    (c,) = P.calls(g)  # the cut call is left out
    assert c.t1 - c.t0 == 1020
    assert dict(c.seg) == {"step": 1000, "walk.draw": 600, "walk.walk": 400,
                           "walk.update": 350}
    assert c.parent == {"step": None, "walk.draw": "step",
                        "walk.walk": "walk.draw", "walk.update": "step"}
    assert P.replays(g) == []  # the first call is the eager one


def _job(starts=(0, 10_000, 20_000, 31_000, 45_000), spans=()):
    stamps = _stamps([e for t in starts for e in _replay(t)])
    return P.Group(spans=list(spans), counters={}, stamps=stamps,
                   info={"captured": True})


def test_the_shares_of_the_stamped_step():
    g = _job()
    assert len(P.replays(g)) == 4
    assert P.share_pct(g, ["walk.draw"]) == pytest.approx(60.0)
    assert P.share_pct(g, ["walk.draw", "walk.update"]) == pytest.approx(95)
    assert P.coverage_pct(g) == pytest.approx(95.0)
    ms = P.segment_ms(g)
    assert ms["walk.walk"] == pytest.approx(4e-4)
    assert ms["call"] == pytest.approx(1.02e-3)
    # eager calls have no replays to read
    g.info["captured"] = False
    assert P.share_pct(g, ["walk.draw"]) is None


def test_gaps_between_replays_are_put_down_to_the_open_host_span():
    # replays end at 11_020, 21_020 and 32_020 and the next ones start at
    # 20_000, 31_000 and 45_000: gaps of 8_980, 9_980 and 12_980 ns
    spans = [["driver.alphas", 11_000, 19_000, -1],
             ["driver.alphas.wait", 11_010, 18_000, 0],
             ["driver.replay", 19_500, 19_900, -1],
             ["driver.alphas", 21_000, 21_010, -1],  # closed before the gap
             ["driver.replay", 21_015, 30_000, -1]]
    g = _job(spans=spans)
    assert P.replay_gap_ms(g) == pytest.approx(1e-6 * 9_980)  # the median
    assert P.gap_spans(g) == pytest.approx({
        "driver.alphas.wait": 8_980e-9, "driver.replay": 9_980e-9,
        P.NO_SPAN: 12_980e-9})
    one = _job(starts=(0, 10_000))
    assert P.replay_gap_ms(one) is None and P.gap_spans(one) is None


# ----------------------------------------------------------- the capture #
class _FakeCUDAGraph:
    def __init__(self, keep_graph=False):
        pass

    def register_generator_state(self, gen):
        pass

    def instantiate(self):
        time.sleep(0.001)

    def raw_cuda_graph(self):
        return 0

    def replay(self):
        pass


class _FakeCapture:
    def __init__(self, graph, capture_error_mode="global"):
        pass

    def __enter__(self):
        time.sleep(0.002)

    def __exit__(self, *exc):
        return False


def test_the_capture_splits_into_its_spans_and_feeds_the_counters(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeCUDAGraph)
    monkeypatch.setattr(torch.cuda, "graph", _FakeCapture)
    monkeypatch.setattr(launches, "node_count", lambda g: 7)
    monkeypatch.setattr(launches, "in_graph", lambda g: {})
    monkeypatch.setattr(base, "_warm_up", lambda run, device: run())
    monkeypatch.setattr(TrainDriver, "_captures", lambda self: True)

    def step(state, ctx, gen, alpha):
        return state, torch.zeros(())

    P.enable()
    d = TrainDriver(step, ctx=None, samples_per_step=1, alpha=0.1,
                    total_samples=3 * 5, steps_per_call=3, device=CPU)
    d.train({}, torch.Generator(), verbose=False)
    g = P.groups()[-1]
    s = P.span_summary(g)
    assert (d.calls, d.replays) == (5, 4)
    assert g.info == {"captured": True, "calls": 5, "replays": 4,
                      "nodes": {None: 7}}
    # one span a region, its children inside it
    assert {k: v["count"] for k, v in s.items()} == {
        "driver.alphas": 5, "calls.first": 1, "calls.capture": 1,
        "capture.prepare": 1, "capture.record": 1, "capture.instantiate": 1,
        "capture.count": 2, "driver.replay": 4}
    parent = {sp[0]: g.spans[sp[3]][0] for sp in g.spans if sp[3] >= 0}
    assert all(parent[k] == "calls.capture" for k in (
        "capture.prepare", "capture.record", "capture.instantiate",
        "capture.count"))
    assert s["capture.prepare"]["total_s"] >= 0.002
    # the counters are the spans' own clock readings
    assert d.first_call_s == s["calls.first"]["total_s"]
    assert d.capture_s == s["calls.capture"]["total_s"]
    assert d.replay_host_s == pytest.approx(s["driver.replay"]["total_s"])


# -------------------------------------------- the output check's names #
def _counting(calls, orig):
    def wrapped(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    return wrapped


@pytest.mark.parametrize("module,name,case", [
    (line, "multiblock_apply", "line_multiblock"),
    (line, "sgns_shared_negs_step", "line_unbanded_g8"),
    (walk_base, "sgns_shared_negs_step", "DeepWalk"),
    (deepwalk, "random_walk", "DeepWalk"),
    (node2vec, "node2vec_walk", "Node2Vec"),
])
def test_the_output_checks_names_still_wrap_with_the_tracer_on(
        module, name, case, monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(module, name, _counting(calls, getattr(module,
                                                               name)))
    P.enable()
    m, kw = build(case, CPU, str(tmp_path))
    m.train(**kw)
    assert calls and m.last_driver.calls >= 2
    assert P.groups()[-1].info["calls"] == m.last_driver.calls


# ------------------------------------------------- the per-layer metrics #
_SETUP_SPANS = [["sampler.build", 0, 1_000_000_000, -1],
                ["banded.build", 0, 500_000_000, -1],
                ["banded.neg_bands", 0, 250_000_000, -1],
                ["banded.stream", 0, 2_000_000_000, -1]]
_SEGS = (("walk.draw", 600, "step"), ("walk.walk", 400, "walk.draw"),
         ("walk.update", 350, "step"), ("line.draw", 100, "step"),
         ("line.snapshot", 50, "step"), ("line.k4", 700, "step"),
         ("line.neg_add", 100, "step"), ("line.update", 800, "step"))
_JOB_SPANS = [["calls.capture", 0, 9_000_000, -1],
              ["capture.prepare", 0, 5_000_000, 0]]
# cell, and what each metric reads in it from the synthetic groups
_EXPECT = {
    "walk_pct": ("deepwalk.youtube", 60.0),
    "update_pct.walk": ("deepwalk.flickr", 35.0),
    "update_pct.line": ("line_o2.flickr", 80.0),
    "superstep_ops_pct": ("line_o2.youtube", 25.0),
    "replay_gap_ms.line": ("line_o2.youtube", 1e-6 * 4_000),
    "replay_gap_ms.walk": ("deepwalk.youtube", 1e-6 * 4_000),
    "capture_prep_ms.line": ("line_o2.flickr", 5.0),
    "capture_prep_ms.walk": ("deepwalk.flickr", 5.0),
    "stream_build_s": ("line_o2.youtube", 2.0),
    "tables_build_s": ("deepwalk.youtube", 1.75),
}


def test_every_metric_has_its_case():
    assert sorted(_layer_split().METRICS) == sorted(_EXPECT)


@pytest.mark.parametrize("name", sorted(_EXPECT))
def test_each_metric_on_a_synthetic_run_and_on_the_cpu(name):
    ls = _layer_split()
    cell, want = _EXPECT[name]
    setup = P.Group(spans=_SETUP_SPANS, counters={}, stamps=None, info={})
    # five calls 7_020 ns apart, each a 3_000 ns step and 20 ns around it:
    # 4_000 ns between two
    step = 3_000
    stamps = _stamps([e for t in range(0, 5 * 7_020, 7_020)
                      for e in _replay(t, step=step, seg=_SEGS)])
    job = P.Group(spans=_JOB_SPANS, counters={}, stamps=stamps,
                  info={"captured": True})
    got = ls.read(name, cell, setup, job)
    if ls.METRICS[name][2] == "share":
        want = want * 1_000 / step  # _EXPECT's shares are of 1_000 ns
    assert got == pytest.approx(want)
    # a cell the metric does not apply to reads None
    other = [c for c in ls.ALL_CELLS if c not in ls.METRICS[name][1]]
    for c in other:
        assert ls.read(name, c, setup, job) is None
    # the CPU: no stamps and no capture, so no device figure
    cpu = P.Group(spans=[], counters={}, stamps=None,
                  info={"captured": False})
    on_cpu = ls.read(name, cell, setup, cpu)
    if ls.METRICS[name][2] == "setup_s":
        assert on_cpu == pytest.approx(want)  # a host span
    else:
        assert on_cpu is None
