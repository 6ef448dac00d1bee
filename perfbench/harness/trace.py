"""The traced job: ``torch.profiler`` over one job's steady replays,
reduced to what the per-layer metrics read.

The profiler's events are read in memory (a job of the walk models
records millions of kernels; no trace file is written). From them:

- device intervals: kernels, memory copies and memsets on the card; their
  union is the busy time, and the gaps in it within the job's window are
  idle time;
- kernel seconds and launches by name;
- each idle gap's label: the innermost host event (a torch op, a CUDA
  runtime call or one of the harness's own ``record_function`` spans)
  open at the gap's middle, else "host: no traced op".

The window is the harness's ``bench.job`` span: from the end of the job's
second call (the eager first call and the capture run untraced, so that
the job's one-time cost is the driver's own reading and not the
profiler's) to the end of the job, or to the first call boundary after
``MAX_TRACED_S`` seconds, with its closing ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

JOB_SPAN = "bench.job"
NO_OP = "host: no traced op"
# the traced share of a job: whole jobs of every cell but DeepWalk on
# Youtube (14 s untraced; 8 s of its replays made a traced run of 190 s)
MAX_TRACED_S = 6.0
# the calls a job runs before the traced window: the eager first call and
# the capture (with its first replay)
UNTRACED_CALLS = 2


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    wall_s: float  # the whole job's wall by the host clock
    kernels: Dict[str, Tuple[float, int]] = field(default_factory=dict)
    device_ops: List[list] = field(default_factory=list)
    idle_gaps: List[list] = field(default_factory=list)


def traced(run: Callable[[], None], device) -> TraceSummary:
    """Profile ``run``, one job (CPU and, on the card, CUDA activity), from
    the end of its ``UNTRACED_CALLS``-th call for ``MAX_TRACED_S`` seconds:
    the profiler starts and stops at boundaries between two of the job's
    calls (the harness wraps ``CapturedCalls.__call__`` while it traces),
    and the job runs on. A DeepWalk Youtube job launches ~4M kernels, and
    the profiler's own processing of a whole one took ~4 minutes of a
    run's 6. The profiler's results are read as raw events: its context
    manager would also parse them into ``FunctionEvent`` objects."""
    from torch.autograd import profiler as ap
    from smore_tpu_torch.models import base

    cuda = device.type == "cuda"
    prof = ap.profile(use_device="cuda" if cuda else None, use_kineto=True)
    span = ap.record_function(JOB_SPAN)
    started, stopped, paused = [], [], [0.0]

    def start():
        t = time.perf_counter()
        if cuda:
            torch.cuda.synchronize(device)
        prof._prepare_trace()
        prof._start_trace()
        started.append(time.perf_counter())
        span.__enter__()
        paused[0] += started[0] - t

    def stop():
        t = time.perf_counter()
        if cuda:
            torch.cuda.synchronize(device)
        span.__exit__(None, None, None)
        stopped.append(ap._disable_profiler())
        getattr(ap, "_run_on_profiler_stop", lambda: None)()
        paused[0] += time.perf_counter() - t

    orig = base.CapturedCalls.__call__

    def call(self, *a, **kw):
        orig(self, *a, **kw)
        if not started and self.calls >= UNTRACED_CALLS:
            start()
        elif (started and not stopped
              and time.perf_counter() - started[0] >= MAX_TRACED_S):
            stop()

    base.CapturedCalls.__call__ = call
    try:
        t0 = time.perf_counter()
        run()
        if cuda:
            torch.cuda.synchronize(device)
        # the job's wall, less the profiler's start and its processing
        # when it stopped inside the job
        wall = time.perf_counter() - t0 - paused[0]
        if started and not stopped:
            stop()
    finally:
        base.CapturedCalls.__call__ = orig
        if started and not stopped:
            stop()
    if not started:
        raise RuntimeError(f"the traced job ran fewer than {UNTRACED_CALLS} "
                           "calls: no replay to trace")
    events = [(str(e.device_type()).endswith("CUDA"), e.name(),
               e.start_ns(), e.end_ns()) for e in stopped[0].events()]
    return summarize(events, wall, on_card=cuda)


def _short(name: str, width: int = 120) -> str:
    """A kernel's name cut to ``width`` characters (template arguments run
    to thousands)."""
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= width else name[:width - 3] + "..."


def _gaps(starts: np.ndarray, ends: np.ndarray, lo: float, hi: float):
    """The idle (start, end) gaps within [lo, hi] between the union of the
    intervals."""
    keep = (ends > lo) & (starts < hi)
    s = np.clip(starts[keep], lo, hi)
    e = np.clip(ends[keep], lo, hi)
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    reach = np.maximum.accumulate(np.concatenate([[lo], e]))
    idle = s > reach[:-1]
    a = np.concatenate([reach[:-1][idle], reach[-1:]])
    b = np.concatenate([s[idle], [hi]])
    last = b > a
    return a[last], b[last]


def _labels(h_start, h_end, mids, look: int = 256) -> np.ndarray:
    """Index of the innermost host event open at each of ``mids``: of the
    events begun before it, the latest-begun that has not ended (nested
    events begin later than their parents), up to ``look`` back; -1 where
    none is."""
    j = np.searchsorted(h_start, mids, side="right")
    out = np.full(len(mids), -1, dtype=np.int64)
    todo = np.ones(len(mids), dtype=bool)
    for k in range(1, look + 1):
        cand = j - k
        live = todo & (cand >= 0)
        if not live.any():
            break
        hit = np.zeros(len(mids), dtype=bool)
        hit[live] = h_end[cand[live]] >= mids[live]
        out[hit] = cand[hit]
        todo &= ~hit
    return out


def summarize(events: list, wall_s: float,
              on_card: bool = False) -> TraceSummary:
    """``events``: (on the card, name, start_ns, end_ns) of the profiler:
    on the card, kernels, copies and memsets (and the job span's shadow,
    left out); on the host, torch ops, CUDA runtime calls and spans. With
    ``on_card`` a trace in which no device operation ran in the window
    raises: its idle share would read 100% without a measurement."""
    dev_s, dev_e = [], []
    host = []
    job = None
    kernels = defaultdict(lambda: [0.0, 0])
    for on_card, name, t0, t1 in events:
        if name == JOB_SPAN:
            if not on_card:
                job = (t0, t1)
        elif on_card:
            dev_s.append(t0)
            dev_e.append(t1)
            k = kernels[name]
            k[0] += (t1 - t0) * 1e-9
            k[1] += 1
        else:
            host.append((t0, t1, name))
    if job is None:
        raise RuntimeError(f"the trace holds no {JOB_SPAN!r} span")
    # times relative to the job's start, in integers first: ns since the
    # epoch lose their last digits in float64
    lo, hi = 0.0, float(job[1] - job[0])

    def rel(t):
        return (np.array(t, dtype=np.int64) - job[0]).astype(np.float64)

    ga, gb = _gaps(rel(dev_s), rel(dev_e), lo, hi)
    idle_ns = float((gb - ga).sum())
    if on_card and not hi - lo - idle_ns > 0:
        raise RuntimeError(
            f"the trace holds {len(dev_s)} device operations and none in "
            "the job's window: the profiler recorded no device activity")
    host.sort(key=lambda h: (h[0], -(h[1] - h[0])))
    h_start = rel([h[0] for h in host])
    h_end = rel([h[1] for h in host])
    lab = _labels(h_start, h_end, 0.5 * (ga + gb))
    by_label = defaultdict(float)
    for i, d in zip(lab.tolist(), ((gb - ga) * 1e-9).tolist()):
        by_label[host[i][2] if i >= 0 else NO_OP] += d
    ops = sorted(((n, s) for n, (s, _) in kernels.items()),
                 key=lambda x: -x[1])[:10]
    idle = sorted(by_label.items(), key=lambda x: -x[1])[:10]
    return TraceSummary(
        window_s=(hi - lo) * 1e-9,
        busy_s=(hi - lo - idle_ns) * 1e-9,
        wall_s=wall_s,
        kernels={n: (s, c) for n, (s, c) in kernels.items()},
        device_ops=[[_short(n), s] for n, s in ops],
        idle_gaps=[[n, s] for n, s in idle],
    )
