"""The port's tracer: host spans, counters and on-card stamps at the
boundaries of its layers.

Off by default; ``enable()`` and ``disable()`` are its only switch.

- Off, ``span``, ``segment`` and ``step`` are one check of a module flag
  and return the shared no-op context ``NOOP``: nothing is recorded and no
  event, tensor or kernel is made, so a graph captured with the tracer off
  is the graph the program captures without it. ``timed`` (a region that a
  ``CapturedCalls`` counter times) reads the same two clock readings either
  way; on, they are also the span's.
- Host spans (``span``, ``timed``): name, start and end
  (``time.perf_counter_ns``) and the index of the span open around it, kept
  in memory. They open no ``torch.profiler.record_function``: under the
  profiler, a range around launches gets a shadow on the card's timeline
  (a "driver.replay" over every kernel of the replay), which a reader of
  the trace takes for device work.
- Device segments (``segment``, ``step``): on the card each end of a
  segment launches the one-thread stamp kernel ``csrc/trace_stamp.cu`` into
  the current stream. It writes (segment, ``%globaltimer``) into a ring on
  the card when the stream reaches it: eagerly, and under capture as a node
  of the graph, so that every replay writes its own stamps and nothing
  waits. A call's first and last node are stamped (``call``), and the
  segments of its first step only (``step``): a call's steps have one
  shape. At most ``MAX_STAMPS`` stamps a call; a stamp past the ring's end
  is counted (``stamps_dropped``), not written.
- Counters (``count``): integers by name.
- Groups, one a ``train()``: its ``CapturedCalls`` begins the group's
  device side at its first call (``begin``: the ring's cursor set back, and
  an anchor of the card's clock to the host's) and ends the group at
  ``close()`` (``end``), which has waited for the card, so the ring is read
  there, once. A group holds the spans and counters since the last group
  ended and its calls' stamps on the host's clock; the last ``KEEP`` are
  kept (``groups()``).

The report (``span_summary``, ``span_s``, ``calls``, ``share_pct``,
``coverage_pct``, ``replay_gap_ms``, ``gap_spans``, ``report``) reads a
group. On the CPU only host spans and counters are recorded, and every
device figure reads None.
"""

from __future__ import annotations

import ctypes
import functools
import time
from collections import defaultdict, deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from smore_tpu_torch.ops.launches import Kernel

MAX_STAMPS = 16  # stamps a call: its first and last node, its first step's
RING = 1 << 16  # (code, ns) records in a card's ring
KEEP = 8  # groups kept
ANCHOR_TRIES = 3  # the tightest of this many anchors
NO_SPAN = "host: no span"
CALL, STEP = "call", "step"

_P, _I = ctypes.c_void_p, ctypes.c_int
# the stamps are the tracer's nodes, not kernel launches: not counted
STAMP = Kernel("trace_stamp", [_I, _P, _P, _I, _I, _P], counted=False)

_on = False
_spans: list = []  # the open group's spans: [name, t0, t1, parent index]
_stack: list = []  # the open spans: (their group's list, index)
_counters: Dict[str, int] = defaultdict(int)
_groups: deque = deque(maxlen=KEEP)
_ids: Dict[str, int] = {}  # segment name -> id
_names: List[str] = []  # id -> segment name
_rings: dict = {}  # device -> _Ring
_device_side = None  # the open group's (ring, anchor), on the card
_stamping = None  # the call being stamped (_CallStamps)


def enable() -> None:
    """Turn the tracer on. On a card, its ring is made and the stamp
    kernel built now, not inside a job."""
    global _on
    _on = True
    if torch.cuda.is_available():
        _ring(torch.device("cuda", torch.cuda.current_device()))


def disable() -> None:
    """Turn the tracer off; what it recorded stays readable."""
    global _on, _stamping, _device_side
    _on = False
    _stamping = _device_side = None


def reset() -> None:
    """Forget every group, span and counter."""
    global _spans
    _groups.clear()
    _spans = []
    _stack.clear()
    _counters.clear()


# ------------------------------------------------------------ host spans #
class _Noop:
    """The shared context of everything the tracer does not record."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class _Clock:
    """Two readings of ``time.perf_counter_ns``: ``t0`` and ``t1``."""

    __slots__ = ("t0", "t1")

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        return False

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) * 1e-9


class _Span(_Clock):
    __slots__ = ("name", "_list", "_i")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        spans = _spans
        top = _stack[-1] if _stack else None
        parent = top[1] if top is not None and top[0] is spans else -1
        self._list, self._i = spans, len(spans)
        spans.append([self.name, 0, -1, parent])
        _stack.append((spans, self._i))
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        rec = self._list[self._i]
        rec[1], rec[2] = self.t0, self.t1
        while _stack:
            lst, i = _stack.pop()
            if lst is self._list and i == self._i:
                break
        return False


def span(name: str):
    """A host span of ``name`` around the block."""
    if not _on:
        return NOOP
    return _Span(name)


def spanned(name: str):
    """A function decorator: each call in a host span of ``name``."""

    def wrap(f):
        @functools.wraps(f)
        def call(*args, **kw):
            if not _on:
                return f(*args, **kw)
            with _Span(name):
                return f(*args, **kw)

        return call

    return wrap


def timed(name: str):
    """The two clock readings of a region that a counter times (``.t0``,
    ``.seconds``), also a span of ``name`` with the tracer on."""
    if not _on:
        return _Clock()
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    if _on:
        _counters[name] += int(n)


def wait(event, name: str) -> None:
    """``event.synchronize()``; with the tracer on in a span of ``name``,
    counting in ``<name>.blocked`` the waits that found the event not yet
    reached."""
    if not _on:
        event.synchronize()
        return
    with _Span(name):
        if not event.query():
            _counters[f"{name}.blocked"] += 1
        event.synchronize()


# ------------------------------------------------------- device segments #
class _Ring:
    """A card's stamp ring: ``records`` (RING, 2) int64 (code, ns), the
    stamps taken so far in ``cursor``, and a one-record ring of its own for
    the anchor."""

    def __init__(self, device: torch.device):
        self.device = device
        i64 = dict(dtype=torch.int64, device=device)
        self.records = torch.zeros((RING, 2), **i64)
        self.cursor = torch.zeros(1, **i64)
        self.anchor_rec = torch.zeros((1, 2), **i64)
        self.anchor_cursor = torch.zeros(1, **i64)
        STAMP.load()

    def stamp(self, code: int, anchor: bool = False) -> None:
        rec, cur, cap = ((self.anchor_rec, self.anchor_cursor, 1) if anchor
                         else (self.records, self.cursor, RING))
        STAMP.launch(self.device, rec.data_ptr(), cur.data_ptr(), cap, code)

    def anchor(self) -> tuple:
        """(host ns, card ns) of one instant: the card's stamp between two
        host readings, each after a synchronisation; the tightest of
        ``ANCHOR_TRIES``, the host's reading at the middle."""
        best = None
        for _ in range(ANCHOR_TRIES):
            self.anchor_cursor.zero_()
            torch.cuda.synchronize(self.device)
            h0 = time.perf_counter_ns()
            self.stamp(0, anchor=True)
            torch.cuda.synchronize(self.device)
            h1 = time.perf_counter_ns()
            if best is None or h1 - h0 < best[0]:
                best = (h1 - h0, (h0 + h1) // 2,
                        int(self.anchor_rec[0, 1].item()))
        return best[1], best[2]


def _ring(device: torch.device) -> _Ring:
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    if device not in _rings:
        _rings[device] = _Ring(device)
    return _rings[device]


def _code(name: str) -> int:
    if name not in _ids:
        _ids[name] = len(_names)
        _names.append(name)
    return _ids[name]


class _CallStamps:
    """The call being stamped: its ring, the stamps it has issued (its
    first node's included), and whether its segments still stamp (until its
    first step ends)."""

    __slots__ = ("ring", "issued", "armed")

    def __init__(self, ring: _Ring):
        self.ring, self.issued, self.armed = ring, 1, True


class _Segment:
    __slots__ = ("call", "code", "last")

    def __init__(self, call: _CallStamps, code: int, last: bool = False):
        self.call, self.code, self.last = call, code, last

    def __enter__(self):
        self.call.ring.stamp(self.code << 1)
        return self

    def __exit__(self, *exc):
        self.call.ring.stamp(self.code << 1 | 1)
        if self.last:
            self.call.armed = False
        return False


def segment(name: Optional[str], last: bool = False):
    """A device segment of ``name`` around the block: stamped on the card
    inside a stamped call's first step while the call's budget lasts (its
    two stamps and the call's last); None is no segment."""
    if not _on:
        return NOOP
    c = _stamping
    if c is None or not c.armed or name is None:
        return NOOP
    if c.issued + 3 > MAX_STAMPS:
        return NOOP
    c.issued += 2
    return _Segment(c, _code(name), last)


def step(i: int):
    """The segment of a call's step ``i``: the first step's only, whose end
    ends the call's segments."""
    if not _on or i:
        return NOOP
    return segment(STEP, last=True)


class _Call:
    __slots__ = ("ring", "code")

    def __init__(self, ring: _Ring):
        self.ring, self.code = ring, _code(CALL)

    def __enter__(self):
        global _stamping
        _stamping = _CallStamps(self.ring)
        self.ring.stamp(self.code << 1)
        return self

    def __exit__(self, *exc):
        global _stamping
        self.ring.stamp(self.code << 1 | 1)
        _stamping = None
        return False


def stamped(run: Callable[[], None], device: torch.device):
    """``run`` with its first and last node stamped (``call``) and its
    first step's segments armed; ``run`` itself with the tracer off or off
    the card."""
    if not _on or _device_side is None or device.type != "cuda":
        return run
    ring = _device_side[0]

    def call():
        with _Call(ring):
            run()

    return call


# ---------------------------------------------------------------- groups #
@dataclass
class Group:
    """One ``train()``: its spans ([name, t0, t1, parent index], ns), its
    counters, its calls' stamps ((n, 2) int64: code, host ns; None off the
    card) and what its ``CapturedCalls`` reported (``info``)."""

    spans: list
    counters: dict
    stamps: Optional[np.ndarray]
    info: dict


def begin(device: torch.device) -> None:
    """A group's device side, at its first call: on the card the ring's
    cursor set back and the anchor taken."""
    global _device_side
    if not _on or device.type != "cuda":
        return
    ring = _ring(device)
    ring.cursor.zero_()
    _device_side = (ring, ring.anchor())


def end(**info) -> None:
    """End the group (``close()``, after the card was waited for): read
    the ring once, keep the group."""
    global _device_side, _spans
    if not _on:
        return
    counters = dict(_counters)
    stamps = None
    if _device_side is not None:
        ring, (host, card) = _device_side
        n = int(ring.cursor.item())
        kept = min(n, RING)
        rec = ring.records[:kept].cpu().numpy()
        stamps = np.stack([rec[:, 0], rec[:, 1] - card + host], 1)
        counters["stamps_written"] = kept
        counters["stamps_dropped"] = n - kept
        _device_side = None
    _groups.append(Group(spans=_spans, counters=counters, stamps=stamps,
                         info=dict(info)))
    _spans = []
    _counters.clear()


def groups() -> List[Group]:
    """The kept groups, oldest first."""
    return list(_groups)


# ---------------------------------------------------------------- report #
def span_summary(g: Group) -> Dict[str, dict]:
    """Each span name's count, total and self seconds (the total less
    that of the spans directly inside it)."""
    total, n, inner = defaultdict(int), defaultdict(int), defaultdict(int)
    for name, t0, t1, parent in g.spans:
        if t1 < 0:
            continue  # still open
        total[name] += t1 - t0
        n[name] += 1
        if parent >= 0:
            inner[g.spans[parent][0]] += t1 - t0
    return {k: {"count": n[k], "total_s": total[k] * 1e-9,
                "self_s": (total[k] - inner[k]) * 1e-9} for k in total}


def span_s(g: Group, names) -> Optional[float]:
    """The total seconds of the spans of ``names``; None where none ran."""
    s = span_summary(g)
    hit = [s[k]["total_s"] for k in names if k in s]
    return float(sum(hit)) if hit else None


@dataclass
class Call:
    """A stamped call on the host's clock: ``t0``, ``t1`` (ns); each
    segment's device ns summed over its stamped runs, and the segment it
    ran in."""

    t0: int
    t1: int
    seg: Dict[str, int]
    parent: Dict[str, Optional[str]]


def calls(g: Group) -> List[Call]:
    """The group's complete stamped calls in the order the card ran them
    (the ring holds one stream's stamps in its order)."""
    if g.stamps is None:
        return []
    out, cur, stack = [], None, []
    for code, t in g.stamps.tolist():
        name, end = _names[code >> 1], code & 1
        if name == CALL:
            if not end:
                cur, stack = Call(t, t, defaultdict(int), {}), []
            elif cur is not None:
                cur.t1 = t
                out.append(cur)
                cur = None
        elif cur is None:
            continue
        elif not end:
            stack.append((name, t))
        else:
            while stack and stack[-1][0] != name:
                stack.pop()
            if stack:
                _, t0 = stack.pop()
                cur.seg[name] += t - t0
                cur.parent[name] = stack[-1][0] if stack else None
    return out


def replays(g: Group) -> List[Call]:
    """The stamped replays: every call after the first of a captured
    ``train()``."""
    return calls(g)[1:] if g.info.get("captured") else []


def _median(vals) -> Optional[float]:
    return float(np.median(vals)) if vals else None


def share_pct(g: Group, names) -> Optional[float]:
    """The median over the replays of the share of the stamped step's
    device time in the segments ``names``."""
    return _median([100.0 * sum(r.seg.get(k, 0) for k in names)
                    / r.seg[STEP] for r in replays(g) if r.seg.get(STEP)])


def coverage_pct(g: Group) -> Optional[float]:
    """The median over the replays of the share of the stamped step's
    device time in the segments directly inside it."""
    return _median([100.0 * sum(d for k, d in r.seg.items()
                                if r.parent.get(k) == STEP)
                    / r.seg[STEP] for r in replays(g) if r.seg.get(STEP)])


def segment_ms(g: Group) -> Dict[str, float]:
    """Each segment's median device ms over the replays, and the call's."""
    rs = replays(g)
    names = sorted({k for r in rs for k in r.seg})
    out = {k: 1e-6 * float(np.median([r.seg.get(k, 0) for r in rs]))
           for k in names}
    if rs:
        out[CALL] = 1e-6 * float(np.median([r.t1 - r.t0 for r in rs]))
    return out


def _gaps(g: Group) -> list:
    rs = replays(g)
    return [(a.t1, b.t0) for a, b in zip(rs, rs[1:])]


def replay_gap_ms(g: Group) -> Optional[float]:
    """The median device gap between two consecutive replays, from the
    end of one's last node to the start of the next one's first (the
    median: a profiler started or stopped between two replays makes one
    gap of its own, tens of ms to a minute)."""
    gaps = _gaps(g)
    return None if not gaps else 1e-6 * _median([b - a for a, b in gaps])


def gap_spans(g: Group, look: int = 64) -> Optional[Dict[str, float]]:
    """The gaps between consecutive replays, in seconds, by the innermost
    host span open when each began (``NO_SPAN`` where none was)."""
    gaps = _gaps(g)
    if not gaps:
        return None
    closed = sorted((s for s in g.spans if s[2] >= 0), key=lambda s: s[1])
    starts = np.array([s[1] for s in closed], dtype=np.int64)
    out = defaultdict(float)
    for a, b in gaps:
        j = int(np.searchsorted(starts, a, side="right")) - 1
        label = NO_SPAN
        for k in range(j, max(j - look, -1), -1):
            if closed[k][2] > a:
                label = closed[k][0]
                break
        out[label] += (b - a) * 1e-9
    return dict(out)


def report(g: Group) -> dict:
    """Everything the group holds, reduced: spans, counters, what its calls
    reported and, on the card, the replays' segments."""
    out = {"spans": span_summary(g), "counters": dict(g.counters),
           "info": dict(g.info)}
    if g.stamps is not None:
        out.update(replays=len(replays(g)), segment_ms=segment_ms(g),
                   coverage_pct=coverage_pct(g),
                   replay_gap_ms=replay_gap_ms(g), gap_spans=gap_spans(g))
    return out
