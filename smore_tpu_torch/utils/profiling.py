"""Profiling and tracing helpers.

Port of ``smore_tpu/utils/profiling.py``:
  - ``PhaseTimer``: wall-clock time per named phase, with a report;
  - ``trace``: a context manager around ``torch.profiler`` that writes a
    Chrome trace of the block (CPU and, where there is a card, CUDA
    activity) to ``logdir``;
  - ``throughput``: samples a second.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator


class PhaseTimer:
    """Accumulates wall time per phase name."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        total = sum(self.totals.values()) or 1e-12
        lines = ["phase                 total_s   calls   share"]
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(
                f"{name:<20} {t:8.3f} {self.counts[name]:7d} "
                f"{100 * t / total:6.1f}%"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Profile the block with torch.profiler and write its Chrome trace to
    ``logdir/trace.json`` (open it in chrome://tracing or Perfetto)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def throughput(n_samples: int, seconds: float) -> float:
    return n_samples / max(seconds, 1e-12)
