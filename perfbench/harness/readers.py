"""What the metric readers (``perfbench/metrics/<name>.py``) share. A
reader's ``read(ctx)`` returns its number, or None where its cell gives it
nothing to read (the harness then leaves the metric out of the line).

``ctx``: ``cell``, ``family`` (the family module; ``WORK`` names what its
jobs count), ``setup_s``, ``spans`` (seconds of the harness's spans around
the calls into the program: ``graph``, ``warm_train``), ``jobs`` (each
job's ``TrainDriver`` counters), ``wall_s`` and ``work`` (the window's, or
the traced job's), ``auc``, ``trace`` (``trace.TraceSummary`` of the traced
job, else None) and ``recorder`` (what set-up's first updates recorded).
"""

from __future__ import annotations

from perfbench.harness.flops import PEAK_F32


def of_family(ctx, work: str) -> bool:
    return ctx.family.WORK == work


def one_time_ms(ctx):
    """The eager first call plus the capture of a job, in ms, mean over
    the jobs."""
    return 1e3 * sum(j["first_call_s"] + j["capture_s"]
                     for j in ctx.jobs) / len(ctx.jobs)


def replay_host_ms(ctx):
    """The host's ms issuing one replay, over the jobs' replays."""
    replays = sum(j["replays"] for j in ctx.jobs)
    if replays == 0:
        return None
    return 1e3 * sum(j["replay_host_s"] for j in ctx.jobs) / replays


def idle_pct(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def mfu_pct(ctx):
    """The SGNS operations the traced job's work needs, over its wall and
    the float32 peak."""
    if ctx.trace is None:
        return None
    flops = ctx.family.flops(ctx.cell, ctx.work)
    return 100.0 * flops / (ctx.trace.wall_s * PEAK_F32)
