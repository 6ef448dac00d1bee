"""The one-time cost of a job's train(): the eager first call plus the capture
(TrainDriver's first_call_s + capture_s), ms, mean over the traced job(s)."""

from perfbench.harness import readers

NAME = "one_time_ms.walk"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "driver: models/base.py TrainDriver, CapturedCalls"
MOVES = "walks_per_s"


def read(ctx):
    if not readers.of_family(ctx, "walks") or ctx.trace is None:
        return None
    return readers.one_time_ms(ctx)
