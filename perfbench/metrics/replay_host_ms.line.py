"""The host's ms issuing one replay of a captured call (TrainDriver's
replay_host_s / replays) in the traced job."""

from perfbench.harness import readers

NAME = "replay_host_ms.line"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "driver: models/base.py TrainDriver, CapturedCalls"
MOVES = "samples_per_s"


def read(ctx):
    if not readers.of_family(ctx, "samples") or ctx.trace is None:
        return None
    return readers.replay_host_ms(ctx)
