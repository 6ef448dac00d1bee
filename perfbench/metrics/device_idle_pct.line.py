"""Share of the traced window (a job's replays after its capture) with no
kernel, copy or memset on the card."""

from perfbench.harness import readers

NAME = "device_idle_pct.line"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device: the card"
MOVES = "samples_per_s"


def read(ctx):
    if not readers.of_family(ctx, "samples"):
        return None
    return readers.idle_pct(ctx)
