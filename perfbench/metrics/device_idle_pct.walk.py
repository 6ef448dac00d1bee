"""Share of the traced window (a job's replays after its capture) with no
kernel, copy or memset on the card."""

from perfbench.harness import readers

NAME = "device_idle_pct.walk"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device: the card"
MOVES = "walks_per_s"


def read(ctx):
    if not readers.of_family(ctx, "walks"):
        return None
    return readers.idle_pct(ctx)
