"""The whole step's share of the card's float32 peak: the SGNS operations
that the traced job's work needs (perfbench/harness/flops.py), over its wall
and 67 TFLOP/s."""

from perfbench.harness import readers

NAME = "mfu_pct.walk"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = "whole step"
MOVES = "walks_per_s"


def read(ctx):
    if not readers.of_family(ctx, "walks"):
        return None
    return readers.mfu_pct(ctx)
