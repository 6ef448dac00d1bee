"""Walks trained a second: all the window's DeepWalk jobs' walks over the wall
from the first job's start to the last one's end."""

from perfbench.harness import readers

NAME = "walks_per_s"
UNIT = "walks/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(ctx):
    if not readers.of_family(ctx, "walks") or ctx.trace is not None:
        return None
    return ctx.work / ctx.wall_s
