"""Edge samples trained a second: all the window's LINE jobs' samples over
the wall from the first job's start to the last one's end."""

from perfbench.harness import readers

NAME = "samples_per_s"
UNIT = "samples/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(ctx):
    if not readers.of_family(ctx, "samples") or ctx.trace is not None:
        return None
    return ctx.work / ctx.wall_s
