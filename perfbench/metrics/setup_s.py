"""Set-up: from the process's start to the end of the warm train(): imports,
the kernels' build (from the checkout's build directory after the first run),
the graph, the model, the sampler and band tables, the edge stream, the first
call and the capture."""

NAME = "setup_s"
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(ctx):
    return ctx.setup_s
