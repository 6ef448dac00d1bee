"""Seconds of Graph.from_arrays on the generated edges (harness span)."""

NAME = "graph_s"
UNIT = "s"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "graph: graph/graph.py Graph.from_arrays"
MOVES = "setup_s"


def read(ctx):
    return ctx.spans.get("graph")
