"""The node2vec walk kernel's share of the card's busy time: the profiler's
device time of the kernels whose name holds ``node2vec_walk`` over the busy
time of the traced window (the job's steady replays)."""

NAME = "n2v_walk_pct"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "kernel node2vec_walk: csrc/node2vec_walk.cu"
MOVES = "walks_per_s"


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    hits = [s for k, (s, _) in ctx.trace.kernels.items()
            if "node2vec_walk" in k]
    if not hits:
        return None
    return 100.0 * sum(hits) / ctx.trace.busy_s
