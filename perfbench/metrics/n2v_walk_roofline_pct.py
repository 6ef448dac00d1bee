"""The node2vec walk kernel's share of its roofline: the least time of one
launch, its bytes over 3.35 TB/s, over the profiler's mean device time a
launch of the kernels whose name holds ``node2vec_walk``. The bytes are
those the second-order law needs, whatever implements it: each 32-B sector
it reads counted once a launch (``families/node2vec.py``
``launch_bytes_of``, a replay of the rejection rule on the recorded walks,
left on the recorder by the output check). The kernel's float32
operations, one product a draw and one an acceptance test, are negligible
beside them and are not counted."""

NAME = "n2v_walk_roofline_pct"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernel node2vec_walk: csrc/node2vec_walk.cu"
MOVES = "walks_per_s"


def read(ctx):
    from perfbench.harness.flops import bound_ms

    if ctx.trace is None:
        return None
    nbytes = getattr(ctx.recorder, "n2v_launch_bytes", None)
    hits = [v for k, v in ctx.trace.kernels.items() if "node2vec_walk" in k]
    launches = sum(c for _, c in hits)
    if not nbytes or not launches:
        return None
    ms = 1e3 * sum(s for s, _ in hits) / launches
    least, _ = bound_ms(0.0, nbytes)
    return 100.0 * least / ms
