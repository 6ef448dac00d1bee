"""Kernel K4's share of its roofline: the least time of a superstep (the
larger of its float32 operations over 67 TFLOP/s and its bytes over
3.35 TB/s, from the recorded supersteps' shapes and distinct rows) over the
profiler's device time of one launch of sgns_ss::superstep<0>."""

NAME = "k4_roofline_pct"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernel K4: csrc/sgns_banded_multiblock.cu"
MOVES = "samples_per_s"


def read(ctx):
    from perfbench.harness.flops import bound_ms, k4_bytes, sgns_flops

    if ctx.trace is None:
        return None
    hits = [v for k, v in ctx.trace.kernels.items() if "superstep<0>" in k]
    launches = sum(c for _, c in hits)
    ups = [u for u in ctx.recorder.updates if u["kind"] == "superstep"]
    if not launches or not ups:
        return None
    ms = 1e3 * sum(s for s, _ in hits) / launches
    s, b = ups[0]["src"].shape
    ks = ups[0]["negs"].shape[1]
    d = ctx.cell.config["init"]["dim"]
    rows = sum(int(u["src"].unique().numel() + u["pos"].unique().numel())
               for u in ups) / len(ups)
    least, _ = bound_ms(sgns_flops(s * b, ks, d), k4_bytes(rows, s, b, ks, d))
    return 100.0 * least / ms
