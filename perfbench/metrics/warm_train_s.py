"""Seconds of set-up's warm train(): the sampler and band tables, the edge
stream, the first call, the capture and its replays (harness span)."""

NAME = "warm_train_s"
UNIT = "s"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "models: models/line.py, models/deepwalk.py, models/walk_base.py"
MOVES = "setup_s"


def read(ctx):
    return ctx.spans.get("warm_train")
