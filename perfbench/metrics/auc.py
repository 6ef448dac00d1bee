"""Community AUC (cosine, planted communities) of the last job's vertex table,
taken after the window."""

NAME = "auc"
UNIT = "AUC"
BETTER = "higher"
SOURCE = "host_clock"


def read(ctx):
    return ctx.auc
