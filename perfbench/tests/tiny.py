"""The benchmark's cells at sizes a CPU test holds, from the ``tiny`` key of
each cell's ``workloads/<cell>.json``: the same configurations and code
paths at a small graph (``graph``), small job and warm-up budgets
(``jobs``, ``warm``) and any ``train`` overrides (LINE's multiblock route
forced where the card would take it by size; the walk models' calls cut to
one step), so that every job has calls after the first two (the card's
replays, which the output check keeps one of)."""

from perfbench.harness import spec


def names(root: str = spec.ROOT) -> list:
    """Every cell of BENCHMARK.json."""
    return [w["name"] for w in spec.benchmark(root)["workloads"]]


def cell(name: str, root: str = spec.ROOT) -> spec.Cell:
    c = spec.cell(name, root)
    small = c.work["tiny"]
    c.traffic = dict(c.traffic, graph=small["graph"])
    c.work = dict(c.work, jobs=small["jobs"], warm=small["warm"])
    if "train" in small:
        c.config = dict(c.config, train=dict(c.config["train"],
                                             **small["train"]))
    return c
