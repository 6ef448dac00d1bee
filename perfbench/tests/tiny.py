"""The benchmark's cells at sizes a CPU test holds: the same configurations
and code paths (LINE's multiblock route forced where the card would take
it by size), small graphs and budgets, and the walk models' calls cut to
one step, so that every job has calls after the first two (the card's
replays, which the output check keeps one of)."""

import copy

from perfbench.harness import spec

TINY = {
    "line_o2.youtube": ({"law": "youtube", "n": 20_000, "e": 60_000,
                         "n_comm": 20}, 0.6, 0.3),
    "line_o2.flickr": ({"law": "community", "n": 3_000, "e": 40_000,
                        "n_comm": 20}, 1.2, 1.2),
    "deepwalk.youtube": ({"law": "youtube", "n": 2_000, "e": 6_000,
                          "n_comm": 20}, 3, 0.3),
    "deepwalk.flickr": ({"law": "community", "n": 3_000, "e": 40_000,
                         "n_comm": 20}, 3, 1),
}


def cell(name: str) -> spec.Cell:
    c = spec.cell(name)
    graph, job, warm = TINY[name]
    c.traffic = copy.deepcopy(c.traffic)
    c.traffic["graph"] = graph
    key = "sample_times" if c.family == "line" else "walk_times"
    c.traffic["jobs"][c.family] = {key: job}
    c.traffic["warm"][c.family] = {key: warm}
    if c.family == "walk":
        c.config = dict(c.config, train=dict(c.config["train"],
                                             steps_per_call=1))
    if name == "line_o2.youtube":
        # the route the card takes from 262,144 vertices, on a small graph
        c.config = dict(c.config, train=dict(c.config["train"], banded=True,
                                             multiband=True))
    return c
