"""The layer split of the benchmark's cells by the port's tracer
(``smore_tpu_torch/utils/profiling.py``), and what the tracer costs.

Runs the benchmark's own run of a cell (``perfbench/harness/main.run_cell``)
with the tracer switched on or off around it. Needs the card:

    python experiments/torch_layer_split.py split --workload <cell> --seed <n>
        [--seconds 51]
    python experiments/torch_layer_split.py cost --workload <cell> --seed <n>
        --tracer 0|1 [--seconds 51]
    python experiments/torch_layer_split.py nodes --workload <cell> --seed <n>
        [--root <checkout>]

- ``split``: a traced run (``--trace 1``'s job under ``torch.profiler``)
  with the tracer on from before set-up; prints the result line and, under
  ``"layers"``, the per-layer metrics of ``METRICS`` and the tracer's report
  of set-up's ``train()`` and of the traced job.
- ``cost``: an untraced run (the measured window) with the tracer on or
  off; prints the result line and, with the tracer on, ``"layers"`` of the
  window's last job.
- ``nodes``: set-up and one job with the tracer off (the program of
  ``--root``, this checkout by default); prints each captured graph's node
  count and the kernel launches a replay credits.

Each prints one JSON line on standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LINE_CELLS = ["line_o2.youtube", "line_o2.flickr"]
WALK_CELLS = ["deepwalk.youtube", "deepwalk.flickr", "node2vec.youtube",
              "node2vec.flickr"]
ALL_CELLS = LINE_CELLS + WALK_CELLS


# the per-layer metrics a benchmark reader of the tracer would report:
# (unit, cells, what it reads, of which segments or spans). "share": the
# median over the traced job's replays of the stamped step's device time in
# the segments; "gap": the median device gap between its consecutive replays;
# "job_ms": the spans' ms in the traced job; "setup_s": the spans' seconds
# in set-up's train()
METRICS = {
    "walk_pct": ("%", WALK_CELLS, "share", ["walk.draw"]),
    "update_pct.walk": ("%", WALK_CELLS, "share", ["walk.update"]),
    "update_pct.line": ("%", ["line_o2.flickr"], "share", ["line.update"]),
    "superstep_ops_pct": ("%", ["line_o2.youtube"], "share",
                          ["line.draw", "line.snapshot", "line.neg_add"]),
    "replay_gap_ms.line": ("ms", LINE_CELLS, "gap", None),
    "replay_gap_ms.walk": ("ms", WALK_CELLS, "gap", None),
    "capture_prep_ms.line": ("ms", LINE_CELLS, "job_ms", ["capture.prepare"]),
    "capture_prep_ms.walk": ("ms", WALK_CELLS, "job_ms", ["capture.prepare"]),
    "stream_build_s": ("s", ["line_o2.youtube"], "setup_s",
                       ["banded.stream"]),
    "tables_build_s": ("s", ALL_CELLS, "setup_s",
                       ["sampler.build", "banded.build", "banded.neg_bands"]),
}


def read(name: str, cell: str, setup, job):
    """Metric ``name`` in ``cell`` from the tracer's group of set-up's
    ``train()`` and of a job's (None where missing); None where the metric
    does not apply or finds nothing to read."""
    from smore_tpu_torch.utils import profiling as P

    _, cells, how, names = METRICS[name]
    if cell not in cells or (setup if how == "setup_s" else job) is None:
        return None
    if how == "share":
        return P.share_pct(job, names)
    if how == "gap":
        return P.replay_gap_ms(job)
    if how == "job_ms":
        s = P.span_s(job, names)
        return None if s is None else 1e3 * s
    return P.span_s(setup, names)


def _bench(root: str):
    sys.path.insert(0, root)
    from perfbench.harness import main as bench

    bench.configure_caches(root)
    return bench


def _run(args, traced: bool, tracer: bool) -> dict:
    """The benchmark's run of the cell with the tracer on or off; with it
    on, the metrics of ``METRICS`` and the reports of set-up's group and
    of the last job's under ``"layers"``."""
    import torch

    bench = _bench(ROOT)
    from perfbench.harness import spec
    from smore_tpu_torch.utils import profiling as P

    cell = spec.cell(args.workload)
    setup = []
    set_up = bench.set_up

    def kept_set_up(*a, **kw):
        st = set_up(*a, **kw)
        setup.extend(P.groups()[-1:])
        return st

    bench.set_up = kept_set_up
    P.reset()
    if tracer:
        P.enable()
    result = bench.run_cell(cell, args.seed, args.seconds, traced,
                            torch.device("cuda", 0), T_START)
    P.disable()
    result["tracer"] = int(tracer)
    if tracer:
        s, j = setup[0], P.groups()[-1]
        result["layers"] = {
            "metrics": {n: read(n, cell.name, s, j) for n in METRICS},
            "setup": P.report(s), "job": P.report(j)}
    return result


def split(args) -> dict:
    return _run(args, traced=True, tracer=True)


def cost(args) -> dict:
    return _run(args, traced=False, tracer=bool(args.tracer))


def nodes(args) -> dict:
    """Set-up and one job of the program under ``--root``, tracer off."""
    import torch

    bench = _bench(args.root)
    from perfbench.harness import spec
    from smore_tpu_torch.models import base

    cell = spec.cell(args.workload)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    loops = []
    orig = base.CapturedCalls.close

    def close(self):
        orig(self)
        loops.append({"nodes": {str(k): v for k, v in self.nodes.items()},
                      "credit": {str(k): {kern.name: n for kern, n in c}
                                 for k, c in self._credit.items()},
                      "calls": self.calls, "replays": self.replays})

    base.CapturedCalls.close = close
    st = bench.set_up(cell, args.seed, device)
    st.fam.job(st.model, cell, cell.budget)
    return {"root": args.root, "workload": cell.name, "loops": loops}


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("mode", choices=("split", "cost", "nodes"))
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--tracer", type=int, choices=(0, 1), default=0)
    p.add_argument("--root", default=ROOT)
    args = p.parse_args(argv)
    out = {"split": split, "cost": cost, "nodes": nodes}[args.mode](args)
    print(json.dumps(out, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
