"""The readings that the output check's limits are set from, at a cell's
own size on the card.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3
        [--replay N] [--faults F] [--no-setup] [--out FILE]

For each seed: the run's set-up (the graph, the model, the warm
``train()`` with its first updates recorded), then the output check's
numbers with the program's outputs ("program"), with the control in their
place (the reference computed in TF32: "control") and with each planted
fault ("unchanged": an update that leaves the tables as they were;
"half_batch": half of each batch left out, the mean taken over the rest;
"faulty_draws": negatives drawn from the first half of the vertex ids,
and a negative table of power 1). One JSON line per seed and kind, on standard output and appended to
``--out``. No window runs: the limits are set between the highest
"program" reading over a dozen seeds or more and the lowest reading of the
control and the faults (PERF.md).

With ``--replay N``, before that, the numbers of the window's replays
(``check.replay_numbers``) over N jobs on the seed's graph, each from a
training seed of its own and cut after the call that the output check
keeps: the program's ("replay.program"), the control's
("replay.control"), and, on the first F jobs, those of each replay fault
that needs a run ("replay.stale_alphas", "replay.frozen_rng"; a lost
update reads 1 by its measure).
"""

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from perfbench.harness import main as harness  # noqa: E402
from perfbench.harness import check, faults, replay, spec  # noqa: E402

KINDS = ("program", "control", "unchanged", "half_batch", "faulty_draws")
RUN_FAULTS = ("stale_alphas", "frozen_rng")


def replay_readings(st, cell, device, train_seed: int, fault=None) -> dict:
    """One job from ``train_seed`` on set-up's model, cut after the call
    that the output check keeps, then that check's numbers."""
    model, fam = st.model, st.fam
    model.seed = train_seed
    probe = replay.ReplayProbe(abort=True,
                               from_end=cell.replay.get("from_end"))
    with faults.plant(fault) if fault else contextlib.nullcontext():
        probe.install()
        try:
            fam.job(model, cell, cell.budget)
        except replay.Abort:
            pass
        finally:
            probe.restore()
    rec = probe.rerun(fam)
    kinds = ("program", "control") if fault is None else ("program",)
    out = {(fault or k): check.replay_numbers(probe, rec, device, k)
           for k in kinds}
    out = {k: dict(v, k=probe.k) for k, v in out.items()}
    probe.release()
    return out


def run(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--replay", type=int, default=0)
    p.add_argument("--faults", type=int, default=0)
    p.add_argument("--no-setup", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    def emit(record: dict) -> None:
        line = json.dumps(record)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        st = harness.set_up(cell, seed % (1 << 63), device)
        setup = time.perf_counter() - t
        for i in range(args.replay):
            train_seed = (seed * 1_000_003 + i + 1) % (1 << 63)
            for fault in (None,) + (RUN_FAULTS if i < args.faults else ()):
                t = time.perf_counter()
                got = replay_readings(st, cell, device, train_seed, fault)
                for kind, values in got.items():
                    emit({"workload": cell.name, "seed": seed,
                          "train_seed": train_seed, "kind": f"replay.{kind}",
                          "s": time.perf_counter() - t, **values})
        if not args.no_setup:
            t = time.perf_counter()
            readings = harness.output_check(st, cell, device, KINDS)
            for kind, values in readings.items():
                emit({"workload": cell.name, "seed": seed, "kind": kind,
                      "setup_s": setup, "check_s": time.perf_counter() - t,
                      **values})
        del st
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    harness.configure_caches(ROOT)
    sys.exit(run(sys.argv[1:]))
