"""The calls of the models with loops of their own, captured against eager,
at several call lengths, on one CUDA card.

    python3 experiments/torch_own_loop_call.py [--calls default,epoch,8,1]
        [--models transe,han,sasrec] [--profile DIR] [--sums ordered,atomic]

For each call length (``default``: each model's own ``steps_per_call``;
``epoch``: an epoch's steps in one call; or a number of steps) runs
chip_smoke.py's phase 36 on the chosen models (TransE, RotatE, ComplEx at
FB15k-237's shape, one warm-up epoch then 5 timed; HAN at DBLP's, 2
epochs; SASRec, gSASRec, Rec-Denoiser at ML-1M's, 3 epochs):
eager and captured from seed 0, the captured run's split into the eager
first call, the captures and the replays, the host's ms a replay, each
graph's node count, the captured state held to the eager one. A length
whose capture fails prints CUDA's message and the next one runs. With
``--profile DIR`` it then profiles TransE, HAN and SASRec in both modes at
the models' own call lengths (``chip_smoke.phase_profile``: the card's idle
share, the torch ops and CUDA launch calls a step; tables and traces to
DIR). ``--eager-twice`` first trains each model eagerly twice from seed 0
and prints how far the two runs' tables part. ``--sums ordered,atomic``
first times each chosen KG model's captured run at its own call length
twice: its duplicate rows summed in index order (``kg._add_rows``'s
sorted accumulate) and by ``index_add_``'s atomics. Prints the card's name
and power limit first; needs a card.
"""

from __future__ import annotations

import argparse
import os
import sys
import traceback

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", default="default,epoch,8,1",
                    help="call lengths: 'default' (each model's own), "
                    "'epoch' or a number of steps; '' for none")
    ap.add_argument("--models", default=",".join(cs.OWN_LOOP_MODELS))
    ap.add_argument("--profile", metavar="DIR")
    ap.add_argument("--eager-twice", action="store_true",
                    help="first train each model eagerly twice from one "
                    "seed and print how far the two runs part")
    ap.add_argument("--sums", default="",
                    help="'ordered' and / or 'atomic': time the KG models' "
                    "captured runs with each way of summing duplicate rows")
    args = ap.parse_args()
    device = cs.phase_device()
    f = cs.own_loop_files()
    models = tuple(args.models.split(","))
    for model in models:
        for way in filter(None, args.sums.split(",")):
            if cs.OWN_LOOP_MODELS[model][0] == "kg":
                sums(model, f, device, way == "ordered")
    if args.eager_twice:
        for model in models:
            a, b = (cs.own_loop_run(model, f, device, False)
                    for _ in range(2))
            want = cs.own_loop_state(a["m"])
            errs = {k: float((cs.own_loop_state(b["m"])[k] - v).abs().max())
                    for k, v in want.items()}
            cs.log(f"{model}, eager twice from seed 0: max |diff| "
                   f"{max(errs.values()):.3e} ({max(errs, key=errs.get)}) "
                   f"[{cs._card()}]")
    for length in filter(None, args.calls.split(",")):
        # an epoch: a call longer than any epoch
        k = (None if length == "default" else 1 << 30 if length == "epoch"
             else int(length))
        cs.log(f"=== a call of {length} steps ===")
        for model in models:
            family = cs.OWN_LOOP_MODELS[model][0]
            try:
                cs.phase_own_loops(f, device, {family: k}, (model,))
            except RuntimeError:  # a capture the card refused: report it
                cs.log(f"{model}, a call of {length} steps, failed:\n"
                       f"{traceback.format_exc()}")
    if args.profile:
        profile(f, device, args.profile)


def sums(model: str, f: dict, device, ordered: bool) -> None:
    """A KG model's captured run (phase 36's, without the eager twin) with
    its duplicate rows summed in index order or by atomics."""
    from smore_tpu_torch import models

    cls = dict(transe=models.TransE, rotate=models.RotatE,
               complex=models.ComplEx)[model]
    own = cls._ordered_sums
    cls._ordered_sums = ordered
    try:
        r = cs.own_loop_run(model, f, device, True)
    finally:
        cls._ordered_sums = own
    c = r["calls"]
    way = "in index order" if ordered else "by index_add_'s atomics"
    cs.log(f"{model}, duplicate rows summed {way}: captured "
           f"{r['rate']:.1f} steps/s, the replays alone "
           f"{r['replay_rate']:.1f} steps/s (the eager first call "
           f"{1e3 * c.first_call_s:.1f} ms, {len(c.nodes)} capture(s) "
           f"{1e3 * c.capture_s:.1f} ms; host {r['host_ms']:.3f} ms a "
           f"replay; graph nodes {r['nodes']}) [{cs._card()}]")


def profile(f: dict, device, out_dir: str) -> None:
    for model in ("transe", "han", "sasrec"):
        for capture in (True, False):
            m, kw, per_epoch, per_step = cs.own_loop_model(model, f,
                                                           device)
            m.capture = capture
            epochs = kw["epochs"]
            name = f"{model}_full" + ("" if capture else "_eager")
            cs.phase_profile(m, out_dir, name, warm=dict(kw, epochs=1),
                             run=kw, steps=(epochs * per_epoch, per_step,
                                            cs.OWN_LOOP_MODELS[model][1]))


if __name__ == "__main__":
    main()
