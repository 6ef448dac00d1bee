"""Captured against eager driver calls on one CUDA card, with the profiler.

    python3 experiments/torch_captured_call.py [--out DIR] [--families]

Runs chip_smoke.py's phase 35 (LINE o2 multiblock at Youtube scale, K4;
LINE o2 unbanded on the 50k bench graph at group 8, K1; each trained
eagerly and then on captured calls, 40M samples after 1M), then
``chip_smoke.phase_profile`` of both routes in both modes: torch.profiler
over 16M samples more (40M on the unbanded route, ten calls), the card's
busy and idle share, the torch ops and CUDA launch, memset and copy calls
a driver step. Kernel tables and Chrome traces go to DIR (default
build/captured_call, listed in .gitignore). ``--families`` instead runs
the smoke's in-process phases of the families that train through
``PairModelBase._drive`` (the rec family, phase 22; the community family,
phase 24; the KG and typed-graph families, phase 26, whose KG models,
HAN and FastRP have loops of their own and stay eager) and DeepWalk on
the 20k walk-parity graph at its default budget, four times in turns:
eager, captured, captured, eager, each printing its rates and gates.
Prints the card's name and power limit first; needs a card.
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(HERE, "build",
                                                  "captured_call"))
    ap.add_argument("--families", action="store_true")
    args = ap.parse_args()
    if args.families:
        families()
        return
    from smore_tpu_torch.graph.graph import Graph
    from smore_tpu_torch.models.line import LINE
    from smore_tpu_torch.utils.bench_graphs import (
        make_graph,
        make_youtube_graph,
    )

    device = cs.phase_device()
    cs.phase_build()
    os.makedirs(cs.OUT, exist_ok=True)
    graphs = {}
    for name, make in (("yt_net.txt", make_youtube_graph),
                       ("comm_net_50k.txt", make_graph)):
        path = os.path.join(cs.OUT, name)
        make(path)
        graphs[name] = Graph.load_edge_list(path, undirected=True)
    g_yt, g_50k = graphs["yt_net.txt"], graphs["comm_net_50k.txt"]
    cs.phase_captured_vs_eager(g_yt, g_50k, device)
    for tag, g, kw, millions in (("line_yt", g_yt, {}, 16),
                                 ("line_50k_unbanded", g_50k,
                                  dict(use_pallas=True), 40)):
        for capture in (True, False):
            m = LINE(g, seed=0, device=device)
            m.capture = capture
            m.init(dim=cs.D, order=2)
            name = tag + ("" if capture else "_eager")
            cs.phase_profile(m, args.out, name,
                             run=dict(sample_times=millions, **cs.TRAIN_KW,
                                      **kw), **kw)


def families() -> None:
    import time

    import torch

    from smore_tpu_torch.graph.graph import Graph
    from smore_tpu_torch.models import DeepWalk
    from smore_tpu_torch.models.base import PairModelBase
    from smore_tpu_torch.utils.bench_graphs import make_graph

    device = cs.phase_device()
    cs.phase_build()
    os.makedirs(cs.OUT, exist_ok=True)
    files, sp, tf = cs.rec_files(), cs.structured_files(), cs.typed_files()
    path = os.path.join(cs.OUT, "walk_net.txt")
    make_graph(path, **cs.WALK_GRAPH)
    g_walk = Graph.load_edge_list(path, undirected=True)
    walk_kw = dict(walk_times=10, walk_steps=40, window_size=5,
                   negative_samples=5, alpha=0.025, verbose=False)
    for capture in (False, True, True, False):
        mode = "captured" if capture else "eager"
        PairModelBase.capture = capture
        cs.log(f"=== families, {mode} ===")
        cs.phase_rec(files, device)
        cs.phase_community(sp, files, device)
        cs.phase_typed(tf, device)
        m = DeepWalk(g_walk, seed=0, device=device)
        m.init(dim=cs.D)
        t0 = time.perf_counter()
        m.train(**walk_kw)
        dt = time.perf_counter() - t0
        d = m.last_driver
        cs.log(f"deepwalk ({mode}, 20k walk graph, default budget): "
               f"{d.executed_samples:,} walks in {dt:.3f} s = "
               f"{d.executed_samples / dt:,.0f} walks/s, {d.calls} calls, "
               f"{d.replays} replays [{cs._card()}]")
        torch.cuda.synchronize()
    PairModelBase.capture = True


if __name__ == "__main__":
    main()
