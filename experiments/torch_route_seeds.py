"""Community AUC and samples/s of one LINE route of the PyTorch port at
Youtube scale, over several seeds, on one CUDA card.

    python3 experiments/torch_route_seeds.py --kw '{"neg_band": true}' \
        --seeds 0 1 2 [--nb2 16400] [--samples 40]

Each seed builds its model and tables afresh (``LINE(g, seed=s)``), trains
1M samples (tables, stream, warm-up), re-initialises the tables, trains
``--samples`` million more and prints the route, samples/s and
``bench.yt_community_auc``. ``--nb2`` builds the banded negative law with
that window before training (the ``neg_band`` route otherwise takes 3280
rows). Prints the card's name and power limit first; needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import bench  # noqa: E402  (numpy-only at import)
from smore_tpu_torch.graph.graph import Graph  # noqa: E402
from smore_tpu_torch.models.line import LINE  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kw", default="{}", help="LINE.train keywords, JSON")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--nb2", type=int, default=0)
    ap.add_argument("--samples", type=float, default=40)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(json.loads(args.kw), negative_samples=5, alpha=0.025,
              verbose=False)
    out = os.path.join(HERE, "build", "route_seeds")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "yt_net.txt")
    bench.make_youtube_graph(path)
    g = Graph.load_edge_list(path, undirected=True)
    aucs = []
    for seed in args.seeds:
        m = LINE(g, seed=seed, device="cuda")
        m.init(dim=64, order=2)
        m.train(sample_times=1, **kw)
        if args.nb2:
            m.banded_tables.build_neg_bands(g, nb2=args.nb2)
        m.init(dim=64, order=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.train(sample_times=args.samples, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        d = m.last_driver
        auc = bench.yt_community_auc(m.state["vertex"].cpu().numpy(), g.names)
        aucs.append(auc)
        bt = m.banded_tables
        print(f"seed {seed} {args.kw} window {bt.nb2 if bt else 0} step "
              f"{d.step_fn.__qualname__.split('.<')[0]}: "
              f"{d.executed_samples / dt:,.0f} samples/s, community AUC "
              f"{auc:.4f}", flush=True)
    sd = np.std(aucs, ddof=1) if len(aucs) > 1 else 0.0
    print(f"{args.kw} nb2 {args.nb2 or 'default'}: AUC mean "
          f"{np.mean(aucs):.4f} sd {sd:.4f} over seeds {args.seeds}",
          flush=True)


if __name__ == "__main__":
    main()
