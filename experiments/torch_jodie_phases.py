"""Where a level of the ``jodie_epoch`` kernel spends its time, by ablation,
on one CUDA card.

    python3 experiments/torch_jodie_phases.py [variant ...]

Each variant is a copy of ``smore_tpu_torch/csrc`` under
``build/jodie_phases/<variant>/`` with parts of ``jodie_epoch.cu``'s event
loop cut out; it is built with the port's own nvcc flags and timed with
``chip_smoke._time_ms`` (best of two runs of 3 calls) on the inputs of
``experiments/torch_jodie_levels.py``: the smoke's set and the same events
all on one item ("serial": one event a level) at D=64, the Wikipedia shape
at D=128, each in the layout the kernel chooses. A cut variant computes
something else (or races): only its time counts.

  full             the kernel as it is
  no_cluster_sync  without the cluster barrier of a split event
  no_products      without the cells' products (phase 3)
  no_row_loads     the event's three rows not read (constants instead)
  no_level_barrier the grid barrier between levels a block barrier
  floor            all four cuts: the block barriers, the slots, the BCE
                   step's scalars and the writes

Every variant runs in a process of its own (two libraries that define the
same kernel must not share one). Prints the card's name and power limit
first; needs a card.
"""

from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CLUSTER = [("      if (S > 1) cluster_arrive();", ""),
            ("      if (S > 1) cluster_wait();", "")]
_PRODUCTS = [("for (int qb = 0; qb < O; qb += kGroups) {",
              "for (int qb = 0; qb < 0; qb += kGroups) {")]
_ROWS = [("        const float uv = __ldcg(urow + d), iv = __ldcg(irow + d),\n"
          "                    nv = __ldcg(nrow + d);",
          "        const float uv = 1e-3f * d, iv = 2e-3f, nv = 3e-3f;")]
_LEVEL = [("    level_barrier();\n    lo = hi;",
           "    __syncthreads();\n    lo = hi;")]
VARIANTS = {
    "full": [],
    "no_cluster_sync": _CLUSTER,
    "no_products": _PRODUCTS,
    "no_row_loads": _ROWS,
    "no_level_barrier": _LEVEL,
    "floor": _CLUSTER + _PRODUCTS + _ROWS + _LEVEL,
}
CASES = (("smoke", 64), ("serial", 64), ("wikipedia", 128))


def run_variant(name: str) -> None:
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "experiments"))
    import chip_smoke as cs
    import torch
    import torch_jodie_levels as levels
    from smore_tpu_torch.ops import jodie_epoch as je

    levels.patched_build(os.path.join(HERE, "build", "jodie_phases", name),
                         VARIANTS[name])

    dev = torch.device("cuda", 0)
    parts = []
    for case, dim in CASES:
        tables, args, ig = levels._inputs(case, dim, dev)
        sched = je.level_schedule(ig.user_ids, ig.item_ids, args[2],
                                  ig.n_users, ig.n_items, dev)
        scratch = levels._fresh(tables)
        ms = [cs._time_ms(lambda: je.jodie_epoch(*scratch, *args, sched), 3)
              for _ in range(2)]
        parts.append(f"{case} D={dim} ({sched.n_levels:,} levels) "
                     f"{min(ms):.3f} ms, {min(ms) / sched.n_levels * 1e3:.2f}"
                     f" us a level")
    print(f"{name}: " + "; ".join(parts), flush=True)


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        run_variant(sys.argv[2])
        return
    names = sys.argv[1:] or list(VARIANTS)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for name in names:
        subprocess.run([sys.executable, __file__, "--one", name], check=True)


if __name__ == "__main__":
    main()
