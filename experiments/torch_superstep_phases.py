"""Where the time of the persistent superstep kernels (K4, K5, K3) goes, by
ablation, on one CUDA card.

    python3 experiments/torch_superstep_phases.py [variant ...]

Each variant is a copy of ``smore_tpu_torch/csrc`` under
``build/superstep_phases/<variant>/`` with parts of the kernel's loop in
``sgns_banded_superstep.cuh`` cut out (or switched off); it is built with
the port's own nvcc flags and timed at the main path's shapes
(chip_smoke.py's superstep inputs: S=16, B=2048, band 16400, Ks=128, D=64,
K5 with 3280-row windows; K3 at the fused route's B=4096, band 16392: one
micro-step of two 2048-row tiles) with chip_smoke._time_ms, best of two
runs of 20 calls (K3: 50). A cut variant computes something else: its
tables are not checked, only its time.

  full           the kernel as it is
  no_reduce      without the d_neg reduction (K4's at the end, K5's per
                 step; K3's atomics of its register tiles, whose sums stay
                 in phase A)
  no_phase_b     without phase B's scatters and the reduction
  barriers_only  without phase A, phase B and the reduction: the grid
                 barriers and the per-step staging of cn

Differences between neighbours give the reduction, phase B and phase A;
barriers_only is the floor of the barriers. Every variant runs in a process
of its own (two libraries that define the same kernel must not share one).
Prints the card's name and power limit first; needs a card.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = "sgns_banded_superstep.cuh"
_REDUCE = ("      if (kNb && last_tile) reduce_dneg<kNb>(p, 1, wrow, work);\n"
           "      if (!kNb && last && !(kInline && p.inline_dneg))\n"
           "        reduce_dneg<kNb>(p, p.S, wrow, work);\n")
# K3's d_neg: the atomics of its register tiles (their sums stay in phase
# A); the block stays, its condition is made false
_FLUSH = ("      if (kInline && p.inline_dneg && last && dtile >= 0) {\n",
          "      if (false) {\n")
_PHASE_B = "      phase_b(p, s, row0, keep0);\n"
_PHASE_A = ("      phase_a<kInline>(p, s, row0, keep0, scn, work, lacc, dacc, "
            "dtile);\n")
VARIANTS = {
    "full": [],
    "no_reduce": [_REDUCE, _FLUSH],
    "no_phase_b": [_REDUCE, _FLUSH, _PHASE_B],
    "barriers_only": [_REDUCE, _FLUSH, _PHASE_B, _PHASE_A],
}


def run_variant(name: str) -> None:
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    import torch
    from smore_tpu_torch.ops import _build
    from smore_tpu_torch.ops import sgns_banded as sb

    out = os.path.join(HERE, "build", "superstep_phases", name)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC, os.path.join(out, "csrc"))
    path = os.path.join(out, "csrc", HEADER)
    with open(path) as f:
        src = f.read()
    for cut in VARIANTS[name]:
        old, new = cut if isinstance(cut, tuple) else (cut, "")
        if old not in src:
            raise RuntimeError(f"{name}: {old!r} is not in {HEADER}")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)
    _build.CSRC = os.path.join(out, "csrc")
    os.environ["SMORE_TPU_TORCH_BUILD_DIR"] = os.path.join(out, "lib")

    dev = torch.device("cuda", 0)
    x = cs._superstep_inputs(0, dev)
    xn = cs._nb_superstep_inputs(0, dev)
    t4 = [cs._time_ms(lambda: sb.sgns_banded_multiblock(
        *(x[k] for k in cs._ARGS), band_size=cs.BAND), 20) for _ in range(2)]
    t5 = [cs._time_ms(lambda: sb.sgns_banded_multiblock_nb(
        *(xn[k] for k in cs._NB_ARGS), band_size=cs.BAND, nb2=cs.NB2), 20)
        for _ in range(2)]
    xf = cs._fused_inputs(cs.B_FUSED, cs.B_FUSED, dev)
    t3 = [cs._time_ms(lambda: sb.sgns_banded_fused(
        *(xf[k] for k in cs._ARGS)), 50) for _ in range(2)]
    print(f"{name}: K4 {min(t4):.4f} ms {t4}  K5 {min(t5):.4f} ms {t5}  "
          f"K3 {min(t3):.4f} ms {t3}", flush=True)


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
