"""Where the time of the shared-negative gradient kernel (K1,
``smore_tpu_torch/csrc/sgns_shared_grads.cu``) goes, by ablation, on one
CUDA card.

    python3 experiments/torch_k1_phases.py [variant ...]

Each variant is a copy of ``smore_tpu_torch/csrc`` under
``build/k1_phases/<variant>/`` with parts of the kernel's tile loop cut out;
it is built with the port's own nvcc flags and timed at the unbanded path's
shapes (chip_smoke.py's: B=32768, Ks=128, D=64) with chip_smoke._time_ms,
best of two runs of 50 calls. A cut variant computes something else: its
outputs are not checked, only its time.

  full          the kernel as it is
  no_flush      without the final atomic adds of the blocks' d_neg
  no_dneg       also without the per-tile g_neg^T v product
  no_src        also without d_src and d_pos
  loads_only    also without the logits and g_pos: cn staging, the tile
                loads, the block barriers and the grid barrier

Differences between neighbours give each part. Every variant runs in a
process of its own. Prints the card's name and power limit first; needs a
card.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = "sgns_shared_grads.cu"
_FLUSH = ("    atomicAdd(reinterpret_cast<float4*>(p.d_neg + i * 4), "
          "ld4s(sdn + i * 4));\n")
_DNEG = "    dneg_tile<kD>(p, nrows, v_s, sg, sdn);\n"
_SRC = "    src_pos<kD>(p, t, nrows, v_s, cp_s, scn, sg, sgp);\n"
_LOGITS = ("    logits<kD>(p, v_s, scn, sg, scale);\n"
           "    positives<kD>(p, v_s, cp_s, sgp, a);\n")
VARIANTS = {
    "full": [],
    "no_flush": [_FLUSH],
    "no_dneg": [_FLUSH, _DNEG],
    "no_src": [_FLUSH, _DNEG, _SRC],
    "loads_only": [_FLUSH, _DNEG, _SRC, _LOGITS],
}


def run_variant(name: str) -> None:
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    import numpy as np
    import torch
    from smore_tpu_torch.ops import _build
    from smore_tpu_torch.ops import sgns

    out = os.path.join(HERE, "build", "k1_phases", name)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC, os.path.join(out, "csrc"))
    path = os.path.join(out, "csrc", SOURCE)
    with open(path) as f:
        src = f.read()
    for cut in VARIANTS[name]:
        if cut not in src:
            raise RuntimeError(f"{name}: {cut!r} is not in {SOURCE}")
        # an empty statement keeps a loop without braces well formed
        src = src.replace(cut, ";\n")
    with open(path, "w") as f:
        f.write(src)
    _build.CSRC = os.path.join(out, "csrc")
    os.environ["SMORE_TPU_TORCH_BUILD_DIR"] = os.path.join(out, "lib")

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(1)
    v, cp, cn = (torch.from_numpy((rng.standard_normal(s) * 0.3).astype(
        np.float32)).to(dev) for s in ((cs.B_UNBANDED, cs.D),
                                       (cs.B_UNBANDED, cs.D), (cs.KS, cs.D)))
    alpha = torch.tensor(0.025, device=dev)
    t = [cs._time_ms(lambda: sgns.sgns_shared_grads(v, cp, cn, alpha), 50)
         for _ in range(2)]
    print(f"{name}: K1 {min(t):.4f} ms {t}", flush=True)


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
