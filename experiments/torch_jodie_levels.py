"""Time the PyTorch port's ``jodie_epoch`` kernel on one NVIDIA card, in
the layout it chooses and in others, on three interaction sets, and the
kernel of another checkout (the parent commit) on the same inputs.

Sets: the smoke's (``utils/seq_data.make_interactions``: 8,000 events, 40
users, 60 items), the same events all on one item ("serial": one event a
level) and the JODIE paper's Wikipedia shape
(``seq_data.interaction_arrays(**seq_data.WIKIPEDIA)``: 8,227 users, 1,000
items, 157,474 events, 172 feature columns), at dims 64 and 128. For each:
JODIE's init (seed 0), one epoch's negatives from a seeded generator, the
schedule's host time (``level_schedule``: the negatives to the host, the
C++ levels, the copies back), the kernel's device time per layout (CUDA
events behind a spin, ``chip_smoke._time_ms``), the levels, their widths,
the bound (``chip_smoke._jodie_bound``) and the share of it. One JSON line
a measurement, beside the card's name and power limit, on the standard
output (and appended to ``--out FILE``).

Layouts: ``chosen`` (the kernel as it is), ``split1``, ``split2``,
``split4``, ``split8`` (that many blocks an event, whatever D and the
widest level) and ``cluster`` (one block an event, and between levels the
barrier of ONE cluster of up to 8 blocks that is the whole grid, in place
of the grid's). All but ``chosen`` are copies of ``smore_tpu_torch/csrc``
under ``build/jodie_levels/<layout>/`` with ``jodie_epoch.cu`` patched
(``patched_build``), each timed in a process of its own (two libraries
that define the same kernel must not share one); their tables and loss
are held to the chosen layout's (rtol 1e-4, atol 1e-5).

With ``--parent DIR`` (a checkout whose ``jodie_epoch`` takes no
schedule) the same inputs go, at dim 64, through DIR's kernel in a child
process, before and after this checkout's (parent, change, change, parent).

Run on the card:
    python experiments/torch_jodie_levels.py [--parent DIR] [--out FILE]
        [--layouts chosen,split1,split2,split4,split8,cluster]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(ROOT, "build", "jodie_levels")
SOURCE = "jodie_epoch.cu"


def _split(n: int):
    return [("  int split = 1;\n  while (split < kMaxSplit &&",
             f"  int split = {n};\n  while (false &&")]


_CLUSTER = _split(1) + [
    ("void level_barrier() { cg::this_grid().sync(); }",
     "void level_barrier() {\n  cluster_arrive();\n  cluster_wait();\n}"),
    ("  pl->grid = (width < units ? width : units) * split;",
     "  pl->grid = width < kMaxSplit ? width : kMaxSplit;"),
    ("  at[0].val.cooperative = 1;", "  at[0].val.cooperative = 0;"),
    ("  at[1].val.clusterDim.x = pl.split;",
     "  at[1].val.clusterDim.x = pl.grid;"),
    ("  cfg.numAttrs = pl.split > 1 ? 2 : 1;", "  cfg.numAttrs = 2;"),
]
LAYOUTS = {"chosen": [], **{f"split{n}": _split(n) for n in (1, 2, 4, 8)},
           "cluster": _CLUSTER}
LR, BCE = 0.05, 0.2


def patched_build(out: str, patches) -> None:
    """Make this process build and load ``jodie_epoch.cu`` with
    ``patches`` ((old, new) text pairs, each old found once) from a copy of
    the port's csrc under ``out``."""
    from smore_tpu_torch.ops import _build

    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC, os.path.join(out, "csrc"))
    path = os.path.join(out, "csrc", SOURCE)
    with open(path) as f:
        src = f.read()
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"{old!r} is not once in {SOURCE}")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)
    _build.CSRC = os.path.join(out, "csrc")
    os.environ["SMORE_TPU_TORCH_BUILD_DIR"] = os.path.join(out, "lib")


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def _inputs(name: str, dim: int, device):
    """(tables, args, graph) of one epoch of set ``name`` at ``dim``."""
    import torch

    from smore_tpu_torch.graph.bipartite import InteractionGraph
    from smore_tpu_torch.models import JODIE
    from smore_tpu_torch.utils import seq_data as sd

    if name in ("smoke", "serial"):
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        ig = InteractionGraph.load_interactions(sd.make_interactions(
            os.path.join(ROOT, "build", "jodie_levels_events.txt")))
        if name == "serial":  # every event on one item: one a level
            ig = InteractionGraph.from_events(
                ig.user_ids, np.zeros_like(ig.item_ids), ig.timestamps)
    else:
        ig = InteractionGraph.from_events(*sd.interaction_arrays(
            **sd.WIKIPEDIA))
    m = JODIE(ig, seed=0, device=device)
    m.init(dim)
    gen = torch.Generator(device).manual_seed(1)
    negs = torch.randint(0, ig.n_items, (ig.n_interactions,), generator=gen,
                         device=device, dtype=torch.int32)
    uid, iid, cu, ci = m.scan_inputs(m.state)
    tables = [m.state["user_static"], m.state["item_static"]]
    args = (uid, iid, negs, cu, ci, m.state["user_rnn"], m.state["item_rnn"],
            LR, BCE)
    return tables, args, ig


def _fresh(tables):
    ue, ie = (t.clone() for t in tables)
    return [ue, ie, ue.clone(), ie.clone()]


def _bound(T, U, I, D):
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    return cs._jodie_bound(T, U, I, D)["bound_ms"]


def _emit(row: dict, out) -> None:
    line = json.dumps(row)
    print(line, flush=True)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "a") as f:
            f.write(line + "\n")


def _time(call, reps):
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    return cs._time_ms(call, reps)


def _reps(T: int) -> int:
    return 5 if T < 20000 else 3


def _want_path(name: str, dim: int) -> str:
    return os.path.join(WORK, f"want_{name}_{dim}.npz")


def _cases(a):
    return [(name, dim) for name in a.sets.split(",")
            for dim in map(int, a.dims.split(","))]


def child(path: str, reps: int) -> None:
    """Time this process's ``jodie_epoch`` (another checkout's, first on
    sys.path) on the inputs saved at ``path``; print one JSON line and save
    its tables beside them."""
    import torch

    from smore_tpu_torch.ops import jodie_epoch as je

    dev = torch.device("cuda", 0)
    x = np.load(path)
    t = {k: torch.from_numpy(x[k]).to(dev) for k in x.files}
    cell = {c: {"Wh": t[f"{c}_wh"], "Wx": t[f"{c}_wx"]} for c in "ui"}
    args = (t["uid"], t["iid"], t["negs"], t["cu"], t["ci"], cell["u"],
            cell["i"], LR, BCE)
    out = _fresh([t["ue"], t["ie"]])
    je.jodie_epoch(*out, *args)
    torch.cuda.synchronize()
    scratch = _fresh([t["ue"], t["ie"]])
    ms = _time(lambda: je.jodie_epoch(*scratch, *args), reps)
    np.savez(path[:-4] + "_out.npz", *(a.cpu().numpy() for a in out))
    print(json.dumps({"ms": ms}), flush=True)


def _parent(parent: str, path: str, reps: int) -> float:
    parent = os.path.abspath(parent)
    env = dict(os.environ, PYTHONPATH=parent)
    r = subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                        path, "--reps", str(reps)], env=env, cwd=parent,
                       capture_output=True, text=True, timeout=1200)
    if r.returncode != 0:
        raise RuntimeError(f"parent kernel failed:\n{r.stdout}\n{r.stderr}")
    return json.loads(r.stdout.strip().splitlines()[-1])["ms"]


def run_layout(layout: str, a, card: str) -> None:
    """Time the patched ``layout`` on every case; its tables and loss held
    to the chosen layout's, saved by the main process."""
    import torch

    if LAYOUTS[layout]:
        patched_build(os.path.join(WORK, layout), LAYOUTS[layout])
    from smore_tpu_torch.ops import jodie_epoch as je

    dev = torch.device("cuda", 0)
    for name, dim in _cases(a):
        tables, args, ig = _inputs(name, dim, dev)
        T, U, I = ig.n_interactions, ig.n_users, ig.n_items
        sched = je.level_schedule(ig.user_ids, ig.item_ids, args[2], U, I,
                                  dev)
        want = np.load(_want_path(name, dim))
        got = _fresh(tables)
        loss = je.jodie_epoch(*got, *args, sched)
        err = 0.0
        for k, x in enumerate(got + [loss]):
            y = torch.from_numpy(want[f"arr_{k}"]).to(dev)
            err = max(err, float((x - y).abs().max()))
            torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-5)
        scratch = _fresh(tables)
        ms = [_time(lambda: je.jodie_epoch(*scratch, *args, sched),
                    _reps(T)) for _ in range(2)]
        bound = _bound(T, U, I, dim)
        _emit(dict(set=name, dim=dim, events=T, users=U, items=I,
                   levels=sched.n_levels, mean_width=T / sched.n_levels,
                   max_width=sched.max_width, bound_ms=bound, card=card,
                   layout=dict(name=layout,
                               **je.kernel_plan(dim, sched.max_width)),
                   ms=ms, share=bound / min(ms),
                   max_abs_err_vs_chosen=err), a.out)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", metavar="DIR")
    ap.add_argument("--child", metavar="NPZ", help=argparse.SUPPRESS)
    ap.add_argument("--layout", help=argparse.SUPPRESS)
    ap.add_argument("--reps", type=int, default=3, help=argparse.SUPPRESS)
    ap.add_argument("--sets", default="smoke,serial,wikipedia")
    ap.add_argument("--dims", default="64,128")
    ap.add_argument("--layouts", default=",".join(LAYOUTS))
    ap.add_argument("--out", metavar="FILE",
                    help="also append the JSON lines to FILE")
    a = ap.parse_args()
    if a.child:
        child(a.child, a.reps)
        return
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_jodie_levels: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = _card()
    if a.layout:
        run_layout(a.layout, a, card)
        return
    from smore_tpu_torch.ops import jodie_epoch as je

    dev = torch.device("cuda", 0)
    print(card, flush=True)
    os.makedirs(WORK, exist_ok=True)
    for name, dim in _cases(a):
        tables, args, ig = _inputs(name, dim, dev)
        T, U, I = ig.n_interactions, ig.n_users, ig.n_items
        sched_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            sched = je.level_schedule(ig.user_ids, ig.item_ids, args[2], U,
                                      I, dev)
            torch.cuda.synchronize()
            sched_ms.append((time.perf_counter() - t0) * 1e3)
        L = sched.n_levels
        bound = _bound(T, U, I, dim)
        reps = _reps(T)
        want = _fresh(tables)
        lw = je.jodie_epoch(*want, *args, sched)
        np.savez(_want_path(name, dim),
                 *(x.cpu().numpy() for x in want + [lw]))
        row = dict(set=name, dim=dim, events=T, users=U, items=I,
                   levels=L, mean_width=T / L, max_width=sched.max_width,
                   schedule_ms=sorted(sched_ms), bound_ms=bound, card=card)
        parent_ms = []
        path = None
        if a.parent and dim == 64 and name != "serial":
            path = os.path.join(WORK, f"parent_{name}_{dim}.npz")
            st = {"ue": tables[0], "ie": tables[1], "uid": args[0],
                  "iid": args[1], "negs": args[2], "cu": args[3],
                  "ci": args[4], "u_wh": args[5]["Wh"],
                  "u_wx": args[5]["Wx"], "i_wh": args[6]["Wh"],
                  "i_wx": args[6]["Wx"]}
            np.savez(path, **{k: v.cpu().numpy() for k, v in st.items()})
            parent_ms.append(_parent(a.parent, path, max(1, reps - 2)))
        if "chosen" in a.layouts.split(","):
            scratch = _fresh(tables)
            ms = [_time(lambda: je.jodie_epoch(*scratch, *args, sched),
                        reps) for _ in range(2)]
            _emit(dict(row, layout=dict(name="chosen", **je.kernel_plan(
                dim, sched.max_width)), ms=ms, share=bound / min(ms),
                max_abs_err_vs_chosen=0.0), a.out)
        if path:
            parent_ms.append(_parent(a.parent, path, max(1, reps - 2)))
            old = np.load(path[:-4] + "_out.npz")
            err = max(float(np.abs(old[f"arr_{k}"] - w.cpu().numpy())
                            .max()) for k, w in enumerate(want))
            _emit(dict(row, layout="parent", ms=parent_ms,
                       share=bound / min(parent_ms),
                       max_abs_err_vs_chosen=err), a.out)
    for layout in a.layouts.split(","):
        if layout != "chosen":
            cmd = [sys.executable, os.path.abspath(__file__), "--layout",
                   layout, "--sets", a.sets, "--dims", a.dims]
            subprocess.run(cmd + (["--out", a.out] if a.out else []),
                           check=True)


if __name__ == "__main__":
    main()
