"""One run of one cell: set-up, the measured window (or the traced job),
the output check, and the result line.

Set-up (``setup_s``, from the process's start): imports, the graph made
from ``--seed`` (``graphs``) and handed to ``Graph.from_arrays``, the model
built from the seed, and one warm ``train()`` at the cell's warm-up budget
(``spec.Cell.warm``), which builds the kernels (served from the
checkout's build directory after the first run), the sampler and band
tables and the edge stream, and runs the first call and the capture. The
output check records that ``train()``'s first updates (``record``).

Window (``--trace 0``): whole jobs back to back, each ``init`` then
``train()`` at the cell's job budget (``spec.Cell.budget``), until
``--seconds`` have passed; the job in flight at the deadline finishes and
counts. A rate is all the jobs' work over the wall time from the first
job's start to the last one's end, ended by ``torch.cuda.synchronize()``.
The AUC is read from the last job's vertex table afterwards. While the
window runs, the output check keeps one replay of each job (``replay``);
after it, and after the card's memory peak has been read, the last job's
kept call runs again eagerly, and the program's state is freed before the
reference runs.

Traced run (``--trace 1``): one job, its replays after the capture under
``torch.profiler`` (``trace``), read by the per-layer metrics; the output
check the same.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
import types
from typing import Dict, Optional

from perfbench.harness import check, graphs, probes, replay, spec, trace
from perfbench.harness.record import Recorder

# top-level module names that no run may have loaded: JAX and the JAX
# package (compared whole: "smore_tpu_torch" is not "smore_tpu")
FORBIDDEN = {"jax", "jaxlib", "flax", "smore_tpu"}


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _job_stats(driver, t0: float) -> dict:
    return {"work": int(driver.executed_samples),
            "wall_s": time.perf_counter() - t0,
            "calls": int(driver.calls), "replays": int(driver.replays),
            "first_call_s": float(driver.first_call_s),
            "capture_s": float(driver.capture_s),
            "replay_s": float(driver.replay_s),
            "replay_host_s": float(driver.replay_host_s)}


def power_limit() -> Optional[float]:
    """The card's power limit in W (``nvidia-smi``), None where it cannot
    be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.split("\n")[0])
    except (OSError, subprocess.SubprocessError, ValueError):
        return None


def set_up(cell: spec.Cell, seed: int, device) -> types.SimpleNamespace:
    """The graph from ``seed``, the model, and set-up's warm ``train()``
    with the output check's recorder on its first updates."""
    from smore_tpu_torch.graph.graph import Graph

    fam = spec.family(cell.family, cell.root)
    spans: Dict[str, float] = {}

    @contextlib.contextmanager
    def span(name):
        t = time.perf_counter()
        yield
        spans[name] = time.perf_counter() - t

    with span("graph_gen"):
        arrays = graphs.make(cell.traffic["graph"], seed)
    with span("graph"):
        g = Graph.from_arrays(arrays.src, arrays.dst, arrays.weights,
                              arrays.names, arrays.name2id)
    model = fam.build(g, seed, cell, device)
    rec = Recorder()
    fam.hooks(rec)
    try:
        with span("warm_train"):
            fam.job(model, cell, cell.warm)
            _sync(device)
    finally:
        rec.restore()
    return types.SimpleNamespace(fam=fam, arrays=arrays, model=model,
                                 rec=rec, spans=spans)


def card_state() -> str:
    """The card's clocks, power and temperature (``nvidia-smi``), for the
    run's standard error; empty where they cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
             "temperature.gpu,clocks_throttle_reasons.active",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.split("\n")[0].strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def output_check(st, cell: spec.Cell, device, kinds=("program",)) -> dict:
    """Free the program's state, then the output check's readings of each
    of ``kinds`` (``check.readings``)."""
    import torch

    from perfbench.reference import laws

    derived = st.fam.derived(st.model)
    st.model = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    L = laws.GraphLaws(st.arrays.src, st.arrays.dst, st.arrays.weights,
                       len(st.arrays.names), device)
    return {k: check.readings(st.rec, derived, L, st.fam, cell, k)
            for k in kinds}


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device, t_start: float) -> dict:
    """Everything of a run after the look for a chip; returns the result
    line's object (``checks`` last)."""
    import torch

    seed = int(seed) % (1 << 63)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)  # the allocator, before its reset
        torch.cuda.reset_peak_memory_stats(device)
    st = set_up(cell, seed, device)
    fam, model = st.fam, st.model
    setup_s = time.perf_counter() - t_start

    budget = cell.budget
    jobs, summary, auc = [], None, None
    probe = replay.ReplayProbe(from_end=cell.replay.get("from_end"))
    probe.install()
    try:
        if traced:
            t = time.perf_counter()
            summary = trace.traced(lambda: fam.job(model, cell, budget),
                                   device)
            jobs.append(dict(_job_stats(model.last_driver, t),
                             wall_s=summary.wall_s))
            wall = summary.wall_s
        else:
            t0 = time.perf_counter()
            while True:
                t = time.perf_counter()
                probe.forget()
                fam.job(model, cell, budget)
                _sync(device)
                jobs.append(_job_stats(model.last_driver, t))
                if time.perf_counter() - t0 >= seconds:
                    break
            wall = time.perf_counter() - t0
    finally:
        probe.restore()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    for i, j in enumerate(jobs):
        print(f"perfbench: job {i} {json.dumps(j)}", file=sys.stderr)
    if device.type == "cuda":
        print(f"perfbench: card after the window {card_state()}",
              file=sys.stderr)
    if not traced:
        emb = model.state["vertex"].detach().cpu().numpy()
        auc = probes.community_auc(emb, st.arrays.label)
    replayed = probe.rerun(fam)
    probe.release()
    del model
    values = output_check(st, cell, device)["program"]
    rep = check.replay_numbers(probe, replayed, device)
    values.update(rep)
    values["detail"]["replay"] = rep
    correct, rows = check.verdict(values, cell.limits)

    ctx = types.SimpleNamespace(
        cell=cell, family=fam, setup_s=setup_s, spans=st.spans, jobs=jobs,
        wall_s=wall, work=sum(j["work"] for j in jobs), auc=auc,
        trace=summary, recorder=st.rec)
    wanted = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = spec.metric_reader(m["name"], cell.root).read(ctx)
        if value is None:
            if not traced:
                raise RuntimeError(f"end-to-end metric {m['name']} read "
                                   "nothing")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": cell.chips,
           "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        dev["power_limit_w"] = power_limit()
    result = {"correct": bool(correct), "attempted": len(jobs), "failed": 0,
              "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    print(f"perfbench: output check detail {json.dumps(values['detail'])}",
          file=sys.stderr)
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result


def main(argv, t_start: float) -> int:
    args = parse(argv)
    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("perfbench: no CUDA device (torch.cuda.is_available() is "
              "False); the benchmark runs only on the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), t_start)
    return emit(result)


def emit(result: dict, out=None, err=None) -> int:
    """Print the compared numbers as the last lines of standard error and
    the result as the last line of standard output; refuse (no result,
    code 3) where JAX or the JAX package has been loaded."""
    out, err = out or sys.stdout, err or sys.stderr
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {bad}: JAX and the JAX package "
              "have no place in the benchmark", file=err)
        return 3
    for k, c in result["checks"].items():
        ok = math.isfinite(c["value"]) and c["value"] <= c["limit"]
        print(f"check {k} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if ok else 'FAIL'}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0


def configure_caches(root: str) -> None:
    """Every build and kernel cache of the program at a fixed directory
    inside the checkout, so that only a checkout's first run builds."""
    cache = os.path.join(root, "perfbench", "_cache")
    for var, sub in (("SMORE_TPU_TORCH_BUILD_DIR", "build"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)
