"""Chip smoke test of the PyTorch port: builds the CUDA kernels and drives
LINE order 2 at Youtube scale on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU path):
  1. device: a CUDA card must be present; prints its name and power limit
  2. build: compiles smore_tpu_torch/csrc/*.cu with nvcc (first use)
  3. kernel vs twin at the main path's shapes (S=16 micro-steps, B=2048,
     band 16400, Ks=128, D=64, 68 x 16400 table rows): tables, d_neg and
     loss must agree, and both times are printed
  4. main path: the 1.1M-vertex Youtube-scale graph (bench.make_youtube_graph)
     -> Graph.load_edge_list -> LINE(order 2, dim 64) -> train(40M samples,
     5 negatives, alpha 0.025, every other argument at its default), all on
     the card; the kernel must have been launched, the tables must be
     finite and the community AUC (bench.yt_community_auc) >= 0.58
The last two lines are the kernel table and the result, each one JSON
object. Files go to build/chip_smoke/ inside the checkout.

    python3 chip_smoke.py --profile DIR

also profiles 4M more samples of the main path with torch.profiler and
writes the kernel-time table and a Chrome trace to DIR (a measurement aid,
off by default so that the smoke does not depend on the profiler).
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

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "build", "chip_smoke")

# main-path shapes: LINE o2 multiblock defaults at Youtube scale
S, B, BAND, N_BANDS, KS, D = 16, 2048, 16400, 68, 128, 64
# Atomics sum duplicate rows in an order that changes from run to run, and
# every later tile gathers those sums, so the kernel is held to its twin at
# f32 round-off scale, not bit for bit.
RTOL, ATOL = 1e-4, 1e-5
SAMPLE_TIMES = 40  # millions of samples: the JAX package's quality gate
AUC_MIN = 0.58  # JAX record 0.6106 +- 0.0068 less bench.py's 0.03 margin


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok: bool, what: str) -> None:
    """A check that also holds under ``python -O``."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def phase_device() -> torch.device:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "False); this test runs only on the card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")
    # the twin's matmuls must run in full f32, like the kernel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def phase_build() -> None:
    from smore_tpu_torch.ops import _build
    from smore_tpu_torch.ops import sgns_banded

    t0 = time.perf_counter()
    sgns_banded._load()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for line in _build.build_info["sgns_banded_multiblock"][1].splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


def _superstep_inputs(seed: int, device):
    """Random inputs at the main path's shapes, with duplicate rows: half
    of each step's indices come from 64 hot rows of its band."""
    rng = np.random.default_rng(seed)
    n = BAND * N_BANDS
    src = rng.integers(0, BAND, (S, B))
    pos = rng.integers(0, BAND, (S, B))
    hot = rng.integers(0, BAND, 64)
    half = rng.random((S, B)) < 0.5
    src = np.where(half, hot[rng.integers(0, 64, (S, B))], src)
    pos = np.where(half, hot[rng.integers(0, 64, (S, B))], pos)
    sb = rng.integers(0, N_BANDS, S)
    db = rng.integers(0, N_BANDS, S)
    sb[5], db[5] = sb[2], db[2]  # a revisited band pair
    db[7] = sb[7]  # a step with sb == db
    x = dict(
        wv=(rng.standard_normal((n, D)) * 0.1).astype(np.float32),
        wc=(rng.standard_normal((n, D)) * 0.1).astype(np.float32),
        sb=sb.astype(np.int32), db=db.astype(np.int32),
        src_l=src.astype(np.int32), pos_l=pos.astype(np.int32),
        cn=(rng.standard_normal((S, KS, D)) * 0.1).astype(np.float32),
        alpha=np.linspace(0.025, 0.02, S).astype(np.float32),
    )
    return {k: torch.from_numpy(v).to(device) for k, v in x.items()}


_ARGS = ("wv", "wc", "sb", "db", "src_l", "pos_l", "cn", "alpha")


def _time_ms(fn, x, reps: int) -> float:
    fn(*(x[k] for k in _ARGS), band_size=BAND)  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn(*(x[k] for k in _ARGS), band_size=BAND)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernel_vs_twin(device) -> dict:
    from smore_tpu_torch.ops.sgns_banded import (
        sgns_banded_multiblock,
        sgns_banded_multiblock_ref,
    )

    x = _superstep_inputs(0, device)
    y = {k: v.clone() for k, v in x.items()}
    kv, kc, kd, kl = sgns_banded_multiblock(*(x[k] for k in _ARGS),
                                            band_size=BAND)
    rv, rc, rd, rl = sgns_banded_multiblock_ref(*(y[k] for k in _ARGS),
                                                band_size=BAND)
    torch.cuda.synchronize()
    err = 0.0
    for name, got, want in (("wv", kv, rv), ("wc", kc, rc), ("d_neg", kd, rd)):
        g, w = got.cpu().numpy(), want.cpu().numpy()
        require(np.isfinite(g).all(), f"{name}: kernel output not finite")
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                   err_msg=f"kernel vs twin: {name}")
        err = max(err, float(np.abs(g - w).max()))
    np.testing.assert_allclose(float(kl), float(rl), rtol=RTOL,
                               err_msg="kernel vs twin: loss")
    log(f"kernel vs twin (S={S} B={B} band={BAND} Ks={KS} D={D}): "
        f"max |diff| {err:.3e} within rtol {RTOL} atol {ATOL}; "
        f"loss {float(kl):.6f} vs {float(rl):.6f}")
    # alternate plain, kernel, kernel, plain on the same card
    t_plain = [_time_ms(sgns_banded_multiblock_ref, y, 5)]
    t_kern = [_time_ms(sgns_banded_multiblock, x, 20) for _ in range(2)]
    t_plain.append(_time_ms(sgns_banded_multiblock_ref, y, 5))
    ms, plain_ms = min(t_kern), min(t_plain)
    log(f"superstep time: kernel {ms:.4f} ms {t_kern}, twin "
        f"{plain_ms:.4f} ms {t_plain} ({S * B} samples each)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def phase_main_path(device):
    sys.path.insert(0, HERE)
    import bench  # numpy-only at import; its measure_* functions use JAX
    from smore_tpu_torch.graph.graph import Graph
    from smore_tpu_torch.models.line import LINE
    from smore_tpu_torch.ops.sgns_banded import sgns_banded_multiblock

    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, "yt_net.txt")
    t0 = time.perf_counter()
    bench.make_youtube_graph(path)
    g = Graph.load_edge_list(path, undirected=True)
    log(f"graph: {g.n_vertices:,} vertices {g.n_edges:,} directed edges "
        f"({time.perf_counter() - t0:.1f} s to make and load)")
    kw = dict(negative_samples=5, alpha=0.025, verbose=False)
    m = LINE(g, seed=0, device=device)
    m.init(dim=D, order=2)
    t0 = time.perf_counter()
    m.train(sample_times=1, **kw)  # builds the band tables + stream, warms up
    torch.cuda.synchronize()
    log(f"warm-up: 1M samples incl. band tables and stream "
        f"{time.perf_counter() - t0:.1f} s")
    d = m.last_driver
    bt = m.banded_tables
    log(f"route: multiblock batch {d.samples_per_step // d.micro_steps} "
        f"micro-steps {d.micro_steps} steps/call {d.steps_per_call} band "
        f"{bt.band_size} bands {bt.n_bands} stream entries "
        f"{bt.stream.numel():,}")

    m.init(dim=D, order=2)  # fresh tables; the band tables are kept
    sgns_banded_multiblock.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m.train(sample_times=SAMPLE_TIMES, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = sgns_banded_multiblock.launches
    executed = m.last_driver.executed_samples
    log(f"main path: {executed:,} samples in {dt:.3f} s = "
        f"{executed / dt:,.0f} samples/s; kernel launches {launches}")
    require(launches > 0, "the main path never launched the kernel")

    wv = m.state["vertex"].cpu().numpy()
    wc = m.state["context"].cpu().numpy()
    require(wv.shape == wc.shape == (g.n_vertices, D),
            f"table shapes {wv.shape} {wc.shape}")
    require(np.isfinite(wv).all() and np.isfinite(wc).all(),
            "non-finite tables")
    auc = bench.yt_community_auc(wv, g.names)
    log(f"community AUC at {SAMPLE_TIMES}M samples: {auc:.4f} "
        f"(gate >= {AUC_MIN})")
    require(auc >= AUC_MIN, f"community AUC {auc:.4f} < {AUC_MIN}")
    emb = os.path.join(OUT, "line_o2_yt.txt")
    m.save_weights(emb)
    with open(emb) as f:
        header = f.readline().split()
    require(header == [str(g.n_vertices), str(D)],
            f"embedding file header {header}")
    log(f"saved {emb}")
    return m, launches


def phase_profile(m, out_dir: str) -> None:
    """Kernel time by name and the card's busy share over 4M samples."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    kw = dict(negative_samples=5, alpha=0.025, verbose=False)
    m.train(sample_times=1, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m.train(sample_times=4, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avg = prof.key_averages()
    table = avg.table(sort_by="self_device_time_total", row_limit=25)
    with open(os.path.join(out_dir, "line_yt_profile.txt"), "w") as f:
        f.write(table)
    prof.export_chrome_trace(os.path.join(out_dir, "line_yt_trace.json"))
    busy = sum(e.self_device_time_total for e in avg) / 1e6
    samples = m.last_driver.executed_samples
    log(f"profile: {samples:,} samples, wall {wall:.3f} s, device busy "
        f"{busy:.3f} s ({100 * busy / wall:.1f}%), idle "
        f"{100 * (1 - busy / wall):.1f}%")
    log(table)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile the main path; write results to DIR")
    args = ap.parse_args()
    t_start = time.perf_counter()
    device = phase_device()
    phase_build()
    kt = phase_kernel_vs_twin(device)
    m, launches = phase_main_path(device)
    if args.profile:
        phase_profile(m, args.profile)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "sgns_banded_multiblock",
        "route": "cuda",
        "source": "smore_tpu_torch/csrc/sgns_banded_multiblock.cu",
        "replaces": "smore_tpu/ops/pallas_sgns_banded.py:933",
        "launches": launches,
        "max_abs_err": kt["max_abs_err"],
        "ms": kt["ms"],
        "plain_ms": kt["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
