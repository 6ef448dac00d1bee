"""Chip smoke test of the PyTorch port: builds the CUDA kernels and drives
LINE's banded routes at Youtube scale and its unbanded path on the
50k-vertex bench graph, on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU path):
  1. device: a CUDA card must be present; prints its name and power limit
  2. build: compiles smore_tpu_torch/csrc/*.cu with nvcc, one process per
     source, all started together (first use)
  3. K4 vs twin at the banded path's shapes (S=16 micro-steps, B=2048,
     band 16400, Ks=128, D=64, 68 x 16400 table rows) and on the
     all-collide inputs of tests/torch_superstep_inputs.py (every source
     and positive row one vertex): tables, d_neg and loss must agree. One
     call must be ONE CUDA kernel launch as torch.profiler counts them (the
     persistent superstep kernel); its co-resident grid, ptxas registers
     and spills, both times, the bound and the share of it are printed
  4. K5 vs twin at the same shapes with 3280-row negative windows, hot
     duplicate rows in src, pos and the negatives, a window inside its own
     step's context band, one inside the previous step's and a revisited
     one, and on the all-collide inputs (negatives in a window of the
     collided band): tables and loss must agree; the same launch count and
     prints
  5. K1 vs twin at the unbanded path's shapes (B=32768, Ks=128, D=64):
     d_src, d_pos and d_neg must agree; one call must be ONE CUDA launch
     (the persistent kernel of csrc/sgns_shared_grads.cu); its grid, ptxas
     report, both times, the bound and the share of it are printed
  6. K3 vs twin at the fused route's shapes (57 x 16392-row tables,
     B=4096 and 32768, Ks=128, D=64) and on the all-collide inputs (two
     2048-row tiles on one row): bands, d_neg and loss must agree; one
     call must be ONE CUDA launch of the superstep kernel; the same prints
     as K4's; then K4's all-collide check again, so that K3, K4 and K5 have
     launched cooperatively in this one process
  7. K2 vs twin and index_add_ at the order-1 route's shapes (B=32768,
     band 32776 of a 29-band table, D=64), random and all-same rows: the
     three must agree; their times are printed
  8. banded main path: the 1.1M-vertex Youtube-scale graph
     (smore_tpu_torch.utils.bench_graphs.make_youtube_graph, the port's copy
     of bench.py's) -> Graph.load_edge_list -> LINE(order 2, dim 64) ->
     train(40M samples, 5 negatives, alpha 0.025, every other argument at
     its default), all on the card; K4 must have been launched, the tables
     must be finite and the community AUC (bench_graphs.yt_community_auc)
     >= 0.58
  9. the same graph on the unbanded route (banded=False, use_pallas=True),
     40M samples: a measurement beside phase 8; K1 must have been launched
     and the tables must be finite
 10. the fused route: LINE o2 train(multiband=False), every other argument
     at its default (band 16392, batch 4096, group 1, hoist 8); K3 must
     have been launched, the tables finite, the community AUC >= 0.57
 11. LINE order 1 at its defaults (1D band tables at band 32776, group 8,
     hoist 8, batch 32768, the scatter-only route): K2 launched, a finite
     table; its AUC is printed
 12. LINE o2 with multiband=False, use_pallas="scatter" (K2 on both 2D
     scatters, band 32776, batch 32768): K2 launched, finite tables; a
     measurement
 13. the neg_band route: LINE o2 train(neg_band=True), every other
     argument at its default (the multiblock route with 3280-row negative
     windows): K5 launched once per superstep, K4 never, finite tables,
     the community AUC >= 0.57
 14. the held fused route: train(multiband=False, band_hold=True) (band
     16392, batch 4096, one stratum held for 8 micro-steps): K3 launched,
     finite tables, the community AUC >= 0.55
 15. the held scatter-only route: train(multiband=False, band_hold=True,
     use_pallas="scatter") (band 32776, batch 32768, hold 8): K2 launched,
     finite tables; its AUC is printed beside the JAX package's
 16. unbanded main path: the 50k-vertex bench graph (make_graph) ->
     LINE(order 2, dim 64) -> train(40M samples, 5 negatives, alpha 0.025,
     use_pallas=True, every other argument at its default: batch 32768,
     group 8, hoist 32); K1 must have been launched, the tables must be
     finite and the community AUC >= 0.99
 17. the same with group=1 (per-step draws), same gates
 18. order 1 with use_pallas=True, 40M samples: K1 launched, a finite
     table; its AUC is printed
Each path runs 1M samples first (tables, stream and warm-up), then every
kernel's launch count is set to 0, read after the timed 40M run and
printed. The last two lines are the kernel table (with each kernel's
least possible time on the card, its bound) and the result, each one JSON
object. Files go to build/chip_smoke/ inside the checkout.

    python3 chip_smoke.py --profile DIR

also profiles 4M more samples of the multiblock, fused, order-1,
neg_band, held fused, held scatter-only and unbanded main paths with
torch.profiler and writes the kernel-time tables
and Chrome traces to DIR (a measurement aid, off by default so that the
smoke does not depend on the profiler).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "build", "chip_smoke")
# the all-collide superstep inputs that the tests hold the twins to the
# Pallas kernels with (numpy only)
sys.path.append(os.path.join(HERE, "tests"))
from torch_superstep_inputs import (  # noqa: E402
    ALL_COLLIDE,
    ALL_COLLIDE_FUSED,
    ALL_COLLIDE_NB,
    fused_inputs,
    multiblock_inputs,
    multiblock_nb_inputs,
)

# banded shapes: LINE o2 multiblock defaults at Youtube scale; neg_band
# route's negative window
S, B, BAND, N_BANDS, KS, D = 16, 2048, 16400, 68, 128, 64
NB2 = 3280
# unbanded shapes: LINE defaults on the 50k graph (batch 32768)
B_UNBANDED = 32768
# fused route: band 16392 (57 bands at Youtube scale), batch 4096 (two
# 2048-row tiles); order-1 route: band 32776 (29 bands), batch 32768
FUSED_BAND, FUSED_BANDS, B_FUSED = 16392, 57, 4096
SCAT_BAND, SCAT_BANDS, B_SCAT = 32776, 29, 32768
# Atomics sum duplicate rows (K4) and d_neg (K1) in an order that changes
# from run to run, and K4's later tiles gather those sums, so each kernel
# is held to its twin at f32 round-off scale, not bit for bit.
RTOL, ATOL = 1e-4, 1e-5
SAMPLE_TIMES = 40  # millions of samples: the JAX package's quality gate
AUC_MIN = 0.58  # JAX record 0.6106 +- 0.0068 less bench.py's 0.03 margin
# fused route at 40M: JAX records 0.606 (PERF_NOTES.md:493) and 0.6022
# (BASELINE.md:96) less the same 0.03 margin
AUC_MIN_FUSED = 0.57
# neg_band route: JAX 0.6033 at window 3280 (smore_tpu/models/line.py:410-412)
# less the 0.03 margin; held fused route: JAX 0.585 for "fused b=4096
# hold=8" (PERF_NOTES.md:492) less 0.03. The held scatter-only route is
# printed beside the JAX package's 0.557 at hold 8 (line.py:387), ungated.
AUC_MIN_NB = 0.57
AUC_MIN_HOLD = 0.55
AUC_JAX_HOLD_SCATTER = 0.557
# 50k bench graph: the JAX package reached 1.0000 at 40M with group 8 and
# group 1 (PERF_NOTES.md), and sits near 0.57 at 20M
AUC_MIN_50K = 0.99
TRAIN_KW = dict(negative_samples=5, alpha=0.025, verbose=False)
# the card's peaks for the bound (NVIDIA's H100 SXM data sheet): f32 on the
# CUDA cores, HBM3 bandwidth
PEAK_F32, PEAK_BYTES = 67e12, 3.35e12


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
    # the twins' matmuls must run in full f32, like the kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _counters():
    """The launch-counting wrappers of every kernel, by kernel name."""
    from smore_tpu_torch.ops.scatter import band_scatter_add
    from smore_tpu_torch.ops.sgns import sgns_shared_grads
    from smore_tpu_torch.ops.sgns_banded import (
        sgns_banded_fused,
        sgns_banded_multiblock,
        sgns_banded_multiblock_nb,
    )

    return {f.__name__: f for f in (sgns_banded_multiblock, sgns_shared_grads,
                                    sgns_banded_fused, band_scatter_add,
                                    sgns_banded_multiblock_nb)}


def phase_build() -> None:
    from smore_tpu_torch.ops import _build, scatter, sgns, sgns_banded

    loaders = (sgns_banded._load, sgns._load, sgns_banded._load_fused,
               scatter._load, sgns_banded._load_nb)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(loaders)) as ex:
        for f in [ex.submit(load) for load in loaders]:
            f.result()
    log(f"build: {time.perf_counter() - t0:.2f} s for all {len(loaders)} "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name in ("sgns_banded_multiblock", "sgns_shared_grads",
                 "sgns_banded_fused", "band_scatter_add",
                 "sgns_banded_multiblock_nb"):
        secs, report = _build.build_info[name]
        log(f"  {name}: {secs:.2f} s")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")


_SLEEP_CYCLES_PER_MS = None


def _sleep_cycles_per_ms() -> float:
    """The card's clock as torch.cuda._sleep counts it (measured once)."""
    global _SLEEP_CYCLES_PER_MS
    if _SLEEP_CYCLES_PER_MS is None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)  # warm-up
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        torch.cuda.synchronize()
        _SLEEP_CYCLES_PER_MS = 10_000_000 / start.elapsed_time(end)
    return _SLEEP_CYCLES_PER_MS


def _time_ms(call, reps: int) -> float:
    """Device time per call: CUDA events around ``reps`` calls that are all
    enqueued while the card is still busy with a spin of twice their
    enqueue time, so that the host's launch rate does not enter the time
    (a host slower than the card would otherwise leave it idle between
    launches)."""
    call()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * host_ms + 1) * _sleep_cycles_per_ms()))
    start.record()
    for _ in range(reps):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _alternate(plain, kernel, reps_plain: int, reps_kernel: int):
    """plain, kernel, kernel, plain on the same card; best of each."""
    t_plain = [_time_ms(plain, reps_plain)]
    t_kern = [_time_ms(kernel, reps_kernel) for _ in range(2)]
    t_plain.append(_time_ms(plain, reps_plain))
    return min(t_kern), t_kern, min(t_plain), t_plain


def _bound(name: str, flops: float, nbytes: float) -> dict:
    """The least time the card could take for the work: the larger of the
    operations over the f32 peak and the bytes over the HBM rate."""
    t_ops, t_bytes = flops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    log(f"{name} bound: {flops / 1e9:.4f} GFLOP -> {t_ops:.4f} ms, "
        f"{nbytes / 1e6:.2f} MB -> {t_bytes:.4f} ms")
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def _sgns_flops(samples: int, ks: int, d: int) -> float:
    """v.cp, v cn^T, g_pos cp + g_neg cn, g_pos v and g_neg^T v per
    sample, as multiply-adds counted twice."""
    return samples * (6 * ks * d + 4 * d)


def _rows(*ids) -> int:
    """Distinct table rows among index arrays (each read and written once)."""
    return int(np.unique(np.concatenate(
        [np.asarray(i).ravel() for i in ids])).size)


def _compare(name, got, want) -> float:
    g, w = got.cpu().numpy(), want.cpu().numpy()
    require(np.isfinite(g).all(), f"{name}: kernel output not finite")
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                               err_msg=f"kernel vs twin: {name}")
    return float(np.abs(g - w).max())


# host calls that put work on the card, as torch.profiler names them
_RUNTIME_WORK = ("cudaLaunch", "cuLaunch", "cudaMemset", "cudaMemcpy")


def _cuda_work(call, calls: int = 3) -> tuple:
    """What ``calls`` calls of ``call`` put on the card, as torch.profiler
    records it (after a warm-up call): the host's launch, memset and copy
    calls, and the names of the device kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    events = prof.events()
    host = [e.name for e in events if e.name.startswith(_RUNTIME_WORK)]
    kernels = [e.name for e in events if e.device_type == DeviceType.CUDA]
    return host, kernels


def _launch_report(tag: str, name: str, kernel, device_kernel: str,
                   grid: int, smem: int) -> None:
    """A persistent kernel's CUDA launches per call (must be 1: the host's
    launch calls, one cooperative launch a call; the device may record
    fewer kernels, never another kernel: no memset, copy or sum), its grid
    and its ptxas report."""
    from smore_tpu_torch.ops import _build

    host, kernels = _cuda_work(kernel, calls=3)
    log(f"{tag} CUDA launches per call (profiler, 3 calls): host "
        f"{len(host) / 3:g} {sorted(set(host))}, device kernels recorded "
        f"{len(kernels)} {sorted(set(kernels))}")
    require(host == ["cudaLaunchCooperativeKernel"] * 3
            and 0 < len(kernels) <= 3
            and all(device_kernel in k for k in kernels),
            f"{tag}: 3 calls put {host} / {kernels} on the card, not 3 "
            f"cooperative launches of {device_kernel}")
    log(f"{tag} grid: {grid} co-resident blocks of 256 threads, {smem} B "
        "of shared memory each")
    for line in _build.build_info[name][1].splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


def _superstep_report(tag: str, name: str, prefix: str, kernel) -> None:
    """_launch_report of a launcher of the superstep kernel (K4, K5, K3)."""
    from smore_tpu_torch.ops import sgns_banded

    lib = sgns_banded._libs[name]
    _launch_report(tag, name, kernel, "superstep",
                   getattr(lib, f"{prefix}_grid_size")(0, KS, D),
                   getattr(lib, f"{prefix}_smem_bytes")(KS, D))


def _all_collide_check(tag: str, kernel, twin, x: dict, args, **kw) -> None:
    """Kernel against twin on the all-collide inputs (numpy ``x``)."""
    a = {k: torch.from_numpy(v.copy()).cuda() for k, v in x.items()}
    b = {k: v.clone() for k, v in a.items()}
    got = kernel(*(a[k] for k in args), **kw)
    want = twin(*(b[k] for k in args), **kw)
    torch.cuda.synchronize()
    err = max(_compare(f"{tag} all-collide {i}", g, w)
              for i, (g, w) in enumerate(zip(got[:-1], want[:-1])))
    np.testing.assert_allclose(float(got[-1]), float(want[-1]), rtol=RTOL,
                               err_msg=f"kernel vs twin: {tag} loss")
    log(f"{tag} vs twin, all-collide (S x B = {x['src_l'].shape}): max "
        f"|diff| {err:.3e} within rtol {RTOL} atol {ATOL}; loss "
        f"{float(got[-1]):.4f} vs {float(want[-1]):.4f}")


def _superstep_inputs(seed: int, device):
    """Random inputs at the banded path's shapes, with duplicate rows: half
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


def phase_k4_vs_twin(device) -> dict:
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
    err = max(_compare(name, got, want) for name, got, want in (
        ("wv", kv, rv), ("wc", kc, rc), ("d_neg", kd, rd)))
    np.testing.assert_allclose(float(kl), float(rl), rtol=RTOL,
                               err_msg="kernel vs twin: loss")
    log(f"K4 vs twin (S={S} B={B} band={BAND} Ks={KS} D={D}): "
        f"max |diff| {err:.3e} within rtol {RTOL} atol {ATOL}; "
        f"loss {float(kl):.6f} vs {float(rl):.6f}")
    c = ALL_COLLIDE
    _all_collide_check("K4", sgns_banded_multiblock,
                       sgns_banded_multiblock_ref, multiblock_inputs(**c),
                       _ARGS, band_size=c["band"])
    _superstep_report("K4", "sgns_banded_multiblock", "sgns_mb",
                      lambda: sgns_banded_multiblock(*(x[k] for k in _ARGS),
                                                     band_size=BAND))
    ms, t_kern, plain_ms, t_plain = _alternate(
        lambda: sgns_banded_multiblock_ref(*(y[k] for k in _ARGS),
                                           band_size=BAND),
        lambda: sgns_banded_multiblock(*(x[k] for k in _ARGS),
                                       band_size=BAND), 5, 20)
    log(f"K4 superstep time: kernel {ms:.4f} ms {t_kern}, twin "
        f"{plain_ms:.4f} ms {t_plain} ({S * B} samples each)")
    h = {k: y[k].cpu().numpy() for k in ("sb", "db", "src_l", "pos_l")}
    rows = (_rows(h["sb"][:, None] * BAND + h["src_l"])
            + _rows(h["db"][:, None] * BAND + h["pos_l"]))
    nbytes = (2 * rows * D + 2 * S * KS * D) * 4 + S * (2 * B + 3) * 4
    bound = _bound("K4", _sgns_flops(S * B, KS, D), nbytes)
    log(f"K4 at {100 * bound['bound_ms'] / ms:.1f}% of its bound")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound,
                library_ms=None)


_NB_ARGS = ("wv", "wc", "sb", "db", "nb", "src_l", "pos_l", "negs_l",
            "alpha")


def _nb_superstep_inputs(seed: int, device):
    """K4's superstep inputs with banded negatives in place of cn: per step
    a 3280-row window and Ks window-local rows, half of them from 8 hot
    rows of the window (duplicates). Step 3's window lies in its own
    context band, step 4's in step 3's, step 9 revisits step 0's."""
    x = _superstep_inputs(seed, device)
    del x["cn"]
    rng = np.random.default_rng(seed + 100)
    ratio = BAND // NB2  # windows per band
    db = x["db"].cpu().numpy()
    nb = rng.integers(0, N_BANDS * ratio, S)
    nb[3] = db[3] * ratio + 3  # inside its own context band
    nb[4] = db[3] * ratio + 1  # inside the previous step's context band
    nb[9] = nb[0]  # a revisited window
    negs = rng.integers(0, NB2, (S, KS))
    hot = rng.integers(0, NB2, 8)
    negs = np.where(rng.random((S, KS)) < 0.5,
                    hot[rng.integers(0, 8, (S, KS))], negs)
    x["nb"] = torch.from_numpy(nb.astype(np.int32)).to(device)
    x["negs_l"] = torch.from_numpy(negs.astype(np.int32)).to(device)
    return x


def phase_k5_vs_twin(device) -> dict:
    from smore_tpu_torch.ops.sgns_banded import (
        sgns_banded_multiblock_nb,
        sgns_banded_multiblock_nb_ref,
    )

    x = _nb_superstep_inputs(0, device)
    y = {k: v.clone() for k, v in x.items()}
    kw = dict(band_size=BAND, nb2=NB2)
    kv, kc, kl = sgns_banded_multiblock_nb(*(x[k] for k in _NB_ARGS), **kw)
    rv, rc, rl = sgns_banded_multiblock_nb_ref(*(y[k] for k in _NB_ARGS),
                                               **kw)
    torch.cuda.synchronize()
    err = max(_compare(name, got, want) for name, got, want in (
        ("wv", kv, rv), ("wc", kc, rc)))
    np.testing.assert_allclose(float(kl), float(rl), rtol=RTOL,
                               err_msg="kernel vs twin: loss")
    log(f"K5 vs twin (S={S} B={B} band={BAND} nb2={NB2} Ks={KS} D={D}): "
        f"max |diff| {err:.3e} within rtol {RTOL} atol {ATOL}; "
        f"loss {float(kl):.6f} vs {float(rl):.6f}")
    c = ALL_COLLIDE_NB
    _all_collide_check("K5", sgns_banded_multiblock_nb,
                       sgns_banded_multiblock_nb_ref,
                       multiblock_nb_inputs(**c), _NB_ARGS,
                       band_size=c["band"], nb2=c["nb2"])
    _superstep_report("K5", "sgns_banded_multiblock_nb", "sgns_nb",
                      lambda: sgns_banded_multiblock_nb(
                          *(x[k] for k in _NB_ARGS), **kw))
    ms, t_kern, plain_ms, t_plain = _alternate(
        lambda: sgns_banded_multiblock_nb_ref(*(y[k] for k in _NB_ARGS),
                                              **kw),
        lambda: sgns_banded_multiblock_nb(*(x[k] for k in _NB_ARGS), **kw),
        5, 20)
    log(f"K5 superstep time: kernel {ms:.4f} ms {t_kern}, twin "
        f"{plain_ms:.4f} ms {t_plain} ({S * B} samples each)")
    h = {k: y[k].cpu().numpy() for k in ("sb", "db", "nb", "src_l",
                                         "pos_l", "negs_l")}
    # distinct rows of each table: source-band rows of wv; context-band
    # and window rows of wc, each read and written once
    rows = (_rows(h["sb"][:, None] * BAND + h["src_l"])
            + _rows(h["db"][:, None] * BAND + h["pos_l"],
                    h["nb"][:, None] * NB2 + h["negs_l"]))
    nbytes = 2 * rows * D * 4 + S * (2 * B + KS + 4) * 4
    bound = _bound("K5", _sgns_flops(S * B, KS, D), nbytes)
    log(f"K5 at {100 * bound['bound_ms'] / ms:.1f}% of its bound")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound,
                library_ms=None)


def phase_k1_vs_twin(device) -> dict:
    from smore_tpu_torch.ops import sgns
    from smore_tpu_torch.ops.sgns import (
        sgns_shared_grads,
        sgns_shared_grads_ref,
    )

    rng = np.random.default_rng(1)
    v, cp, cn = (torch.from_numpy((rng.standard_normal(s) * 0.3).astype(
        np.float32)).to(device) for s in ((B_UNBANDED, D), (B_UNBANDED, D),
                                          (KS, D)))
    alpha = torch.tensor(0.025, device=device)
    got = sgns_shared_grads(v, cp, cn, alpha, k_equiv=5)
    want = sgns_shared_grads_ref(v, cp, cn, alpha, k_equiv=5)
    torch.cuda.synchronize()
    err = max(_compare(name, g, w) for name, g, w in zip(
        ("d_src", "d_pos", "d_neg"), got, want))
    log(f"K1 vs twin (B={B_UNBANDED} Ks={KS} D={D}): max |diff| "
        f"{err:.3e} within rtol {RTOL} atol {ATOL}")
    lib = sgns._load()
    _launch_report("K1", "sgns_shared_grads",
                   lambda: sgns_shared_grads(v, cp, cn, alpha, k_equiv=5),
                   "shared_grads_persistent",
                   lib.sgns_sg_grid_size(0, B_UNBANDED, KS, D),
                   lib.sgns_sg_smem_bytes(KS, D))
    ms, t_kern, plain_ms, t_plain = _alternate(
        lambda: sgns_shared_grads_ref(v, cp, cn, alpha, k_equiv=5),
        lambda: sgns_shared_grads(v, cp, cn, alpha, k_equiv=5), 50, 50)
    log(f"K1 call time: kernel {ms:.4f} ms {t_kern}, twin {plain_ms:.4f} "
        f"ms {t_plain} ({B_UNBANDED} samples each)")
    nbytes = (4 * B_UNBANDED * D + 2 * KS * D + 1) * 4
    bound = _bound("K1", _sgns_flops(B_UNBANDED, KS, D), nbytes)
    log(f"K1 at {100 * bound['bound_ms'] / ms:.1f}% of its bound")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound,
                library_ms=None)


def _fused_inputs(seed: int, b: int, device):
    """Random inputs at the fused route's shapes, with duplicate rows: half
    of each side's ids come from 64 hot rows of its band."""
    rng = np.random.default_rng(seed)
    n = FUSED_BAND * FUSED_BANDS
    src = rng.integers(0, FUSED_BAND, b)
    pos = rng.integers(0, FUSED_BAND, b)
    hot = rng.integers(0, FUSED_BAND, 64)
    src = np.where(rng.random(b) < 0.5, hot[rng.integers(0, 64, b)], src)
    pos = np.where(rng.random(b) < 0.5, hot[rng.integers(0, 64, b)], pos)
    x = dict(
        wv=(rng.standard_normal((n, D)) * 0.1).astype(np.float32),
        wc=(rng.standard_normal((n, D)) * 0.1).astype(np.float32),
        sb=np.int32(rng.integers(0, FUSED_BANDS) * FUSED_BAND),
        db=np.int32(rng.integers(0, FUSED_BANDS) * FUSED_BAND),
        src_l=src.astype(np.int32), pos_l=pos.astype(np.int32),
        cn=(rng.standard_normal((KS, D)) * 0.1).astype(np.float32),
        alpha=np.float32(0.025),
    )
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in x.items()}


def phase_k3_vs_twin(device) -> dict:
    from smore_tpu_torch.ops.sgns_banded import (
        sgns_banded_fused,
        sgns_banded_fused_ref,
        sgns_banded_multiblock,
        sgns_banded_multiblock_ref,
    )

    out = {}
    for b in (B_FUSED, B_SCAT):
        x = _fused_inputs(b, b, device)
        y = {k: v.clone() for k, v in x.items()}
        kv, kc, kd, kl = sgns_banded_fused(*(x[k] for k in _ARGS))
        rv, rc, rd, rl = sgns_banded_fused_ref(*(y[k] for k in _ARGS))
        torch.cuda.synchronize()
        err = max(_compare(name, got, want) for name, got, want in (
            ("wv", kv, rv), ("wc", kc, rc), ("d_neg", kd, rd)))
        np.testing.assert_allclose(float(kl), float(rl), rtol=RTOL,
                                   err_msg="kernel vs twin: loss")
        log(f"K3 vs twin (B={b} band={FUSED_BAND} Ks={KS} D={D}): max "
            f"|diff| {err:.3e} within rtol {RTOL} atol {ATOL}; loss sum "
            f"{float(kl):.4f} vs {float(rl):.4f}")
        ms, t_kern, plain_ms, t_plain = _alternate(
            lambda: sgns_banded_fused_ref(*(y[k] for k in _ARGS)),
            lambda: sgns_banded_fused(*(x[k] for k in _ARGS)), 10, 50)
        log(f"K3 micro-step time (B={b}): kernel {ms:.4f} ms {t_kern}, "
            f"twin {plain_ms:.4f} ms {t_plain}")
        if b == B_FUSED:  # the fused route's batch
            _superstep_report("K3", "sgns_banded_fused", "sgns_bf",
                              lambda: sgns_banded_fused(
                                  *(x[k] for k in _ARGS)))
            h = {k: y[k].cpu().numpy() for k in ("sb", "db", "src_l",
                                                 "pos_l")}
            rows = _rows(h["sb"] + h["src_l"]) + _rows(h["db"] + h["pos_l"])
            nbytes = (2 * rows * D + 2 * KS * D) * 4 + (2 * b + 4) * 4
            bound = _bound("K3", _sgns_flops(b, KS, D), nbytes)
            log(f"K3 at {100 * bound['bound_ms'] / ms:.1f}% of its bound")
            out = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound,
                       library_ms=None)
    _all_collide_check("K3", sgns_banded_fused, sgns_banded_fused_ref,
                       fused_inputs(**ALL_COLLIDE_FUSED), _ARGS)
    # K3, K4 and K5 instantiate one kernel in three libraries: K4 once more
    # after K3 (and K5) have launched in this process
    _all_collide_check("K4 after K3", sgns_banded_multiblock,
                       sgns_banded_multiblock_ref,
                       multiblock_inputs(**ALL_COLLIDE), _ARGS,
                       band_size=ALL_COLLIDE["band"])
    return out


def phase_k2_vs_twin(device) -> dict:
    from smore_tpu_torch.ops.scatter import (
        band_scatter_add,
        band_scatter_add_ref,
    )

    rng = np.random.default_rng(3)
    n = SCAT_BAND * SCAT_BANDS
    table = torch.from_numpy((rng.standard_normal((n, D)) * 0.1).astype(
        np.float32)).to(device)
    # deltas of a gradient's size, so all-same sums stay in f32 range
    delta = torch.from_numpy((rng.standard_normal((B_SCAT, D)) * 1e-3)
                             .astype(np.float32)).to(device)
    start = torch.tensor(17 * SCAT_BAND, dtype=torch.int32, device=device)
    out = {}
    for kind, idx in (("random", rng.integers(0, SCAT_BAND, B_SCAT)),
                      ("all_same", np.full(B_SCAT, 7))):
        idx_d = torch.from_numpy(idx.astype(np.int32)).to(device)
        rows = (start.long() + idx_d.long())
        got = band_scatter_add(table.clone(), start, idx_d, delta)
        want = band_scatter_add_ref(table.clone(), start, idx_d, delta)
        lib = table.clone().index_add_(0, rows, delta)
        torch.cuda.synchronize()
        err = max(_compare(f"K2 {kind}", got, want),
                  _compare(f"K2 {kind} vs index_add_", got, lib))
        a, b_, c = table.clone(), table.clone(), table.clone()
        ms, t_kern, plain_ms, t_plain = _alternate(
            lambda: band_scatter_add_ref(b_, start, idx_d, delta),
            lambda: band_scatter_add(a, start, idx_d, delta), 50, 50)
        t_lib = [_time_ms(lambda: c.index_add_(0, rows, delta), 50)
                 for _ in range(2)]
        log(f"K2 vs twin and index_add_ ({kind}, B={B_SCAT} band="
            f"{SCAT_BAND} D={D}): max |diff| {err:.3e}; kernel {ms:.4f} ms "
            f"{t_kern}, twin {plain_ms:.4f} ms {t_plain}, index_add_ "
            f"{min(t_lib):.4f} ms {t_lib}")
        if kind == "random":  # the route's ids are spread over the band
            nbytes = (B_SCAT * D + B_SCAT + 1
                      + 2 * int(np.unique(idx).size) * D) * 4
            out = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       **_bound("K2", B_SCAT * D, nbytes),
                       library_ms=min(t_lib))
    return out


def _train_counted(m, counter, never=(), **kw):
    """1M samples (tables, stream, warm-up), fresh tables, then the timed
    40M run with every kernel's launch count set to 0 just before it; the
    kernels in ``never`` must not launch. Returns (samples/s, launches of
    ``counter``)."""
    t0 = time.perf_counter()
    m.train(sample_times=1, **TRAIN_KW, **kw)
    torch.cuda.synchronize()
    log(f"  warm-up: 1M samples incl. sampler tables "
        f"{time.perf_counter() - t0:.1f} s")
    m.init(dim=D, order=m.order)  # fresh tables; the sampler is kept
    torch.cuda.synchronize()
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    m.train(sample_times=SAMPLE_TIMES, **TRAIN_KW, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {name: c.launches for name, c in counters.items()}
    launches = counts[counter.__name__]
    executed = m.last_driver.executed_samples
    log(f"  {executed:,} samples in {dt:.3f} s = {executed / dt:,.0f} "
        f"samples/s; launches {counts}")
    require(launches > 0, f"the path never launched {counter.__name__}")
    for c in never:
        require(counts[c.__name__] == 0, f"the path launched {c.__name__}")
    for k, t in m.state.items():
        require(tuple(t.shape) == (m.graph.n_vertices, D),
                f"{k} table shape {tuple(t.shape)}")
        require(bool(torch.isfinite(t).all()), f"non-finite {k} table")
    return executed / dt, launches


def _route(m) -> str:
    d = m.last_driver
    return (f"batch {d.samples_per_step // d.micro_steps} micro-steps "
            f"{d.micro_steps} steps/call {d.steps_per_call}")


def phase_youtube(device):
    from smore_tpu_torch.graph.graph import Graph
    from smore_tpu_torch.models.line import LINE
    from smore_tpu_torch.ops.sgns import sgns_shared_grads
    from smore_tpu_torch.ops.sgns_banded import sgns_banded_multiblock
    from smore_tpu_torch.utils.bench_graphs import (
        make_youtube_graph,
        yt_community_auc,
    )

    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, "yt_net.txt")
    t0 = time.perf_counter()
    make_youtube_graph(path)
    g = Graph.load_edge_list(path, undirected=True)
    log(f"graph: {g.n_vertices:,} vertices {g.n_edges:,} directed edges "
        f"({time.perf_counter() - t0:.1f} s to make and load)")

    m = LINE(g, seed=0, device=device)
    m.init(dim=D, order=2)
    log("banded main path (LINE o2, Youtube scale, defaults):")
    rate, launches = _train_counted(m, sgns_banded_multiblock)
    bt = m.banded_tables
    log(f"  route: multiblock {_route(m)} band {bt.band_size} bands "
        f"{bt.n_bands} stream entries {bt.stream.numel():,}")
    auc = yt_community_auc(m.state["vertex"].cpu().numpy(), g.names)
    log(f"  community AUC at {SAMPLE_TIMES}M samples: {auc:.4f} "
        f"(gate >= {AUC_MIN})")
    require(auc >= AUC_MIN, f"community AUC {auc:.4f} < {AUC_MIN}")
    emb = os.path.join(OUT, "line_o2_yt.txt")
    m.save_weights(emb)
    with open(emb) as f:
        header = f.readline().split()
    require(header == [str(g.n_vertices), str(D)],
            f"embedding file header {header}")
    log(f"  saved {emb}")

    mu = LINE(g, seed=0, device=device)
    mu.init(dim=D, order=2)
    log("unbanded route at Youtube scale (banded=False, use_pallas=True; "
        "a measurement):")
    t0 = time.perf_counter()
    rate_u, _ = _train_counted(mu, sgns_shared_grads, banded=False,
                               use_pallas=True)
    log(f"  route: {_route(mu)} ({time.perf_counter() - t0:.1f} s with "
        "sampler tables and warm-up)")
    auc_u = yt_community_auc(mu.state["vertex"].cpu().numpy(), g.names)
    log(f"  community AUC at {SAMPLE_TIMES}M samples: unbanded {auc_u:.4f} "
        f"vs banded {auc:.4f}; samples/s unbanded {rate_u:,.0f} vs banded "
        f"{rate:,.0f}")
    return g, m, launches


def phase_youtube_routes(g, device) -> dict:
    """The other banded routes on the Youtube-scale graph: fused (K3,
    gated), order 1 (K2), scatter-only o2 (K2), neg_band (K5 and never K4,
    gated), held fused (K3, gated) and held scatter-only (K2)."""
    from smore_tpu_torch.models.line import LINE
    from smore_tpu_torch.ops.scatter import band_scatter_add
    from smore_tpu_torch.ops.sgns_banded import (
        sgns_banded_fused,
        sgns_banded_multiblock,
        sgns_banded_multiblock_nb,
    )
    from smore_tpu_torch.utils.bench_graphs import yt_community_auc

    out = {}
    for tag, order, kw, counter, never, gate in (
        ("fused", 2, dict(multiband=False), sgns_banded_fused, (),
         AUC_MIN_FUSED),
        ("order 1", 1, {}, band_scatter_add, (), None),
        ("scatter-only o2", 2, dict(multiband=False, use_pallas="scatter"),
         band_scatter_add, (), None),
        ("neg_band", 2, dict(neg_band=True), sgns_banded_multiblock_nb,
         (sgns_banded_multiblock,), AUC_MIN_NB),
        ("held fused", 2, dict(multiband=False, band_hold=True),
         sgns_banded_fused, (), AUC_MIN_HOLD),
        ("held scatter-only", 2, dict(multiband=False, band_hold=True,
                                      use_pallas="scatter"),
         band_scatter_add, (), None),
    ):
        m = LINE(g, seed=0, device=device)
        m.init(dim=D, order=order)
        log(f"banded {tag} route at Youtube scale (LINE o{order}, {kw}):")
        rate, launches = _train_counted(m, counter, never, **kw)
        bt = m.banded_tables
        log(f"  route: {_route(m)} band {bt.band_size} bands {bt.n_bands} "
            f"{'2D' if bt.two_d else '1D'} step "
            f"{m.last_driver.step_fn.__qualname__.split('.<')[0]}"
            + (f" window {bt.nb2}" if bt.nb2 else ""))
        if counter is sgns_banded_multiblock_nb:  # one per superstep
            d = m.last_driver
            require(launches * d.samples_per_step == d.executed_samples,
                    f"K5 launched {launches} times for "
                    f"{d.executed_samples} samples")
        auc = yt_community_auc(m.state["vertex"].cpu().numpy(), g.names)
        note = (f" (gate >= {gate})" if gate else
                f" (no gate; JAX {AUC_JAX_HOLD_SCATTER} at hold 8)"
                if "held" in tag else " (no gate)")
        log(f"  community AUC at {SAMPLE_TIMES}M samples: {auc:.4f}{note}")
        if gate:
            require(auc >= gate, f"{tag}: community AUC {auc:.4f} < {gate}")
        out[tag] = (m, launches)
    return out


def community_auc_50k(emb: np.ndarray, names, n_pairs=200_000,
                      seed=0) -> float:
    """Cosine AUC of same-community against different-community pairs on
    make_graph's graph (yt_community_auc's probe with that graph's labels:
    np.random.default_rng(0).integers(0, 100, 50_000), indexed by the
    number in the vertex name)."""
    labels = np.random.default_rng(0).integers(0, 100, 50_000)
    vid_label = labels[[int(nm[1:]) for nm in names]]
    x = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-9)
    rng = np.random.default_rng(seed)
    a = rng.integers(0, len(x), n_pairs * 4)
    b = rng.integers(0, len(x), n_pairs * 4)
    same = vid_label[a] == vid_label[b]
    s = (x[a] * x[b]).sum(1)
    pos, neg = s[same][:n_pairs], s[~same][:n_pairs]
    n = min(len(pos), len(neg), n_pairs)
    return float((pos[:n, None] > neg[None, :2000]).mean())


def phase_unbanded(device):
    from smore_tpu_torch.graph.graph import Graph
    from smore_tpu_torch.models.line import LINE
    from smore_tpu_torch.ops.sgns import sgns_shared_grads
    from smore_tpu_torch.utils.bench_graphs import make_graph

    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, "comm_net_50k.txt")
    t0 = time.perf_counter()
    make_graph(path)
    g = Graph.load_edge_list(path, undirected=True)
    log(f"graph: {g.n_vertices:,} vertices {g.n_edges:,} directed edges "
        f"({time.perf_counter() - t0:.1f} s to make and load)")
    out = {}
    for tag, order, kw, gate in (
        ("group 8 (main path)", 2, {}, AUC_MIN_50K),
        ("group 1", 2, dict(group=1), AUC_MIN_50K),
        ("order 1", 1, {}, None),
    ):
        m = LINE(g, seed=0, device=device)
        m.init(dim=D, order=order)
        log(f"unbanded LINE o{order} {tag}, use_pallas=True:")
        rate, launches = _train_counted(m, sgns_shared_grads,
                                        use_pallas=True, **kw)
        log(f"  route: {_route(m)}")
        require(m.banded_tables is None, "took the banded route")
        auc = community_auc_50k(m.state["vertex"].cpu().numpy(), g.names)
        log(f"  community AUC at {SAMPLE_TIMES}M samples: {auc:.4f}"
            + (f" (gate >= {gate})" if gate else " (no gate)"))
        if gate:
            require(auc >= gate, f"community AUC {auc:.4f} < {gate}")
        out[tag] = (m, launches)
    return out


def phase_profile(m, out_dir: str, name: str, **kw) -> None:
    """Kernel time by name and the card's busy share over 4M samples."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    m.train(sample_times=1, **TRAIN_KW, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m.train(sample_times=4, **TRAIN_KW, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avg = prof.key_averages()
    table = avg.table(sort_by="self_device_time_total", row_limit=25)
    with open(os.path.join(out_dir, f"{name}_profile.txt"), "w") as f:
        f.write(table)
    prof.export_chrome_trace(os.path.join(out_dir, f"{name}_trace.json"))
    # device time as the table's "Self CUDA time total" counts it: device
    # events only (an op's own row repeats its kernels' time)
    busy = sum(e.self_device_time_total for e in avg
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation) / 1e6
    samples = m.last_driver.executed_samples
    log(f"profile {name}: {samples:,} samples, wall {wall:.3f} s, device "
        f"busy {busy:.3f} s ({100 * busy / wall:.1f}%), idle "
        f"{100 * (1 - busy / wall):.1f}%")
    log(table)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile the main paths; write results to DIR")
    args = ap.parse_args()
    t_start = time.perf_counter()
    device = phase_device()
    phase_build()
    k4 = phase_k4_vs_twin(device)
    k5 = phase_k5_vs_twin(device)
    k1 = phase_k1_vs_twin(device)
    k3 = phase_k3_vs_twin(device)
    k2 = phase_k2_vs_twin(device)
    g_yt, m_yt, k4_launches = phase_youtube(device)
    routes = phase_youtube_routes(g_yt, device)
    m_fused, k3_launches = routes["fused"]
    m_o1, k2_launches = routes["order 1"]
    m_nb, k5_launches = routes["neg_band"]
    unbanded = phase_unbanded(device)
    m_50k, k1_launches = unbanded["group 8 (main path)"]
    if args.profile:
        phase_profile(m_yt, args.profile, "line_yt")
        phase_profile(m_fused, args.profile, "line_yt_fused",
                      multiband=False)
        phase_profile(m_o1, args.profile, "line_yt_order1")
        phase_profile(m_nb, args.profile, "line_yt_neg_band", neg_band=True)
        phase_profile(routes["held fused"][0], args.profile,
                      "line_yt_held_fused", multiband=False, band_hold=True)
        phase_profile(routes["held scatter-only"][0], args.profile,
                      "line_yt_held_scatter", multiband=False,
                      band_hold=True, use_pallas="scatter")
        phase_profile(m_50k, args.profile, "line_50k_unbanded",
                      use_pallas=True)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {
            "name": "sgns_banded_multiblock",
            "route": "cuda",
            "source": "smore_tpu_torch/csrc/sgns_banded_multiblock.cu",
            "replaces": "smore_tpu/ops/pallas_sgns_banded.py:933",
            "launches": k4_launches,
            **k4,
        },
        {
            "name": "sgns_shared_grads",
            "route": "cuda",
            "source": "smore_tpu_torch/csrc/sgns_shared_grads.cu",
            "replaces": "smore_tpu/ops/pallas_sgns.py:67",
            "launches": k1_launches,
            **k1,
        },
        {
            "name": "sgns_banded_fused",
            "route": "cuda",
            "source": "smore_tpu_torch/csrc/sgns_banded_fused.cu",
            "replaces": "smore_tpu/ops/pallas_sgns_banded.py:1076",
            "launches": k3_launches,
            **k3,
        },
        {
            "name": "band_scatter_add",
            "route": "cuda",
            "source": "smore_tpu_torch/csrc/band_scatter_add.cu",
            "replaces": "smore_tpu/ops/pallas_scatter.py:50",
            "launches": k2_launches,
            **k2,
        },
        {
            "name": "sgns_banded_multiblock_nb",
            "route": "cuda",
            "source": "smore_tpu_torch/csrc/sgns_banded_multiblock_nb.cu",
            "replaces": "smore_tpu/ops/pallas_sgns_banded.py:802",
            "launches": k5_launches,
            **k5,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
