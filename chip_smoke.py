"""Chip smoke test of the PyTorch port: builds the CUDA kernels and drives
LINE's banded routes at Youtube scale and its unbanded path on the
50k-vertex bench graph, then the command line (``python -m
smore_tpu_torch``), the walk family and checkpoint/resume, the rec family,
the community family, the knowledge-graph and typed-graph families, JODIE
and the SASRec family, on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU path):
  1. device: a CUDA card must be present; prints its name and power limit
  2. build: compiles every kernel library the port declares
     (ops/launches.Kernel: smore_tpu_torch/csrc/*.cu) with nvcc and
     csrc/jodie_schedule.cpp with g++, one
     process per source, all started together (first use)
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
 19. the walk family through the command line, each model a child process
     of ``python -m smore_tpu_torch`` on the 20k-vertex walk-parity graph
     (make_graph(n=20_000, e=400_000, n_comm=50, seed=0)) at the reference
     CLIs' default budgets, -dimensions 64: DeepWalk and Walklets link-AUC
     (experiments/walk_parity.py's probe) >= 0.9592 / 0.9600; node2vec and
     APP finite, their vertex rows past the init scale, AUC printed (APP's
     vertex . context, from its final checkpoint); no update kernel
     launched (the masked walk update is plain), the walk kernel by every
     model but node2vec; walks/s and wall printed
 20. kill and resume on the card: DeepWalk on that graph checkpointing
     every call, killed after its 4th save, resumed in a fresh model: the
     restored tables and generator state must be the saved bytes, the
     resumed link-AUC within 0.005 of an uninterrupted run's; the walk
     kernel's launches in the uninterrupted run (counter set to 0 just
     before it) are its count in the kernel table
 21. ``line`` through the command line at Youtube scale, 40M samples, with
     -checkpoint: K4 launched, community AUC >= 0.58; the same command
     again resumes the finished checkpoint, trains nothing and must write
     a byte-equal file; then ``line -order 1`` at 4M samples (K2
     launched, AUC printed)
 22. the rec family in this process, on the card, on the implicit-feedback
     set of experiments/bpr_parity.py (smore_tpu_torch.utils.rec_data,
     seed 0: 6,000 users, 3,000 items, 311,748 training edges): MF, BPR,
     WARP and Skew-OPT on the directed graph, HPE, PE, HOP-REC and NEMF
     on the undirected one (the last two with the field file and at
     walk_steps 2), dim 64, every other argument at its default; 1M
     samples of warm-up, then 20M timed. Each reaches AUC and recall@10 >=
     the JAX package's record less 0.03 (PE, without a record: finite
     tables whose vertex rows grew past their init norm), except NEMF,
     which trains 4M and prints its scores ungated to keep the smoke's
     time (the CSE gate is NERANK's, phase 23); no kernel is launched;
     samples/s printed
 23. ``bpr`` (directed by default) and ``nerank -field ... -walk_steps 2``
     through the command line, 20M samples each, scored from the saved
     files with the same gates; no kernel launched; the wall split
 24. the community family in this process, on the card, dim 64, every
     other argument at its default, each after 1M samples of warm-up and
     on fresh tables: GCN (walk_steps 5, 2M), TEXTGCN (walk_steps 2, 4M)
     and FINE (walk_steps 2, 4M) on the structured sets of
     smore_tpu_torch.utils.structured_data (the port's copy of
     experiments/structured_parity.py's), each gated at its same-topic
     AUC record less 0.03; TEXTGCNdev (num_events 1, num_words 5, 2M) on
     the TEXTGCN set, gated on finite tables that grew (vertex rows past
     twice their init norm, context rows non-zero) and a file of exactly
     the doc and word rows, its doc AUC printed; ECO (10M) on the
     undirected bpr_parity set with its field file, gated at AUC and
     recall@10 >= its record less 0.03. No kernel is launched; samples/s
     printed
 25. ``msfine -field ... -walk_steps 2 -sample_times 10`` through the
     command line on that set, scored from its wide file (both field rows)
     with the same kind of gate; no kernel launched; the wall split
 26. the knowledge-graph and typed-graph families in this process, on the
     card, on the sets of smore_tpu_torch.utils.oracle_data (the port's
     copy of experiments/go_oracle_parity.py's) at that script's settings
     and dim 64 (RotatE and ComplEx: init(64), as the CLI passes it):
     TransE, RotatE, ComplEx (30 epochs, batch 1024, MRR against 50
     corrupted heads), SNE (sign AUC), CTDNE (community AUC),
     Metapath2Vec and HAN (author topic AUC), CPR and TPR (held-out AUC),
     FastRP (community AUC, the mean of 5 projection seeds); each gated at
     its JAX record less 0.03 (TYPED_RECORDS, computed on the CPU by
     experiments/kg_typed_records.py); no kernel launched (every count set
     to 0 before each model); triples/s, samples/s or nodes/s printed.
     The KG models and HAN train on captured calls (their own loops: the
     first call of a train() eager, every later one a CUDA graph replay)
 27. at a real size: TransE at FB15k-237's shape (make_kg: 14,500
     entities, 237 relations, 272,076 triples; dim 64, batch 1024), one
     warm-up epoch then 5 timed, on captured calls: triples/s and MRR
     printed, gated on finite tables, unit entity rows and an MRR above the
     untrained tables'; FastRP (iterations 3, dim 64) on phase 8's Youtube-scale
     graph: seconds and community AUC printed, gated on finite rows, each
     unit or all zero (a vertex whose neighbourhood's sparse projection
     drew nothing), the zero rows counted
 28. ``rotate`` and ``cpr`` through the command line at phase 26's
     settings, scored from their saved files by phase 26's gates; no
     kernel launched; the wall split
 29. the jodie_epoch kernel (csrc/jodie_epoch.cu: the epoch's dependency
     levels, csrc/jodie_schedule.cpp, in order, a level's events across
     the SMs) against its plain loop on one epoch of go_oracle_parity's
     interaction set (smore_tpu_torch.utils.seq_data.make_interactions:
     8,000 events, 40 users, 60 items) at dim 64, bce_lr 0.2: the four
     tables and the loss must agree; a call must be ONE launch of
     jodie_levels; both times, the levels, the layout and the bound
     printed; then dims 50, 128 and 256 against the loop on the first
     1,500 events of the set's generator
 30. JODIE in this process on that set at run_jodie's settings (8 epochs,
     lr 0.05) and dim 64, both arms (bce_lr at its default and 0.2): one
     jodie_epoch launch an epoch, no other kernel; the static tables'
     pairwise accuracy gated at its JAX record less 0.03 (SEQ_RECORDS,
     computed on the CPU by experiments/seq_records.py); epoch time and
     events/s printed
 31. SASRec, gSASRec and Rec-Denoiser in this process on sasrec_eval's
     Markov set (seq_data.make_data: 4,000 users, 2,000 items, 30 steps)
     at its full-autodiff settings (dim 64, max_seq_len 30, 2 blocks, 1
     head, dropout 0.2, 5 negatives, lr 3e-3, batch 128, 100 epochs, the
     last item held out), on captured calls: no kernel launched; recall@10
     gated at its JAX record less 0.03; steps/s and sequences/s printed
 32. ``jodie`` (dims 64 and 128) and ``sasrec -forward_only 1
     -eval_holdout 1`` through the command line at those settings: exit 0,
     well-formed files of finite rows and the dim's columns, jodie_epoch
     launched once an epoch; the forward-only recall@10 printed beside its
     JAX record; the wall split
 33. multi-device modes on the card, LINE o2 on the 50k graph: (a) a
     one-rank NCCL group in this process, 16M samples each of "dp" and
     "rows" (unbanded, use_pallas=True: K1 launched) and "hogwild"
     (banded=True: the multiblock route, K4 launched), each trained from
     one seed eagerly (capture=False) and captured (the first call eager,
     every later call one replay of one CUDA graph that holds the call's
     collectives): the captured tables within rtol 1e-4 / atol 1e-5 of
     the eager ones, equal generator states, the same collectives' calls
     and bytes and the same launches, at least 2 replays; samples/s of
     both and their ratio, the captured run's split (the eager first call,
     the capture, the replays) and its graph's nodes, each mode beside a
     single-device run; (b) two ranks sharing the card over gloo (NCCL
     refuses two ranks on one device; eager, since gloo's collectives
     cannot be captured), child processes of this script whose exit codes
     are checked: "rows" at 8M, its community AUC
     within 0.005 of the single-device run at the same seed and budget;
     "dp" at 40M in all (each rank's batch 16384, so a merged step applies
     32768 samples), AUC >= 0.99; "hogwild" (banded=True) at 40M in all,
     AUC within 0.01 of a single-device banded run, K4 launched on each
     rank. Each mode prints its samples/s, its collectives' calls, bytes
     and seconds (an eager run's; a captured run's are not timed), and
     the backend
 34. JODIE at full width (run after phase 30): both arms on phase 29's set
     at dim 128, gated at their dim-128 JAX records less 0.03
     (SEQ_RECORDS_128); then the JODIE paper's Wikipedia shape
     (seq_data.interaction_arrays(**seq_data.WIKIPEDIA): 8,227 users, 1,000
     items in 4 clusters, 157,474 events, 172 feature columns U[0, 1),
     built in memory) at dim 128: the kernel against its plain loop on the
     first 4,000 events; eight epochs of train() (lr 0.05, bce_lr 0.2), one
     jodie_epoch launch each, finite tables, the static tables' pairwise
     accuracy printed; the kernel's ms an epoch, the schedule's ms, the
     levels, their mean width, the bound and the share of it
 35. captured against eager (run last): LINE multiblock at Youtube scale
     (K4) and LINE unbanded on the 50k graph at group 8 (K1), each trained
     from seed 0 with capture=False (every call eager) and then with the
     default (the first call eager, every later call one replay of one
     captured CUDA graph), 40M samples after 1M: the same launches, equal
     generator states, the captured tables within rtol 1e-4 / atol 1e-5 of
     the eager ones, the captured AUC at its gate (0.58, 0.99); samples/s
     of both, the captured run's split into the eager first call, the
     capture and the replays (and the replays' own samples/s), the host's
     launch, memset and copy calls a call in the steady state
     (torch.profiler, four calls more) and its ms a replay
 36. the models with loops of their own, captured against eager (run
     last): TransE, RotatE and ComplEx at FB15k-237's shape (phase 27's
     set, one warm-up epoch, then 5 timed), HAN at the HAN paper's DBLP
     shape (make_hetero: 4,056 authors, 14,328 papers, 20 venues; phase
     26's meta-paths, dim 64, batch 512, 2 epochs) and SASRec, gSASRec and
     Rec-Denoiser at the SASRec paper's ML-1M setting (6,040 users, 3,416
     items, 200-step sequences of seq_data.make_data's law; max_seq_len
     200, dim 50, 2 blocks, 1 head, dropout 0.2, batch 128, lr 1e-3, 5
     negatives, 3 epochs), each from seed 0 with capture=False and then on
     captured calls (each model's steps_per_call steps a call: KG 4, HAN
     and the SASRec family 1): steps/s and triples,
     node updates or sequences a second of both; the captured run split
     into the eager first call, the captures and the replays (their own
     rate, the host's ms a replay); each graph's node count; equal
     generator states, the captured tables (rtol 1e-4, atol 1e-5) or
     parameters (SEQ_RTOL, SEQ_ATOL) against the eager ones; no kernel
     launched
 37. the walk kernel (csrc/random_walk.cu; run after phase 7) against its
     plain twin sampling/walks.random_walk_ref at the DeepWalk cells'
     shapes: 128 walks of 40 steps on the tables of perfbench's Youtube
     graph and 80,640 (one epoch's hoisted starts on Flickr) on its Flickr
     graph's, both at seed 0, from uniform starts and uniforms: walks and
     row mask torch.equal in both restart modes; one call is ONE launch of
     the kernel; its ptxas report, both times alternated, the bound
 38. the node2vec walk kernel (csrc/node2vec_walk.cu) against its plain
     twin sampling/walks.node2vec_walk_ref at the node2vec cells' shapes
     (phase 37's graphs and batches, 4 trials a step): walks and row mask
     torch.equal for each instance (a thread, a warp a walk) at p/q
     (0.5, 2), (2, 0.5) and (1, 1); one call is ONE launch of the kernel;
     each instance's ptxas report; the instance lanes_for picks and the
     twin timed alternately at the cells' p = 0.5, q = 2, the bound from
     the benchmark's byte count; every instance timed, warm and cold, at
     B = 128 to 80,640 on both graphs (the crossover of lanes_for)
Every path that trains through TrainDriver without a mesh (phases 8-28
and 33's single-device runs) or on an NCCL mesh (33 (a)'s captured arms)
and every model with a loop of its own but
JODIE and FastRP (the KG models, HAN, the SASRec family; phases 26, 27,
31) trains on captured calls: the first call of a train() eager, the
others replays of CUDA graphs; a kernel's launch
counter is credited on every replay the launches of it that the graph's
nodes hold, which capture holds to what the launchers launched.
Each in-process path runs 1M samples first (tables, stream and warm-up),
then every kernel's launch count is set to 0, read after the timed 40M run
and printed; a command-line run counts the launches of its own process.
The last two lines are the kernel table (with each kernel's least possible
time on the card, its bound) and the result, each one JSON object. Files
go to build/chip_smoke/ inside the checkout.

    python3 chip_smoke.py --profile DIR

also profiles 4M more samples of the multiblock, fused, order-1,
neg_band, held fused, held scatter-only and unbanded main paths (and of
the multiblock and unbanded paths trained eagerly, phase 35's), one
DeepWalk run on the 20k graph, 2M samples of BPR, NEMF, GCN, TEXTGCN,
TEXTGCNdev, FINE and ECO, 2 epochs of TransE at FB15k-237's shape, of
HAN on the hetero set and of SASRec (each captured and eager) and of
JODIE with torch.profiler, prints each run's
device idle share and the torch ops and CUDA launches a step issues, and
writes the kernel-time tables and Chrome traces to DIR (a measurement
aid, off by default so that the smoke does not depend on the profiler).
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
    """The launch-counting kernels, by name."""
    from smore_tpu_torch.ops import launches

    return {n: k for n, k in launches.declared().items() if k.counted}


def _update_launches(counts: dict) -> dict:
    """The launch counts of the update kernels: the walk kernels
    (``csrc/random_walk.cu``, which draws the walks of DeepWalk, Walklets,
    APP, HPE and FINE, and ``csrc/node2vec_walk.cu``, node2vec's) left
    out."""
    return {k: n for k, n in counts.items()
            if k not in ("random_walk", "node2vec_walk")}


def phase_build() -> None:
    from smore_tpu_torch.ops import _build, jodie_epoch, launches

    loaders = [k.load for k in launches.declared().values()]
    loaders.append(jodie_epoch._load_schedule)  # the host library
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(loaders)) as ex:
        for f in [ex.submit(load) for load in loaders]:
            f.result()
    log(f"build: {time.perf_counter() - t0:.2f} s for all {len(loaders)} "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name in sorted(_build.build_info):
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
_RUNTIME_WORK = ("cudaLaunch", "cuLaunch", "cudaMemset", "cudaMemcpy",
                 "cudaGraphLaunch")


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
    launch calls, one cooperative launch a call, no memset, copy or sum),
    its grid and its ptxas report. CUPTI drops some device records on the
    H100 machines (0 to 3 of 3 kernels seen for the same calls), so the
    host's launch calls decide the count; the device kernels that are
    recorded must all be ``device_kernel``, and up to three profiles are
    taken to see at least one."""
    from smore_tpu_torch.ops import _build

    for _ in range(3):
        host, kernels = _cuda_work(kernel, calls=3)
        require(host == ["cudaLaunchCooperativeKernel"] * 3
                and len(kernels) <= 3
                and all(device_kernel in k for k in kernels),
                f"{tag}: 3 calls put {host} / {kernels} on the card, not 3 "
                f"cooperative launches of {device_kernel}")
        if kernels:
            break
    log(f"{tag} CUDA launches per call (profiler, 3 calls): host "
        f"{len(host) / 3:g} {sorted(set(host))}, device kernels recorded "
        f"{len(kernels)} {sorted(set(kernels)) or '(none: CUPTI dropped them)'}")
    log(f"{tag} grid: {grid} co-resident blocks of 256 threads, {smem} B "
        "of shared memory each")
    for line in _build.build_info[name][1].splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


def _superstep_report(tag: str, lib, kernel) -> None:
    """_launch_report of a launcher of the superstep kernel (K4, K5, K3),
    whose library is ``lib`` (an ``ops.launches.Kernel``)."""
    _launch_report(tag, lib.name, kernel, "superstep",
                   lib.call("grid_size", 0, KS, D),
                   lib.call("smem_bytes", KS, D))


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
        K4,
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
    _superstep_report("K4", K4,
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
        K5,
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
    _superstep_report("K5", K5,
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
    from smore_tpu_torch.ops.sgns import (
        K1,
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
    _launch_report("K1", K1.name,
                   lambda: sgns_shared_grads(v, cp, cn, alpha, k_equiv=5),
                   "shared_grads_persistent",
                   K1.call("grid_size", 0, B_UNBANDED, KS, D),
                   K1.call("smem_bytes", KS, D))
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
        K3,
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
            _superstep_report("K3", K3,
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



WALK_STEPS = 40  # DeepWalk's walk_steps (SMORe's CLI default)
# the DeepWalk cells' walk batches: 128 walks a step on Youtube, one
# epoch's hoisted starts on Flickr
WALK_SHAPES = (("youtube", 128), ("flickr", 80_640))


def _walk_graph(traffic: str):
    """A walk cell's graph (perfbench/traffic/), made at seed 0 as the
    benchmark makes it."""
    from perfbench.harness import graphs, spec
    from smore_tpu_torch.graph.graph import Graph

    a = graphs.make(spec.cell(f"deepwalk.{traffic}").traffic["graph"], 0)
    return Graph.from_arrays(a.src, a.dst, a.weights, a.names, a.name2id)


def _walk_tables(traffic: str, device):
    """Sampler tables of a DeepWalk cell's graph (``_walk_graph``)."""
    from smore_tpu_torch.sampling.tables import SamplerTables

    return SamplerTables.build(_walk_graph(traffic), device=device)


def _walk_bound(B: int, steps: int) -> dict:
    """One product a step (u0 x degree); the starts and their vert_meta
    rows, per step the uniforms (8 B), the cursor's vert_meta row (8 B) and
    one ctx_pa row (16 B), the int32 walks and the row mask, each read or
    written once."""
    nbytes = B * (4 + 8 + 4) + B * steps * (8 + 8 + 16) + B * (steps + 1) * 4
    return _bound("random_walk", B * steps, nbytes)


def phase_random_walk_vs_twin(device) -> dict:
    """The walk kernel against its plain twin at WALK_SHAPES: the walks and
    row mask torch.equal in both restart modes; a call is ONE launch of
    the kernel; ptxas's report; both times alternated on the card, the
    bound. Returns the Youtube shape's numbers (a DeepWalk Youtube step's
    walk), the Flickr shape's under "flickr"."""
    from smore_tpu_torch.ops import _build
    from smore_tpu_torch.sampling.walks import random_walk, random_walk_ref

    card = _card()
    out = {}
    for traffic, b in WALK_SHAPES:
        t = _walk_tables(traffic, device)
        gen = torch.Generator(device=device).manual_seed(b)
        starts = torch.randint(0, t.n_vertices, (b,), generator=gen,
                               device=device, dtype=torch.int32)
        u = torch.rand((WALK_STEPS, b, 2), generator=gen, device=device)
        for restart in (True, False):
            got = random_walk(t, None, starts, WALK_STEPS, restart, u=u)
            want = random_walk_ref(t, starts, WALK_STEPS, u, restart)
            require(all(torch.equal(x, y) for x, y in zip(got, want)),
                    f"random_walk on {traffic} (B={b}, restart {restart}): "
                    "the kernel's walks differ from the twin's")
        dead = int((got[1] == 0).sum())

        def kernel():
            random_walk(t, None, starts, WALK_STEPS, u=u)

        for _ in range(3):
            host, kernels = _cuda_work(kernel)
            require(len(host) == 3 and all(h.startswith("cudaLaunchKernel")
                                           for h in host)
                    and len(kernels) <= 3
                    and all("random_walk_steps" in k for k in kernels),
                    f"random_walk: 3 calls put {host} / {kernels} on the "
                    "card, not 3 launches of random_walk_steps")
            if kernels:
                break
        ms, t_kern, plain_ms, t_plain = _alternate(
            lambda: random_walk_ref(t, starts, WALK_STEPS, u), kernel, 20,
            200)
        bound = _walk_bound(b, WALK_STEPS)
        log(f"random_walk vs twin on {traffic} ({t.n_vertices:,} vertices, "
            f"{t.n_edges:,} edges; B={b:,}, {WALK_STEPS} steps, {dead} dead "
            f"starts): walks and row mask equal in both restart modes; "
            f"kernel {ms:.4f} ms {t_kern} ({1e6 * ms / WALK_STEPS:.0f} ns a "
            f"step), twin {plain_ms:.4f} ms {t_plain} ({plain_ms / ms:.0f}x); "
            f"{100 * bound['bound_ms'] / ms:.2f}% of its bytes bound: "
            f"latency-bound, {2 * WALK_STEPS} dependent loads a walk [{card}]")
        shape = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, **bound,
                     library_ms=None, traffic=traffic, walks=b,
                     steps=WALK_STEPS)
        if out:
            out["flickr"] = shape
        else:
            out.update(shape)
    log(f"random_walk CUDA launches per call (profiler, 3 calls): host "
        f"{len(host) / 3:g} {sorted(set(host))}, device kernels recorded "
        f"{len(kernels)} {sorted(set(kernels)) or '(none: CUPTI dropped them)'}")
    for line in _build.build_info["random_walk"][1].splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    return out


# the node2vec cells' p and q, the same swapped, and p = q = 1 (every first
# candidate accepted: DeepWalk's law)
N2V_PQ = ((0.5, 2.0), (2.0, 0.5), (1.0, 1.0))
N2V_TRIALS = 4


def _node2vec_bound(t, starts, u_first, u, walk, p, q) -> dict:
    """The bytes one launch needs, as the benchmark counts them
    (``perfbench/harness/families/node2vec.py`` ``launch_bytes_of``: each
    input sector the second-order law reads counted once), against the HBM
    rate; its operations are negligible."""
    from perfbench.harness import spec

    fam = spec.family("node2vec")
    nbytes = fam.launch_bytes_of(
        [{"starts": starts, "u_first": u_first, "u": u}], [walk],
        t.vert_meta, t.ctx_pa, p, q, N2V_TRIALS)
    return _bound("node2vec_walk", 0.0, nbytes)


# the batches at which phase 38 times every instance of the node2vec walk
# kernel, beside the cells' (128 and 80,640): where the crossover of
# ops/node2vec_walk.lanes_for is set
N2V_BATCHES = (128, 1024, 2048, 4096, 8192, 16384, 21120, 24576, 32768,
               49152, 80_640)


def _forced_lanes(lanes: int):
    """A context in which the node2vec walk's launcher takes the instance
    of ``lanes`` lanes a walk, whatever the batch."""
    from unittest import mock

    from smore_tpu_torch.ops import node2vec_walk as n2v_ops

    return mock.patch.object(n2v_ops, "lanes_for", lambda B, sms: lanes)


def _ptxas_entries(report: str) -> dict:
    """ptxas's report by kernel entry: {entry name: its lines}."""
    out, entry = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            out[entry] = []
        elif entry is not None and ("registers" in line or "spill" in line
                                    or "smem" in line):
            out[entry].append(line.strip())
    return out


def _node2vec_instance_times(t, nbr, device, traffic: str) -> dict:
    """Every instance's device time a launch at each of ``N2V_BATCHES`` on
    a cell's tables, at the cells' p, q and trials: warm (the same walks
    each repetition, as the kernel's time beside the twin's is taken) and
    cold (a rotation of fresh starts and uniforms, as a replay's 64
    launches come: Youtube's tables exceed the L2). {(B, lanes): (warm ms,
    cold ms)}."""
    from smore_tpu_torch.ops import node2vec_walk as n2v_ops
    from smore_tpu_torch.sampling.walks import node2vec_walk

    p, q = N2V_PQ[0]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    out = {}
    for b in N2V_BATCHES:
        gen = torch.Generator(device=device).manual_seed(b + 1)
        sets = [(torch.randint(0, t.n_vertices, (b,), generator=gen,
                               device=device, dtype=torch.int32),
                 torch.rand((b, 2), generator=gen, device=device),
                 torch.rand((WALK_STEPS - 1, b, N2V_TRIALS, 3), generator=gen,
                            device=device))
                for _ in range(64 if b <= 2048 else 8)]
        row = []
        for lanes in n2v_ops.LANES:
            turn = iter(range(1 << 30))

            def warm():
                s, uf, u = sets[0]
                node2vec_walk(t, nbr, None, s, WALK_STEPS, p, q, N2V_TRIALS,
                              u_first=uf, u=u)

            def cold():
                s, uf, u = sets[next(turn) % len(sets)]
                node2vec_walk(t, nbr, None, s, WALK_STEPS, p, q, N2V_TRIALS,
                              u_first=uf, u=u)

            reps = max(4, min(64, 2_000_000 // (b * WALK_STEPS)))
            with _forced_lanes(lanes):
                out[b, lanes] = (min(_time_ms(warm, reps) for _ in range(2)),
                                 min(_time_ms(cold, reps) for _ in range(2)))
            row.append(f"{lanes} lanes {out[b, lanes][0]:.4f} / "
                       f"{out[b, lanes][1]:.4f}")
        best = min(n2v_ops.LANES, key=lambda n: out[b, n][1])
        log(f"node2vec_walk instances on {traffic}, B={b:,} (warm / cold ms "
            f"a launch): {'; '.join(row)}; fastest cold {best}, lanes_for "
            f"{n2v_ops.lanes_for(b, sms)} ({sms} SMs)")
    return out


def phase_node2vec_walk_vs_twin(device) -> dict:
    """The node2vec walk kernel against its plain twin at the node2vec
    cells' shapes (``WALK_SHAPES`` on the benchmark's graphs at seed 0):
    walks and row mask torch.equal for each instance and each p/q of
    ``N2V_PQ``; a call is ONE launch of the kernel; ptxas's report of each
    instance; the instance ``lanes_for`` picks and the twin timed
    alternately on the card at the cells' p and q, the bound; every
    instance timed at ``N2V_BATCHES`` on each cell's tables (the
    crossover). Returns the Youtube shape's numbers, the Flickr shape's
    under "flickr"."""
    from smore_tpu_torch.ops import _build
    from smore_tpu_torch.ops import node2vec_walk as n2v_ops
    from smore_tpu_torch.sampling.tables import SamplerTables
    from smore_tpu_torch.sampling.walks import (
        NeighborIndex,
        node2vec_walk,
        node2vec_walk_ref,
    )

    card = _card()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    out = {}
    for traffic, b in WALK_SHAPES:
        g = _walk_graph(traffic)
        t = SamplerTables.build(g, device=device)
        nbr = NeighborIndex.build(g, device)
        gen = torch.Generator(device=device).manual_seed(b)
        starts = torch.randint(0, t.n_vertices, (b,), generator=gen,
                               device=device, dtype=torch.int32)
        u_first = torch.rand((b, 2), generator=gen, device=device)
        u = torch.rand((WALK_STEPS - 1, b, N2V_TRIALS, 3), generator=gen,
                       device=device)
        for p, q in N2V_PQ:
            want = node2vec_walk_ref(t, nbr, starts, WALK_STEPS, p, q,
                                     N2V_TRIALS, u_first, u)
            for lanes in n2v_ops.LANES:
                with _forced_lanes(lanes):
                    got = node2vec_walk(t, nbr, None, starts, WALK_STEPS, p,
                                        q, N2V_TRIALS, u_first=u_first, u=u)
                require(all(torch.equal(x, y) for x, y in zip(got, want)),
                        f"node2vec_walk on {traffic} (B={b}, p={p}, q={q}, "
                        f"{lanes} lanes): the kernel's walks differ from "
                        "the twin's")
        p, q = N2V_PQ[0]
        lanes = n2v_ops.lanes_for(b, sms)

        def kernel():
            node2vec_walk(t, nbr, None, starts, WALK_STEPS, p, q, N2V_TRIALS,
                          u_first=u_first, u=u)

        for _ in range(3):
            host, kernels = _cuda_work(kernel)
            require(len(host) == 3 and all(h.startswith("cudaLaunchKernel")
                                           for h in host)
                    and len(kernels) <= 3
                    and all("node2vec_walk_steps" in k for k in kernels),
                    f"node2vec_walk: 3 calls put {host} / {kernels} on the "
                    "card, not 3 launches of node2vec_walk_steps")
            if kernels:
                break
        ms, t_kern, plain_ms, t_plain = _alternate(
            lambda: node2vec_walk_ref(t, nbr, starts, WALK_STEPS, p, q,
                                      N2V_TRIALS, u_first, u), kernel, 3,
            100)
        walk = node2vec_walk(t, nbr, None, starts, WALK_STEPS, p, q,
                             N2V_TRIALS, u_first=u_first, u=u)[0]
        bound = _node2vec_bound(t, starts, u_first, u, walk, p, q)
        log(f"node2vec_walk vs twin on {traffic} ({t.n_vertices:,} vertices, "
            f"{t.n_edges:,} edges, neighbour search {nbr.n_iters} "
            f"iterations; B={b:,}, {WALK_STEPS} steps, p={p}, q={q}, "
            f"{N2V_TRIALS} trials): walks and row mask equal at p/q "
            f"{N2V_PQ} for the instances of {n2v_ops.LANES} lanes; "
            f"lanes_for {lanes} lanes: kernel {ms:.4f} ms {t_kern} "
            f"({1e6 * ms / WALK_STEPS:.0f} ns a step), twin {plain_ms:.4f} ms "
            f"{t_plain} ({plain_ms / ms:.0f}x); "
            f"{100 * bound['bound_ms'] / ms:.2f}% of its bytes bound "
            f"[{card}]")
        times = _node2vec_instance_times(t, nbr, device, traffic)
        shape = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, **bound,
                     library_ms=None, traffic=traffic, walks=b,
                     steps=WALK_STEPS, p=p, q=q, lanes=lanes,
                     instances={f"{bb}x{n}": v for (bb, n), v in
                                times.items()})
        if out:
            out["flickr"] = shape
        else:
            out.update(shape)
    log(f"node2vec_walk CUDA launches per call (profiler, 3 calls): host "
        f"{len(host) / 3:g} {sorted(set(host))}, device kernels recorded "
        f"{len(kernels)} {sorted(set(kernels)) or '(none: CUPTI dropped them)'}")
    for entry, lines in _ptxas_entries(
            _build.build_info["node2vec_walk"][1]).items():
        log(f"  ptxas {entry}: {' | '.join(lines)}")
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
    launches = counts[counter.name]
    executed = m.last_driver.executed_samples
    log(f"  {executed:,} samples in {dt:.3f} s = {executed / dt:,.0f} "
        f"samples/s; launches {counts}")
    require(launches > 0, f"the path never launched {counter.name}")
    for c in never:
        require(counts[c.name] == 0, f"the path launched {c.name}")
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
    from smore_tpu_torch.ops.sgns import K1
    from smore_tpu_torch.ops.sgns_banded import K4
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
    rate, launches = _train_counted(m, K4)
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
    rate_u, _ = _train_counted(mu, K1, banded=False,
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
    from smore_tpu_torch.ops.scatter import K2
    from smore_tpu_torch.ops.sgns_banded import K3, K4, K5
    from smore_tpu_torch.utils.bench_graphs import yt_community_auc

    out = {}
    for tag, order, kw, counter, never, gate in (
        ("fused", 2, dict(multiband=False), K3, (), AUC_MIN_FUSED),
        ("order 1", 1, {}, K2, (), None),
        ("scatter-only o2", 2, dict(multiband=False, use_pallas="scatter"),
         K2, (), None),
        ("neg_band", 2, dict(neg_band=True), K5, (K4,), AUC_MIN_NB),
        ("held fused", 2, dict(multiband=False, band_hold=True), K3, (),
         AUC_MIN_HOLD),
        ("held scatter-only", 2, dict(multiband=False, band_hold=True,
                                      use_pallas="scatter"), K2, (), None),
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


def _steady_launch_calls(m, millions: float, **kw) -> float:
    """CUDA launch, memset and copy calls the host issues a driver call in
    the steady state, as torch.profiler records them over a train() of
    ``millions`` samples: eagerly, every call's over the calls; captured,
    those from the first replay's cudaGraphLaunch on over the replays."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        m.train(sample_times=millions, **TRAIN_KW, **kw)
        torch.cuda.synchronize()
    d = m.last_driver
    events = sorted((e for e in prof.events()
                     if e.name.startswith(_RUNTIME_WORK)),
                    key=lambda e: e.time_range.start)
    if not d.replays:
        return len(events) / d.calls
    graph_launches = [i for i, e in enumerate(events)
                      if e.name == "cudaGraphLaunch"]
    require(len(graph_launches) == d.replays,
            f"{len(graph_launches)} cudaGraphLaunch calls for {d.replays} "
            "replays")
    return (len(events) - graph_launches[0]) / d.replays


def phase_captured_vs_eager(g_yt, g_50k, device) -> None:
    """Phase 35: the same route trained eagerly (capture=False) and then
    captured (every call after the first one CUDA graph replay), in this
    process from one seed, 40M samples after 1M: samples/s, the host's
    launch calls a call, the host's ms a call; the captured tables held
    to the eager ones within the kernels' tolerance, the captured AUC to
    its gate."""
    from smore_tpu_torch.models.line import LINE
    from smore_tpu_torch.ops.sgns import K1
    from smore_tpu_torch.ops.sgns_banded import K4
    from smore_tpu_torch.utils.bench_graphs import yt_community_auc

    for tag, g, kw, counter, gate, auc_of in (
        ("LINE multiblock at Youtube scale (K4)", g_yt, {},
         K4, AUC_MIN, yt_community_auc),
        ("LINE unbanded on the 50k graph, group 8 (K1)", g_50k,
         dict(use_pallas=True), K1, AUC_MIN_50K,
         community_auc_50k),
    ):
        runs = {}
        for capture in (False, True):
            name = "captured" if capture else "eager"
            m = LINE(g, seed=0, device=device)
            m.capture = capture
            m.init(dim=D, order=2)
            log(f"{tag}, {name}:")
            rate, launches = _train_counted(m, counter, **kw)
            d = m.last_driver
            host_ms = (1e3 * d.replay_host_s / d.replays if d.replays
                       else float("nan"))
            log(f"  {name}: {d.calls} calls of {d.steps_per_call} steps "
                f"({d.replays} replays), host ms a replay {host_ms:.3f}, "
                f"copied back {d.copy_back_bytes} B a call")
            steady = float("nan")
            if d.replays:
                steady = (d.replays * d.steps_per_call * d.samples_per_step
                          / d.replay_s)
                log(f"  {name}: the eager first call {1e3 * d.first_call_s:.1f}"
                    f" ms, the capture {1e3 * d.capture_s:.1f} ms, "
                    f"{d.replays} replays {1e3 * d.replay_s:.1f} ms = "
                    f"{steady:,.0f} samples/s in the steady state")
            require((d.replays == d.calls - 1) if capture
                    else d.replays == 0, f"{name}: {d.replays} replays of "
                    f"{d.calls} calls")
            runs[name] = (m, rate, launches, d, steady)
        (me, re_, le, de, _), (mc, rc, lc, dc, rs) = (runs["eager"],
                                                      runs["captured"])
        require(le == lc, f"launches eager {le}, captured {lc}")
        require(torch.equal(de.gen.get_state(), dc.gen.get_state()),
                "the generators' states differ")
        for k, v in me.state.items():
            err = float((mc.state[k] - v).abs().max())
            ok = bool(torch.allclose(mc.state[k], v, rtol=RTOL, atol=ATOL))
            log(f"  {k} table, captured against eager: max |diff| "
                f"{err:.3e} (rtol {RTOL}, atol {ATOL})")
            require(ok, f"{tag}: captured {k} table off the eager one by "
                    f"{err:.3e}")
        auc = auc_of(mc.state["vertex"].cpu().numpy(), g.names)
        require(auc >= gate, f"{tag}: community AUC {auc:.4f} < {gate}")
        per_call = dc.samples_per_step * dc.steps_per_call
        calls = {name: _steady_launch_calls(m, 4 * per_call / 1e6, **kw)
                 for name, (m, *_) in runs.items()}
        log(f"  samples/s eager {re_:,.0f}, captured {rc:,.0f} "
            f"({rc / re_:.2f}x; its replays alone {rs:,.0f}); launch, "
            f"memset and copy calls a call "
            f"eager {calls['eager']:.1f}, captured {calls['captured']:.1f}; "
            f"community AUC captured {auc:.4f} (gate >= {gate}) "
            f"[{_card()}]")


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


# ------------------------------------------------ the CLI and the walks
# The 20k-vertex walk-parity graph (experiments/walk_parity.py) and the
# reference CLIs' default budgets there, every run at -dimensions 64
# -undirected 1 -alpha 0.025. DeepWalk and Walklets are gated at the JAX
# package's link-AUC records on this graph (0.9892, 0.9900) less bench.py's
# 0.03 margin; node2vec and APP have no record there and are gated on
# finite tables whose vertex rows grew past their init scale (a stalled
# run stays at it).
WALK_GRAPH = dict(n=20_000, e=400_000, n_comm=50, seed=0)
WALK_COMMON = ["-dimensions", str(D), "-undirected", "1", "-alpha", "0.025"]
WALK_RUNS = (
    ("deepwalk", ["-walk_times", "10", "-walk_steps", "40", "-window_size",
                  "5", "-negative_samples", "5"], 0.9592),
    ("walklets", ["-walk_times", "10", "-walk_steps", "40", "-window_min",
                  "2", "-window_max", "5", "-negative_samples", "5"], 0.9600),
    ("node2vec", ["-walk_times", "3", "-walk_steps", "40", "-window_size",
                  "5", "-negative_samples", "5", "-p", "0.5", "-q", "2"],
     None),
    ("app", ["-walk_times", "100", "-sample_times", "20", "-jump", "0.15",
             "-negative_samples", "5"], None),
)
INIT_NORM = np.sqrt(D / 12.0) / D  # mean row norm of U(-0.5, 0.5) / D
# a CLI child: its imports, then it waits for its arguments (one JSON line
# on stdin; none: exit), runs them as ``python -m smore_tpu_torch`` does,
# then prints the launch count of every kernel in that process (all 0 at
# its start) and the seconds it spent in its imports, in the run, in the
# graph load, in the model's train() and in save_weights (the CLI's own
# steps, timed by wrapping them). Children are started one run ahead, so
# that their imports overlap the run before (run_cli).
_CLI_RUN = (
    "import json, runpy, sys, time\n"
    "t0 = time.perf_counter()\n"
    "from chip_smoke import _cli_timers, _counters\n"
    "times = _cli_timers()\n"
    "times['imports'] = time.perf_counter() - t0\n"
    "line = sys.stdin.readline()\n"
    "if not line:\n"
    "    sys.exit(0)\n"
    "sys.argv = ['smore_tpu_torch'] + json.loads(line)\n"
    "t0 = time.perf_counter()\n"
    "rc = 0\n"
    "try:\n"
    "    runpy.run_module('smore_tpu_torch', run_name='__main__',\n"
    "                     alter_sys=True)\n"
    "except SystemExit as e:\n"
    "    rc = e.code\n"
    "times['run'] = time.perf_counter() - t0\n"
    "print('launches ' + json.dumps(\n"
    "    {name: f.launches for name, f in _counters().items()}))\n"
    "print('times ' + json.dumps(times))\n"
    "sys.exit(rc)\n"
)


def _cli_timers() -> dict:
    """Wrap the steps of a CLI run (graph load, each model's train(),
    save_weights) so that each adds its seconds to the returned dict."""
    from smore_tpu_torch import models
    from smore_tpu_torch.graph.bipartite import InteractionGraph
    from smore_tpu_torch.graph.graph import Graph
    from smore_tpu_torch.graph.hetero import HeteroGraph
    from smore_tpu_torch.graph.knowledge import KnowledgeGraph
    from smore_tpu_torch.graph.signed import SignedNetwork
    from smore_tpu_torch.graph.temporal import TemporalGraph

    times = {"load": 0.0, "train": 0.0, "save": 0.0}
    depth = dict.fromkeys(times, 0)

    def timed(key, fn):
        def run(*args, **kw):
            # only the outermost call adds its time: an override that calls
            # super() and an inherited method are wrapped twice
            depth[key] += 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                depth[key] -= 1
                if depth[key] == 0:
                    if torch.cuda.is_initialized():
                        torch.cuda.synchronize()
                    times[key] += time.perf_counter() - t0
        return run

    Graph.load_edge_list = staticmethod(timed("load", Graph.load_edge_list))
    for store, attr in ((KnowledgeGraph, "load_triples"),
                        (SignedNetwork, "load_edge_list"),
                        (HeteroGraph, "load_edge_list"),
                        (TemporalGraph, "load_edge_list"),
                        (InteractionGraph, "load_interactions")):
        setattr(store, attr, staticmethod(timed("load", getattr(store,
                                                                 attr))))
    # FastRP generates instead of training; the KG models save two files
    for name in models.__all__:
        cls = getattr(models, name)
        for attr, key in (("train", "train"), ("generate", "train"),
                          ("save_weights", "save"),
                          ("save_embeddings", "save")):
            if hasattr(cls, attr):
                setattr(cls, attr, timed(key, getattr(cls, attr)))
    return times


_SPARE_CLI = []  # the CLI child started ahead; closed by main's end


def _start_cli():
    return subprocess.Popen([sys.executable, "-c", _CLI_RUN], cwd=HERE,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def close_spare_cli() -> None:
    """End the child started ahead: its stdin closes, and it exits."""
    while _SPARE_CLI:
        p = _SPARE_CLI.pop()
        p.communicate(timeout=120)


def run_cli(argv, timeout: int = 300) -> dict:
    """``python -m smore_tpu_torch <argv>`` in a child process on the card
    (the kernels built above are found in the build directory): the child
    started ahead, or a new one, and a new child starts ahead for the next
    run. Returns its wall time from the arguments to its exit, the samples
    and seconds of its driver's last line and its kernel launches; fails
    on a non-zero exit."""
    import re

    p = _SPARE_CLI.pop() if _SPARE_CLI else _start_cli()
    _SPARE_CLI.append(_start_cli())
    t0 = time.perf_counter()
    try:
        out, err = p.communicate(json.dumps(list(argv)) + "\n",
                                 timeout=timeout)
    except subprocess.TimeoutExpired:
        p.kill()
        p.communicate()
        raise
    wall = time.perf_counter() - t0
    if p.returncode != 0:
        log(out[-3000:])
        log(err[-3000:])
        raise RuntimeError(f"chip_smoke: {' '.join(argv[:1])} exited "
                           f"{p.returncode}")
    done = re.findall(r"done: ([\d,]+) samples in ([\d.]+)s", out)
    launches = json.loads(out.rsplit("launches ", 1)[1].splitlines()[0])
    times = json.loads(out.rsplit("times ", 1)[1].splitlines()[0])
    samples, secs = done[-1] if done else ("0", "0")
    return dict(wall=wall, samples=int(samples.replace(",", "")),
                train_s=float(secs), launches=launches, times=times,
                stdout=out)


def _wall(r: dict) -> str:
    """A CLI run's wall time from its arguments to its exit, and where it
    went: the graph load, the model's train() (sampler tables, resume and
    TrainDriver's loop), the text file, and the rest (the card's context,
    init, checkpoint set-up, exit); beside it, the child's imports
    (interpreter, torch and the smoke's), which ran before, overlapping the
    run before when the child was started ahead."""
    t = r["times"]
    rest = r["wall"] - t["load"] - t["train"] - t["save"]
    return (f"wall {r['wall']:.1f} s (graph load {t['load']:.1f}, train() "
            f"{t['train']:.1f}, save {t['save']:.1f}, rest {rest:.1f}; "
            f"imports before it {t['imports']:.1f})")


def _load_emb(path):
    """walk_parity.load_emb: name -> row and the row-normalised table."""
    names, rows = [], []
    with open(path) as f:
        f.readline()
        for line in f:
            parts = line.rstrip("\n").split(" ")
            if len(parts) < D + 1:
                continue
            names.append(parts[0])
            rows.append([float(x) for x in parts[1:D + 1]])
    emb = np.asarray(rows, np.float64)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True) + 1e-12
    return dict(zip(names, range(len(names)))), emb


def link_auc(train: str, name2row: dict, emb: np.ndarray, ctx=None,
             seed: int = 3, n_pairs: int = 20000) -> float:
    """experiments/walk_parity.link_auc: AUC of the score of true edges
    against uniform random pairs, the score emb[u] . emb[v] (cosine for a
    normalised table) or emb[u] . ctx[v]."""
    ctx = emb if ctx is None else ctx
    rng = np.random.default_rng(seed)
    src, dst = [], []
    with open(train) as f:
        lines = f.readlines()
    for i in rng.choice(len(lines), n_pairs, replace=False):
        a, b, _ = lines[i].split()
        src.append(name2row[a])
        dst.append(name2row[b])
    pos = np.sum(emb[src] * ctx[dst], axis=1)
    names = list(name2row.values())
    ra = rng.choice(names, 1000)
    rb = rng.choice(names, 1000)
    neg = np.sum(emb[ra] * ctx[rb], axis=1)
    return float((pos[:, None] > neg[None, :]).mean()
                 + 0.5 * (pos[:, None] == neg[None, :]).mean())


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# each walk model's kernel launches in its CLI run (phase_walks_cli)
WALK_CLI_LAUNCHES: dict = {}


def phase_walks_cli() -> str:
    """The four walk models through ``python -m smore_tpu_torch`` on the
    20k walk-parity graph at the reference's default budgets; each must
    launch no update kernel (the walk update is the masked plain path), and
    every model but node2vec the walk kernel and node2vec its own walk
    kernel (csrc/node2vec_walk.cu). APP also
    checkpoints its final state, whose context table scores its AUC."""
    from smore_tpu_torch.utils.bench_graphs import make_graph
    from smore_tpu_torch.utils.checkpoint import load_checkpoint

    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, "walk_net_20k.txt")
    make_graph(path, **WALK_GRAPH)
    card = _card()
    for model, flags, gate in WALK_RUNS:
        save = os.path.join(OUT, f"{model}_20k.txt")
        extra = []
        if model == "app":
            ck = os.path.join(OUT, "app_ckpt")
            extra = ["-checkpoint", ck, "-checkpoint_every", "1000000",
                     "-no_resume"]
        r = run_cli([model, "-train", path, "-save", save] + WALK_COMMON
                    + flags + extra)
        require(not any(_update_launches(r["launches"]).values()),
                f"{model} launched a kernel: {r['launches']}")
        require((r["launches"]["random_walk"] > 0) == (model != "node2vec"),
                f"{model}'s walk kernel launches: {r['launches']}")
        require((r["launches"]["node2vec_walk"] > 0) == (model == "node2vec"),
                f"{model}'s node2vec walk kernel launches: {r['launches']}")
        WALK_CLI_LAUNCHES[model] = r["launches"]
        name2row, emb = _load_emb(save)
        require(len(name2row) == WALK_GRAPH["n"] and np.isfinite(emb).all(),
                f"{model}: {len(name2row)} rows or non-finite values")
        if model == "app":
            state, _, _ = load_checkpoint(ck)
            wv = state["vertex"].numpy().astype(np.float64)
            wc = state["context"].numpy().astype(np.float64)
            require(np.isfinite(wv).all() and np.isfinite(wc).all(),
                    "app: non-finite tables")
            auc = link_auc(path, name2row, wv, wc)
            kind = "vertex . context"
        else:
            auc = link_auc(path, name2row, emb)
            kind = "cosine"
        with open(save) as f:
            f.readline()
            norm = float(np.mean([np.linalg.norm(np.array(
                line.split()[1:], np.float64)) for line in f]))
        rate = r["samples"] / max(r["train_s"], 1e-9)
        log(f"{model} (CLI, 20k graph, {' '.join(flags)}): link-AUC "
            f"({kind}) {auc:.4f}"
            + (f" (gate >= {gate})" if gate else " (no record; gate: finite "
               f"and vertex row norm > 2 x init {INIT_NORM:.4f})")
            + f"; mean vertex row norm {norm:.4f}; {r['samples']:,} walks in "
            f"{r['train_s']:.2f} s = {rate:,.0f} walks/s"
            + (" (with the one save of its final checkpoint)"
               if model == "app" else "")
            + f"; {_wall(r)} [{card}]")
        if gate:
            require(auc >= gate, f"{model}: link-AUC {auc:.4f} < {gate}")
        else:
            require(norm > 2 * INIT_NORM,
                    f"{model}: vertex row norm {norm:.4f} stayed at its init "
                    f"scale {INIT_NORM:.4f}")
    return path


class _Killed(Exception):
    """The simulated preemption of the kill-and-resume phase."""


def phase_walk_kill_resume(path: str, device):
    """DeepWalk on the 20k graph at its default budget, checkpointing every
    call: killed after the 4th save and resumed in a fresh model. The
    restored tables and generator state must be the saved bytes, and the
    resumed run's link-AUC within 0.005 of an uninterrupted run's (atomics
    sum duplicate rows in a changing order, so the two differ in the last
    bits). Returns the resumed model and the walk kernel's launches in the
    uninterrupted run."""
    import shutil

    from smore_tpu_torch.graph.graph import Graph
    from smore_tpu_torch.models import DeepWalk
    from smore_tpu_torch.models.base import TrainDriver
    from smore_tpu_torch.ops.random_walk import KERNEL as WALK
    from smore_tpu_torch.utils.checkpoint import load_checkpoint

    g = Graph.load_edge_list(path, undirected=True)
    kw = dict(walk_times=10, walk_steps=40, window_size=5,
              negative_samples=5, alpha=0.025, verbose=False)

    def fresh():
        m = DeepWalk(g, seed=0, device=device)
        m.init(dim=D)
        return m

    def auc_of(m, name):
        f = os.path.join(OUT, name)
        m.save_weights(f)
        return link_auc(path, *_load_emb(f))

    ref = fresh()
    WALK.launches = 0
    t0 = time.perf_counter()
    ref.train(**kw)
    dt = time.perf_counter() - t0
    walk_launches = WALK.launches
    require(walk_launches > 0, "DeepWalk launched no walk kernel")
    auc_ref = auc_of(ref, "deepwalk_ref.txt")
    d = ref.last_driver
    log(f"kill and resume: DeepWalk uninterrupted {d.executed_samples:,} "
        f"walks in {dt:.2f} s ({d.executed_samples / dt:,.0f} walks/s), "
        f"batch {d.samples_per_step // d.micro_steps} x {d.micro_steps} "
        f"(epoch hoist), {d.steps_per_call} step(s) per call, "
        f"{walk_launches} walk kernel launches; link-AUC {auc_ref:.4f}")

    ck = os.path.join(OUT, "deepwalk_ckpt")
    shutil.rmtree(ck, ignore_errors=True)
    saves = []
    orig_save, orig_resume = TrainDriver._save_ckpt, TrainDriver._maybe_resume

    def killing_save(self, state, gen, done):
        orig_save(self, state, gen, done)
        saves.append(done)
        if len(saves) == 4:
            raise _Killed

    m = fresh()
    m.set_checkpoint(ck, every=1)
    TrainDriver._save_ckpt = killing_save
    try:
        m.train(**kw)
        raise RuntimeError("chip_smoke: the run was not killed")
    except _Killed:
        pass
    finally:
        TrainDriver._save_ckpt = orig_save
    saved, done, extra = load_checkpoint(ck)
    restored = {}

    def spy(self, state, gen):
        out = orig_resume(self, state, gen)
        # a copy: training goes on to update the tables in place
        restored.update({k: v.to("cpu", copy=True) for k, v in state.items()},
                        gen=gen.get_state())
        return out

    m2 = fresh()
    m2.set_checkpoint(ck, every=1)
    TrainDriver._maybe_resume = spy
    try:
        m2.train(**kw)
    finally:
        TrainDriver._maybe_resume = orig_resume
    require(torch.equal(restored.pop("gen"), extra["gen"]),
            "the restored generator state differs from the saved one")
    require(set(restored) == set(saved)
            and all(torch.equal(restored[k], v) for k, v in saved.items()),
            "the restored tables differ from the saved ones")
    d2 = m2.last_driver
    auc = auc_of(m2, "deepwalk_resumed.txt")
    diff = max(float((m2.state[k] - ref.state[k]).abs().max())
               for k in ref.state)
    log(f"  killed after save 4 (step {done} of "
        f"{-(-d2.total_samples // d2.samples_per_step)}); restored tables "
        f"and generator state byte-equal to the saved ones; resumed "
        f"{d2.executed_samples:,} walks; link-AUC resumed {auc:.4f} vs "
        f"uninterrupted {auc_ref:.4f} (gate |diff| <= 0.005); largest table "
        f"difference {diff:.3e}")
    require(d2.executed_samples > 0, "the resumed run trained nothing")
    require(abs(auc - auc_ref) <= 0.005,
            f"resumed link-AUC {auc:.4f} vs uninterrupted {auc_ref:.4f}")
    m2.set_checkpoint(None)
    return m2, walk_launches


def _cli_table(g, path: str) -> np.ndarray:
    """A saved embedding file as a (n, D) table in the graph's row order,
    through the port's native warm-start reader."""
    from smore_tpu_torch.io.embeddings import warm_start

    table = np.full((g.n_vertices, D), np.nan, np.float32)
    table = warm_start(table, g.names, path)
    require(np.isfinite(table).all(), f"{path}: missing or non-finite rows")
    return table


# the order-1 CLI run repeats phase 11's route: a shorter depth makes room
# for the rec phases (PERF.md §6)
LINE_O1_CLI_SAMPLES = 4


def phase_line_cli(g) -> int:
    """``line`` through the CLI at Youtube scale: 40M samples on the
    multiblock route with a checkpoint (K4 launched, the community AUC
    gated), the same command again (it resumes the finished checkpoint:
    nothing trains, no kernel launches, the same bytes are written), and
    order 1 at 4M samples (K2 launched, its AUC printed; phase 11 trains
    the route at 40M). Returns the first run's K4 launches."""
    import filecmp
    import shutil

    from smore_tpu_torch.utils.bench_graphs import yt_community_auc

    path = os.path.join(OUT, "yt_net.txt")
    ck = os.path.join(OUT, "line_ckpt")
    shutil.rmtree(ck, ignore_errors=True)
    card = _card()
    a, b = os.path.join(OUT, "line_cli_a.txt"), os.path.join(OUT,
                                                             "line_cli_b.txt")
    base = ["line", "-train", path, "-sample_times", str(SAMPLE_TIMES),
            "-checkpoint", ck, "-checkpoint_every", "100"]
    r1 = run_cli(base + ["-save", a])
    k4 = r1["launches"]["sgns_banded_multiblock"]
    require(k4 > 0, f"line through the CLI did not launch K4: "
            f"{r1['launches']}")
    auc = yt_community_auc(_cli_table(g, a), g.names)
    log(f"line o2 (CLI, Youtube scale, {SAMPLE_TIMES}M samples, checkpoint "
        f"every 100 calls): community AUC {auc:.4f} (gate >= {AUC_MIN}); "
        f"{r1['samples']:,} samples in {r1['train_s']:.2f} s = "
        f"{r1['samples'] / max(r1['train_s'], 1e-9):,.0f} samples/s; "
        f"{_wall(r1)}; launches {r1['launches']} [{card}]")
    require(auc >= AUC_MIN, f"line CLI: community AUC {auc:.4f} < {AUC_MIN}")
    r2 = run_cli(base + ["-save", b])
    require(r2["samples"] == 0 and not any(r2["launches"].values()),
            f"the resumed finished run trained: {r2}")
    require(filecmp.cmp(a, b, shallow=False),
            "the resumed finished run wrote another file")
    log(f"  the same command again resumed the finished checkpoint: 0 "
        f"samples, no launches, a byte-equal file ({os.path.getsize(b):,} "
        f"bytes); {_wall(r2)}")
    os.remove(b)
    o1 = os.path.join(OUT, "line_cli_o1.txt")
    r3 = run_cli(["line", "-train", path, "-save", o1, "-order", "1",
                  "-sample_times", str(LINE_O1_CLI_SAMPLES)])
    require(r3["launches"]["band_scatter_add"] > 0,
            f"line -order 1 through the CLI did not launch K2: "
            f"{r3['launches']}")
    auc1 = yt_community_auc(_cli_table(g, o1), g.names)
    log(f"line o1 (CLI, Youtube scale, {LINE_O1_CLI_SAMPLES}M samples): "
        f"community AUC {auc1:.4f} (no gate); "
        f"{r3['samples'] / max(r3['train_s'], 1e-9):,.0f} samples/s; "
        f"{_wall(r3)}; launches {r3['launches']}")
    for f in (a, o1):
        os.remove(f)
    return k4


# ------------------------------------------------------------ the rec family
# experiments/bpr_parity.py's implicit-feedback set and the JAX package's
# quality records on it at 20M samples after a 1M warm-up (PERF_NOTES.md:
# 447-449, 773-777; BASELINE.md:54), a range taken at its lower end; each
# gate is the record less bench.py's 0.03 margin. The reference CLIs of
# mf, bpr, warp and skewopt load the graph directed; the JAX harnesses
# loaded the others undirected, with the field file for HOP-REC and the
# CSE models, which ran at walk_steps 2 (experiments/longtail_parity.py).
REC_SAMPLES, REC_WARM = 20, 1  # millions of samples
# shorter, ungated runs that keep the smoke's time (PERF.md §6): NEMF
# costs ~2.2 s a million samples; NERANK, the other CSE head, keeps the
# gate at 20M through the CLI
REC_SHORT = {"nemf": 4}
REC_MARGIN = 0.03
REC_RUNS = (  # (model, class, directed, field file, train kwargs, record)
    ("mf", "MF", True, False, {}, (0.8700, 0.927)),
    ("bpr", "BPR", True, False, {}, (0.8709, 0.9186)),
    ("warp", "WARP", True, False, {}, (0.8703, 0.9234)),
    ("skewopt", "SkewOPT", True, False, {}, (0.8707, 0.9223)),
    ("hpe", "HPE", False, False, {}, (0.8719, 0.9267)),
    ("pe", "PE", False, False, {}, None),
    ("hoprec", "HOPREC", False, True, dict(walk_steps=2), (0.8715, 0.9256)),
    ("nemf", "NEMF", False, True, dict(walk_steps=2), (0.8709, 0.9266)),
)
# NERANK trains through the command line only (phase 23)
REC_RECORDS = dict({r[0]: r[5] for r in REC_RUNS},
                   nerank=(0.8726, 0.9266))


def rec_files() -> dict:
    """The bpr_parity set and its field file under OUT (made once)."""
    from smore_tpu_torch.utils import rec_data

    os.makedirs(OUT, exist_ok=True)
    f = {k: os.path.join(OUT, f"bpr_{k}") for k in ("train.txt", "test.npz",
                                                    "field.txt")}
    rec_data.make_dataset(f["train.txt"], f["test.npz"], seed=0)
    rec_data.make_field_file(f["train.txt"], f["field.txt"])
    return f


def _rec_gate(model: str, path: str, files: dict, record,
              gated: bool = True) -> str:
    """Score a saved embedding file with bpr_parity's evaluate and apply
    the model's gate (``gated``); returns the line's scores and gate."""
    from smore_tpu_torch.utils import rec_data

    ue, ie = rec_data.load_embeddings_ui(path, D)
    require(np.isfinite(ue).all() and np.isfinite(ie).all(),
            f"{model}: non-finite rows")
    auc, rec10 = rec_data.evaluate(files["test.npz"], ue, ie)
    if record is None:
        norm = float(np.linalg.norm(np.concatenate([ue, ie]), axis=1).mean())
        require(norm > 2 * INIT_NORM, f"{model}: vertex row norm {norm:.4f} "
                f"stayed at its init scale {INIT_NORM:.4f}")
        return (f"AUC {auc:.4f} recall@10 {rec10:.4f} (no record; gate: "
                f"finite, mean vertex row norm {norm:.4f} > 2 x init)")
    gate = (record[0] - REC_MARGIN, record[1] - REC_MARGIN)
    if not gated:
        return (f"AUC {auc:.4f} recall@10 {rec10:.4f} (not gated; JAX "
                f"{record[0]} / {record[1]} at {REC_SAMPLES}M)")
    require(auc >= gate[0] and rec10 >= gate[1],
            f"{model}: AUC {auc:.4f} / recall@10 {rec10:.4f} under the gate "
            f"{gate[0]:.4f} / {gate[1]:.4f}")
    return (f"AUC {auc:.4f} recall@10 {rec10:.4f} (JAX {record[0]} / "
            f"{record[1]}, gate >= {gate[0]:.4f} / {gate[1]:.4f})")


def _no_launch(model: str, counters: dict) -> None:
    counts = {name: c.launches for name, c in counters.items()}
    require(not any(_update_launches(counts).values()),
            f"{model} launched {counts}")


def _finite(model: str, state: dict) -> None:
    for k, t in state.items():
        require(bool(torch.isfinite(t).all()), f"{model}: non-finite {k}")


def _warm_then_time(m, model: str, millions: float, kw: dict,
                    fresh: bool = False) -> tuple:
    """1M samples of warm-up (fresh tables after it when ``fresh``), then
    the timed run with every kernel's launch count set to 0 just before it:
    none may launch, every table must be finite. Returns (warm-up seconds,
    timed seconds)."""
    t0 = time.perf_counter()
    m.train(sample_times=REC_WARM, verbose=False, **kw)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    if fresh:
        m.init(dim=D)  # the sampler is kept
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    m.train(sample_times=millions, verbose=False, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    _no_launch(model, counters)
    _finite(model, m.state)
    return warm, dt


def phase_rec(files: dict, device) -> dict:
    """Eight rec models in this process: warm-up, the timed 20M run (NEMF
    4M) with every kernel count at 0 (they must stay there), the gates.
    Returns the models by name."""
    from smore_tpu_torch import models
    from smore_tpu_torch.graph.graph import Graph

    card = _card()
    out = {}
    for model, cls_name, directed, field, kw, record in REC_RUNS:
        g = Graph.load_edge_list(files["train.txt"], undirected=not directed)
        if field:
            g.load_field_meta(files["field.txt"])
        m = getattr(models, cls_name)(g, seed=0, device=device)
        m.init(dim=D)
        warm, dt = _warm_then_time(m, model,
                                   REC_SHORT.get(model, REC_SAMPLES), kw)
        path = os.path.join(OUT, f"rec_{model}.txt")
        m.save_weights(path)
        d = m.last_driver
        log(f"{model} ({'directed' if directed else 'undirected'}"
            f"{', field file' if field else ''}{', ' + str(kw) if kw else ''};"
            f" batch {d.samples_per_step // d.micro_steps} x "
            f"{d.micro_steps}): {d.executed_samples:,} samples in {dt:.3f} s "
            f"= {d.executed_samples / dt:,.0f} samples/s (warm-up "
            f"{warm:.1f} s); "
            f"{_rec_gate(model, path, files, record, model not in REC_SHORT)}"
            f"; no kernel launched [{card}]")
        os.remove(path)
        out[model] = m
    return out


def phase_rec_cli(files: dict) -> None:
    """``bpr`` (its directed default) and ``nerank`` (field file, walk_steps
    2) through the command line, 20M samples each, scored from the saved
    files by the same gates; no kernel launched."""
    card = _card()
    common = ["-dimensions", str(D), "-sample_times", str(REC_SAMPLES)]
    for model, extra in (
        ("bpr", []),
        ("nerank", ["-field", files["field.txt"], "-walk_steps", "2"]),
    ):
        save = os.path.join(OUT, f"rec_cli_{model}.txt")
        r = run_cli([model, "-train", files["train.txt"], "-save", save]
                    + common + extra)
        require(not any(_update_launches(r["launches"]).values()),
                f"{model} through the CLI launched {r['launches']}")
        scores = _rec_gate(model, save, files, REC_RECORDS[model])
        log(f"{model} (CLI, {' '.join(extra) or 'directed default'}): "
            f"{r['samples']:,} samples in {r['train_s']:.2f} s = "
            f"{r['samples'] / max(r['train_s'], 1e-9):,.0f} samples/s; "
            f"{scores}; {_wall(r)} [{card}]")
        os.remove(save)


# the community family on the sets it can learn (structured_parity's for
# GCN, TEXTGCN and FINE, the bpr_parity set for ECO), each gated at its JAX
# record less REC_MARGIN: GCN 0.9999, TEXTGCN 0.8343 (the lower of two),
# FINE 0.9993 (PERF_NOTES.md:518-529, 1055-1056), ECO 0.8688 / 0.9265 at
# 20M (PERF_NOTES.md:947); the budgets are shortened to keep the smoke's
# time, and the JAX package reaches each record at them on the CPU
# (PERF.md §2). TEXTGCNdev has no record (chance on both sides): its gate
# is finite tables that grew.
COMM_RUNS = (  # (model, class, set, train kwargs, millions timed, record)
    ("gcn", "GCN", "gcn", dict(walk_steps=5), 2, 0.9999),
    ("textgcn", "TEXTGCN", "textgcn", dict(walk_steps=2), 4, 0.8343),
    ("textgcndev", "TEXTGCNdev", "textgcn", dict(num_events=1, num_words=5),
     2, None),
    ("fine", "FINE", "fine", dict(walk_steps=2), 4, 0.9993),
    ("eco", "ECO", "bpr", {}, 10, (0.8688, 0.9265)),
)
MSFINE_RECORD, MSFINE_SAMPLES = (0.8724, 0.9268), 10  # PERF_NOTES.md:952


def structured_files() -> dict:
    """The three structured sets under OUT (made once): {set: (edge list,
    field file)}."""
    from smore_tpu_torch.utils import structured_data as sd

    os.makedirs(OUT, exist_ok=True)
    out = {}
    for name in sd.PROBES:
        out[name] = tuple(os.path.join(OUT, f"sp_{name}_{k}.txt")
                          for k in ("net", "field"))
        getattr(sd, f"make_{name}_dataset")(*out[name])
    return out


def _topic_gate(model: str, path: str, probe: str, record) -> str:
    """Score a saved file by its set's same-topic AUC; gate it at the
    record less REC_MARGIN (print it when ``record`` is None)."""
    from smore_tpu_torch.utils import structured_data as sd

    prefix, per_topic = sd.PROBES[probe]
    auc = sd.topic_auc(path, prefix, sd.topic_of(per_topic))
    if record is None:
        return f"{prefix}-row same-topic AUC {auc:.4f} (not gated)"
    gate = record - REC_MARGIN
    require(auc >= gate, f"{model}: same-topic AUC {auc:.4f} under the gate "
            f"{gate:.4f}")
    return (f"{prefix}-row same-topic AUC {auc:.4f} (JAX {record}, gate >= "
            f"{gate:.4f})")


def _textgcndev_gate(m, init_norm: float, path: str) -> str:
    """TEXTGCNdev: finite tables, vertex rows grown past twice their init
    norm, context rows non-zero, a file of exactly the doc and word rows."""
    wv, wc = m.state["vertex"], m.state["context"]
    norm = float(wv.norm(dim=1).mean())
    ctx = float(wc.norm(dim=1).mean())
    require(norm > 2 * init_norm, f"textgcndev: vertex row norm {norm:.4f} "
            f"stayed near its init {init_norm:.4f}")
    require(ctx > 0, "textgcndev: the context rows stayed 0")
    fields = m.graph.fields
    want = int((fields != 1).sum())
    with open(path) as f:
        rows = sum(1 for _ in f) - 1
    require(rows == want, f"textgcndev wrote {rows} rows, not the {want} "
            "doc and word rows")
    return (f"mean vertex row norm {init_norm:.4f} -> {norm:.4f}, context "
            f"0 -> {ctx:.4f}, {rows} doc and word rows written")


def phase_community(sp: dict, files: dict, device) -> dict:
    """Five community models in this process: warm-up, fresh tables, the
    timed run with every kernel count at 0 (they must stay there), the
    gates. Returns the models by name."""
    from smore_tpu_torch import models
    from smore_tpu_torch.graph.graph import Graph

    card = _card()
    out = {}
    for model, cls_name, data, kw, millions, record in COMM_RUNS:
        net, field = ((files["train.txt"], files["field.txt"])
                      if data == "bpr" else sp[data])
        g = Graph.load_edge_list(net, undirected=True)
        g.load_field_meta(field)
        m = getattr(models, cls_name)(g, seed=0, device=device)
        m.init(dim=D)
        # the init tables are made again by the same seed after the warm-up
        init_norm = float(m.state["vertex"].norm(dim=1).mean())
        warm, dt = _warm_then_time(m, model, millions, kw, fresh=True)
        path = os.path.join(OUT, f"comm_{model}.txt")
        m.save_weights(path)
        if data == "bpr":
            scores = _rec_gate(model, path, files, record)
        elif record is None:
            scores = (_textgcndev_gate(m, init_norm, path) + "; doc "
                      + _topic_gate(model, path, data, None))
        else:
            scores = _topic_gate(model, path, data, record)
        d = m.last_driver
        log(f"{model} ({data} set, {kw or 'defaults'}; batch "
            f"{d.samples_per_step}): {d.executed_samples:,} samples in "
            f"{dt:.3f} s = {d.executed_samples / dt:,.0f} samples/s (warm-up "
            f"{warm:.1f} s); {scores}; no kernel launched [{card}]")
        os.remove(path)
        out[model] = m
    return out


def phase_community_cli(files: dict) -> None:
    """``msfine -field ... -walk_steps 2`` through the command line on the
    bpr_parity set, scored from its wide file (both field rows) by
    bpr_parity's evaluate, gated at the JAX record less REC_MARGIN; no
    kernel launched."""
    from smore_tpu_torch.utils import rec_data

    save = os.path.join(OUT, "comm_cli_msfine.txt")
    r = run_cli(["msfine", "-train", files["train.txt"], "-save", save,
                 "-field", files["field.txt"], "-walk_steps", "2",
                 "-sample_times", str(MSFINE_SAMPLES), "-dimensions",
                 str(D)])
    require(not any(_update_launches(r["launches"]).values()),
            f"msfine through the CLI launched {r['launches']}")
    ue, ie = rec_data.load_wide_embeddings(save)
    require(ue.shape[1] == 2 * D, f"msfine wrote {ue.shape[1]} columns")
    require(np.isfinite(ue).all() and np.isfinite(ie).all(),
            "msfine: non-finite rows")
    auc, rec10 = rec_data.evaluate(files["test.npz"], ue, ie)
    gate = (MSFINE_RECORD[0] - REC_MARGIN, MSFINE_RECORD[1] - REC_MARGIN)
    require(auc >= gate[0] and rec10 >= gate[1],
            f"msfine: AUC {auc:.4f} / recall@10 {rec10:.4f} under the gate "
            f"{gate[0]:.4f} / {gate[1]:.4f}")
    log(f"msfine (CLI, -field -walk_steps 2, {2 * D} columns): "
        f"{r['samples']:,} samples in {r['train_s']:.2f} s = "
        f"{r['samples'] / max(r['train_s'], 1e-9):,.0f} samples/s; AUC "
        f"{auc:.4f} recall@10 {rec10:.4f} (JAX {MSFINE_RECORD[0]} / "
        f"{MSFINE_RECORD[1]}, gate >= {gate[0]:.4f} / {gate[1]:.4f}); "
        f"{_wall(r)} [{_card()}]")
    os.remove(save)


# the knowledge-graph and typed-graph family (phases 26-28): the JAX
# package's records at dim 64 (experiments/kg_typed_records.py on the CPU,
# the lowest of model seeds 0-2; FastRP the mean of its five projection
# seeds; PERF.md), each gated less REC_MARGIN
TYPED_RECORDS = dict(transe=0.1391, rotate=0.5211, complex=0.6553,
                     sne=0.9065, ctdne=1.0, metapath2vec=0.9984, han=0.9998,
                     cpr=0.9800, tpr=0.9634, fastrp=0.6580)
# FB15k-237's shape (Toutanova & Chen 2015: 14,541 entities, 237 relations,
# 272,115 training triples) from make_kg: 14,500 entities, 272,076 triples
FB15K_SHAPE = dict(n_clusters=145, per=100, n_rel=237, triples_per_rel=1148)


def _typed_gate(model: str, score: float, what: str,
                records=TYPED_RECORDS) -> str:
    record = records[model]
    gate = record - REC_MARGIN
    require(score >= gate, f"{model}: {what} {score:.4f} under the gate "
            f"{gate:.4f}")
    return f"{what} {score:.4f} (JAX {record}, gate >= {gate:.4f})"


def typed_files() -> dict:
    """The oracle sets of utils/oracle_data.py under OUT: {name: path} and
    the held-out pairs of the CPR and TPR sets."""
    from smore_tpu_torch.utils import oracle_data as od

    os.makedirs(OUT, exist_ok=True)
    f = {k: os.path.join(OUT, f"oracle_{k}.txt") for k in (
        "kg", "signed", "temporal", "hetero", "cpr_t", "cpr_s", "tpr_ui",
        "tpr_iw", "community")}
    od.make_kg(f["kg"])
    od.make_signed(f["signed"])
    od.make_temporal(f["temporal"])
    od.make_hetero(f["hetero"])
    f["cpr_test"] = od.make_two_domains(f["cpr_t"], f["cpr_s"])
    f["tpr_test"] = od.make_text_rec(f["tpr_ui"], f["tpr_iw"])
    if os.path.exists(f["community"]):
        os.remove(f["community"])  # make_community keeps an existing file
    od.make_community(f["community"])
    return f


def phase_typed(f: dict, device) -> dict:
    """The ten knowledge-graph and typed-graph models in this process on
    the oracle sets at go_oracle_parity's settings, dim D: every kernel
    count 0 before each, none launched, finite tables, each gated at its
    JAX record less REC_MARGIN; the rate printed."""
    from smore_tpu_torch import models
    from smore_tpu_torch.graph.graph import Graph
    from smore_tpu_torch.utils import oracle_data as od

    card = _card()
    counters = _counters()
    out = {}

    def fresh():
        for c in counters.values():
            c.launches = 0

    kr = od.RUNS["kg"]
    for model, cls in (("transe", models.TransE), ("rotate", models.RotatE),
                       ("complex", models.ComplEx)):
        m = cls.load_triples(f["kg"], seed=0, device=device)
        m.init(dim=D)
        fresh()
        t0 = time.perf_counter()
        m.train(verbose=False, **kr)
        dt = time.perf_counter() - t0
        triples = kr["epochs"] * (m.kg.n_triples // kr["batch"]) * kr["batch"]
        _no_launch(model, counters)
        _finite(model, m.state)
        mrr, h3 = od.kg_mrr(model, m.state_numpy(), m.kg, D)
        log(f"{model} ({m.kg.n_triples:,} triples, {kr}): "
            f"{triples:,} triples in {dt:.3f} s = {triples / dt:,.0f} "
            f"triples/s; {_typed_gate(model, mrr, 'MRR')} hits@3 {h3:.4f}; "
            f"no kernel launched [{card}]")
        out[model] = m

    def driven(model, m, dt, score, unit="samples"):
        d = m.last_driver
        log(f"{model}: {d.executed_samples:,} {unit} in {dt:.3f} s = "
            f"{d.executed_samples / dt:,.0f} {unit}/s "
            f"({d.samples_per_step // d.micro_steps:,} a step x "
            f"{d.micro_steps}); {score}; no kernel launched [{card}]")

    def timed_train(model, m, **kw):
        fresh()
        t0 = time.perf_counter()
        m.train(verbose=False, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        _no_launch(model, counters)
        _finite(model, m.state)
        out[model] = m
        return dt

    r = dict(od.RUNS["sne"])
    m = models.SNE.load_edge_list(f["signed"], undirected=False, seed=0,
                                  beta=r.pop("beta"),
                                  negative_samples=r.pop("negative_samples"),
                                  device=device)
    m.init(dim=D)
    dt = timed_train("sne", m, **r)
    st = m.state_numpy()
    driven("sne", m, dt, _typed_gate("sne", od.sign_auc(
        m.net, st["source"], st["target"]), "sign AUC"))

    r = dict(od.RUNS["ctdne"])
    m = models.CTDNE.load_edge_list(f["temporal"], seed=0, device=device,
                                    time_window=r.pop("time_window"))
    m.init(dim=D)
    dt = timed_train("ctdne", m, **r)
    driven("ctdne", m, dt, _typed_gate("ctdne", od.community_auc_emb(
        m.state_numpy()["vertex"], od.temporal_labels(m.tg.names)),
        "community AUC"), "walks")

    r = dict(od.RUNS["metapath2vec"])
    m = models.Metapath2Vec.load_edge_list(f["hetero"], seed=0,
                                           device=device)
    for mp in r.pop("meta_paths"):
        m.add_meta_path(mp)
    m.init(dim=D)
    dt = timed_train("metapath2vec", m, **r)
    driven("metapath2vec", m, dt, _typed_gate(
        "metapath2vec", od.author_auc(m.hg.names,
                                      m.state_numpy()["vertex"]),
        "author topic AUC"), "walks")

    r = dict(od.RUNS["han"])
    m = models.HAN.load_edge_list(f["hetero"], seed=0, device=device)
    for mp in r.pop("meta_paths"):
        m.add_meta_path(mp)
    m.init(dim=D, learning_rate=r.pop("learning_rate"))
    dt = timed_train("han", m, **r)
    nodes = r["epochs"] * (m.hg.n_vertices // 512 + 1) * 512
    log(f"han: {nodes:,} node updates in {dt:.3f} s = {nodes / dt:,.0f} "
        f"nodes/s (batch 512, groups of 32); {_typed_gate('han', od.author_auc(m.hg.names, m.state_numpy()['embed']), 'author topic AUC')}"
        f"; no kernel launched [{card}]")

    tu, ti = f["cpr_test"]
    m = models.CPR.load_domains(f["cpr_t"], f["cpr_s"], seed=0, device=device)
    m.init(dim=D)
    dt = timed_train("cpr", m, **od.RUNS["cpr"])
    st = m.state_numpy()
    driven("cpr", m, dt, _typed_gate("cpr", od.cpr_auc(
        m.target, m.source, tu, ti, st["user"], st["target"],
        m.target.name2id), "AUC"))

    r = dict(od.RUNS["tpr"])
    tu, ti = f["tpr_test"]
    tw = r.pop("text_weight")
    m = models.TPR.load_graphs(f["tpr_ui"], f["tpr_iw"], seed=0,
                               text_weight=tw, device=device)
    m.init(dim=D)
    dt = timed_train("tpr", m, **r)
    st = m.state_numpy()
    driven("tpr", m, dt, _typed_gate("tpr", od.tpr_auc(
        m.ui, m.iw, tu, ti, st["user"], st["item"], st["word"],
        m.ui.name2id, m.iw.name2id, tw), "AUC"))

    g = Graph.load_edge_list(f["community"], undirected=True)
    labels = od.community_labels(g.names)
    fresh()
    scores, secs = [], 0.0
    for seed in od.RUNS["fastrp"]["seeds"]:
        m = models.FastRP(g, seed=seed, iterations=od.RUNS["fastrp"][
            "iterations"], device=device)
        t0 = time.perf_counter()
        m.generate(dim=D)
        torch.cuda.synchronize()
        secs += time.perf_counter() - t0
        _finite("fastrp", m.state)
        scores.append(od.community_auc_emb(m.state["vertex"].cpu().numpy(),
                                           labels))
    _no_launch("fastrp", counters)
    log(f"fastrp ({g.n_vertices} vertices, iterations 3, 5 seeds): "
        f"{secs / 5 * 1e3:.2f} ms a projection; "
        f"{_typed_gate('fastrp', float(np.mean(scores)), '5-seed mean community AUC')}"
        f" (seeds {', '.join(f'{x:.4f}' for x in scores)}); no kernel "
        f"launched [{card}]")
    return out


def phase_typed_scale(g_yt, device):
    """TransE at FB15k-237's shape (one warm-up epoch, then 5 timed; MRR
    above the untrained tables', unit entity rows) and FastRP on the
    Youtube-scale graph (finite rows, unit or all zero). Returns the TransE
    model."""
    from smore_tpu_torch import models
    from smore_tpu_torch.utils import oracle_data as od
    from smore_tpu_torch.utils.bench_graphs import yt_community_auc

    card = _card()
    counters = _counters()
    path = os.path.join(OUT, "fb15k_shape.txt")
    t0 = time.perf_counter()
    od.make_kg(path, **FB15K_SHAPE)
    m = models.TransE.load_triples(path, seed=0, device=device)
    kg = m.kg
    log(f"FB15k-237-shaped set: {kg.n_entities:,} entities, "
        f"{kg.n_relations} relations, {kg.n_triples:,} triples "
        f"({time.perf_counter() - t0:.1f} s to make and load)")
    m.init(dim=D)
    mrr0 = od.kg_mrr("transe", m.state_numpy(), kg, D)[0]
    m.train(epochs=1, batch=1024, alpha=0.01, verbose=False)
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    m.train(epochs=5, batch=1024, alpha=0.01, verbose=False)
    dt = time.perf_counter() - t0
    _no_launch("transe", counters)
    _finite("transe", m.state)
    norms = m.state["entity"].norm(dim=1)
    require(bool(((norms - 1).abs() < 1e-4).all()),
            "transe: entity rows not unit")
    mrr, h3 = od.kg_mrr("transe", m.state_numpy(), kg, D)
    require(mrr > mrr0, f"transe: MRR {mrr:.4f} not above the untrained "
            f"{mrr0:.4f}")
    triples = 5 * (kg.n_triples // 1024) * 1024
    log(f"transe at FB15k-237's shape (dim {D}, batch 1024, 1 warm-up "
        f"epoch, then 5 timed on a fresh lr schedule): "
        f"{triples:,} triples in {dt:.3f} s = {triples / dt:,.0f} "
        f"triples/s; MRR {mrr:.4f} hits@3 {h3:.4f} (untrained {mrr0:.4f}); "
        f"unit entity rows; no kernel launched [{card}]")

    for c in counters.values():
        c.launches = 0
    frp = models.FastRP(g_yt, seed=42, iterations=3, device=device)
    frp.generate(dim=D)  # warm-up (allocator, first index_add_)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frp.generate(dim=D)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    _no_launch("fastrp", counters)
    x = frp.state["vertex"]
    _finite("fastrp", frp.state)
    # a row is 0 where the sparse projection (5% of entries non-zero) drew
    # nothing for the vertex and its neighbourhood, as in the JAX package
    norm = x.norm(dim=1)
    zero = norm == 0
    require(bool(((norm - 1).abs() < 1e-4)[~zero].all()),
            "fastrp: rows neither unit nor zero")
    auc = yt_community_auc(x.cpu().numpy(), g_yt.names)
    log(f"fastrp at Youtube scale ({g_yt.n_vertices:,} vertices, "
        f"{g_yt.n_edges:,} directed edges, iterations 3, dim {D}): "
        f"{dt:.3f} s; community AUC {auc:.4f} (not gated); finite rows, "
        f"unit but {int(zero.sum()):,} all-zero; no kernel launched "
        f"[{card}]")
    return m


def phase_typed_cli(f: dict) -> None:
    """``rotate`` and ``cpr`` through the command line at phase 26's
    settings, scored from their saved files by phase 26's gates."""
    from smore_tpu_torch.graph.graph import Graph
    from smore_tpu_torch.graph.knowledge import KnowledgeGraph
    from smore_tpu_torch.io.embeddings import load_embeddings
    from smore_tpu_torch.utils import oracle_data as od

    card = _card()
    kr = od.RUNS["kg"]
    ent, rel = (os.path.join(OUT, f"cli_rotate_{k}.txt") for k in "er")
    r = run_cli(["rotate", "-train", f["kg"], "-save_entity", ent,
                 "-save_relation", rel, "-dimensions", str(D), "-epochs",
                 str(kr["epochs"]), "-batch_size", str(kr["batch"]),
                 "-alpha", str(kr["alpha"]), "-margin", "6.0"])
    require(not any(r["launches"].values()),
            f"rotate through the CLI launched {r['launches']}")
    kg = KnowledgeGraph.load_triples(f["kg"])
    e, rl = load_embeddings(ent), load_embeddings(rel)
    st = {"entity": np.stack([e[nm] for nm in kg.entities]),
          # the relation file holds cos | sin of each phase
          "relation": np.stack([np.arctan2(rl[nm][D:], rl[nm][:D])
                                for nm in kg.relations_names])}
    require(st["entity"].shape == (kg.n_entities, 2 * D),
            f"rotate wrote {st['entity'].shape}")
    require(all(np.isfinite(v).all() for v in st.values()),
            "rotate: non-finite rows")
    mrr, _ = od.kg_mrr("rotate", st, kg, D)
    log(f"rotate (CLI, -epochs {kr['epochs']} -batch_size {kr['batch']}): "
        f"{_typed_gate('rotate', mrr, 'MRR')}; {_wall(r)} [{card}]")
    for p in (ent, rel):
        os.remove(p)

    tu, ti = f["cpr_test"]
    files = [os.path.join(OUT, f"cli_cpr_{k}.txt") for k in ("u", "t", "s")]
    r = run_cli(["cpr", "-train_target", f["cpr_t"], "-train_source",
                 f["cpr_s"], "-save_user", files[0], "-save_target",
                 files[1], "-save_source", files[2], "-dimensions", str(D),
                 "-update_times", str(od.RUNS["cpr"]["update_times"]),
                 "-alpha", str(od.RUNS["cpr"]["alpha"])])
    require(not any(r["launches"].values()),
            f"cpr through the CLI launched {r['launches']}")
    g_t = Graph.load_edge_list(f["cpr_t"], undirected=True)
    g_s = Graph.load_edge_list(f["cpr_s"], undirected=True)
    u, t = load_embeddings(files[0]), load_embeddings(files[1])
    user = np.stack([u[nm] for nm in g_t.names])
    target = np.stack([t[nm] for nm in g_t.names])
    require(np.isfinite(user).all() and np.isfinite(target).all(),
            "cpr: non-finite rows")
    auc = od.cpr_auc(g_t, g_s, tu, ti, user, target, g_t.name2id)
    log(f"cpr (CLI, -update_times {od.RUNS['cpr']['update_times']}): "
        f"{r['samples']:,} samples in {r['train_s']:.2f} s; "
        f"{_typed_gate('cpr', auc, 'AUC')}; {_wall(r)} [{card}]")
    for p in files:
        os.remove(p)


# JODIE and the SASRec family (phases 29-32): the JAX package's records at
# dim 64 and the smoke's budgets (experiments/seq_records.py on the CPU,
# the lowest of model seeds 0-2; PERF.md), each gated less REC_MARGIN:
# JODIE's pairwise accuracy on the static tables in both arms (bce_lr at
# its default, the learning rate, and at 0.2), the SASRec family's
# recall@10 of the leave-one-out ranking
SEQ_RECORDS = dict(jodie=0.522, jodie_bce=0.863, sasrec=0.471,
                   gsasrec=0.493, recdenoiser=0.512)
# the same records of JODIE's two arms at dim 128 (seq_records.py --dim 128)
SEQ_RECORDS_128 = dict(jodie=0.736, jodie_bce=0.863)
# forward-only SASRec (the reference's semantics) at 100 epochs, dim 64:
# recall@10 0.1860 (PERF_NOTES.md:261, one seed), printed beside the CLI's
SASREC_FORWARD_ONLY_JAX = 0.1860


def seq_files() -> dict:
    """go_oracle_parity's interaction set and sasrec_eval's Markov set
    (utils/seq_data.py) under OUT."""
    from smore_tpu_torch.utils import seq_data as sd

    os.makedirs(OUT, exist_ok=True)
    f = {"events": os.path.join(OUT, "jodie_events.txt"),
         "seq": os.path.join(OUT, "sasrec_markov.txt")}
    sd.make_interactions(f["events"])
    if os.path.exists(f["seq"]):
        os.remove(f["seq"])  # make_data keeps an existing file
    sd.make_data(f["seq"])
    return f


def _jodie_epoch_inputs(m, dim, device, events=None):
    """JODIE ``m`` at init(dim) (seed 0) and one epoch's kernel arguments
    but the tables, over its first ``events`` events (all when None):
    (args after the four tables, the level schedule)."""
    from smore_tpu_torch.ops.jodie_epoch import level_schedule
    from smore_tpu_torch.utils import seq_data as sd

    m.init(dim)
    ig = m.ig
    T = ig.n_interactions if events is None else events
    gen = torch.Generator(device).manual_seed(1)
    negs = torch.randint(0, ig.n_items, (ig.n_interactions,), generator=gen,
                         device=device, dtype=torch.int32)[:T]
    uid, iid, cu, ci = (t[:T] for t in m.scan_inputs(m.state))
    sched = level_schedule(uid, iid, negs, ig.n_users, ig.n_items, device)
    return (uid, iid, negs, cu, ci, m.state["user_rnn"], m.state["item_rnn"],
            sd.JODIE_RUN["learning_rate"],
            sd.JODIE_ARMS["jodie_bce"]), sched


def _jodie_tables(m):
    ue, ie = (m.state[k].clone() for k in ("user_static", "item_static"))
    return [ue, ie, ue.clone(), ie.clone()]


def _jodie_check(tag, m, args, sched) -> tuple:
    """One epoch through the kernel and through its plain loop, the same
    draws: the four tables and the loss must agree. Returns (max |diff|,
    the loop's ms on the host clock: it is bound by its launches); logs
    the tables' max |diff| and the loss's (a sum of T terms, taken in
    another order)."""
    from smore_tpu_torch.ops import jodie_epoch as je

    a, b = _jodie_tables(m), _jodie_tables(m)
    la = je.jodie_epoch(*a, *args, sched)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lb = je.jodie_epoch_ref(*b, *args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    errs = [_compare(f"{tag} {k}", x, y) for k, x, y in zip(
        ("ue", "ie", "us", "is_", "loss"), a + [la], b + [lb])]
    log(f"{tag}: tables max |diff| {max(errs[:4]):.3e}, loss {float(la):.4f} "
        f"vs {float(lb):.4f}")
    return max(errs), plain_ms


def _jodie_bound(T, U, I, D) -> dict:
    """Two dot products, the BCE step, four D x D products (two cells), the
    tanh and the statics' step an event, multiply-adds counted twice; the
    four tables read and written once, ids, cu / ci, the weights."""
    flops = T * (8 * D * D + 24 * D)
    nbytes = (4 * (U + I) * D + 3 * T + 2 * T * D + 4 * D * D + 1) * 4
    return _bound("jodie_epoch", flops, nbytes)


def _jodie_layout(D, sched) -> str:
    from smore_tpu_torch.ops.jodie_epoch import kernel_plan

    p = kernel_plan(D, sched.max_width)
    return (f"{p['grid']} blocks of 256 threads, split {p['split']}, "
            f"grid barrier, {p['cached_rows']} weight rows of a block cached "
            f"in {p['smem_bytes']:,} B of shared memory")


def phase_jodie_vs_twin(path: str, device) -> dict:
    """The jodie_epoch kernel against its plain loop on one epoch of the
    8,000-event set at dim D (JODIE's own init, bce_lr 0.2, negatives from
    a seeded generator, neg == i among them): the four tables and the loss
    must agree; a call is ONE launch of jodie_levels; the loop's time, the
    kernel's, the levels, the layout, the bound. Then dims 50, 128 and 256
    against the loop on 1,500 events of the set's generator."""
    from smore_tpu_torch.models import JODIE
    from smore_tpu_torch.ops import _build
    from smore_tpu_torch.ops import jodie_epoch as je
    from smore_tpu_torch.utils import seq_data as sd

    jodie_epoch = je.jodie_epoch
    card = _card()
    m = JODIE.load_interactions(path, seed=0, device=device)
    args, sched = _jodie_epoch_inputs(m, D, device)
    ig = m.ig
    T, U, I = ig.n_interactions, ig.n_users, ig.n_items
    require(bool((args[2].cpu().numpy() == ig.item_ids).any()),
            "jodie_epoch check: no event with neg == i")
    err, plain_ms = _jodie_check("jodie_epoch", m, args, sched)
    scratch = _jodie_tables(m)
    t_kern = [_time_ms(lambda: jodie_epoch(*scratch, *args, sched), 5)
              for _ in range(2)]
    for _ in range(3):
        host, kernels = _cuda_work(
            lambda: jodie_epoch(*scratch, *args, sched))
        require(len(host) == 3 and all(h.startswith("cudaLaunchKernel")
                                       for h in host)
                and len(kernels) <= 3
                and all("jodie_levels" in k for k in kernels),
                f"jodie_epoch: 3 calls put {host} / {kernels} on the card, "
                "not 3 launches of jodie_levels")
        if kernels:
            break
    log(f"jodie_epoch CUDA launches per call (profiler, 3 calls): host "
        f"{len(host) / 3:g} {sorted(set(host))}, device kernels recorded "
        f"{len(kernels)} {sorted(set(kernels)) or '(none: CUPTI dropped them)'}")
    for line in _build.build_info["jodie_epoch"][1].splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    ms = min(t_kern)
    log(f"jodie_epoch vs twin (T={T:,} events, {U} users, {I} items, "
        f"D={D}, bce_lr {args[-1]}): max |diff| {err:.3e}; kernel {ms:.4f} "
        f"ms an epoch {t_kern}; {sched.n_levels:,} levels (mean width "
        f"{T / sched.n_levels:.1f}, widest {sched.max_width}); "
        f"{_jodie_layout(D, sched)}; plain loop {plain_ms:.1f} ms "
        f"({plain_ms / ms:.0f}x) [{card}]")
    out = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
               **_jodie_bound(T, U, I, D), library_ms=None)
    small = os.path.join(OUT, "jodie_events_1500.txt")
    sd.make_interactions(small, events=1500)
    for dim in (50, 128, 256):
        m = JODIE.load_interactions(small, seed=0, device=device)
        a, sch = _jodie_epoch_inputs(m, dim, device)
        e, p_ms = _jodie_check(f"jodie_epoch D={dim}", m, a, sch)
        sc = _jodie_tables(m)
        t = _time_ms(lambda: jodie_epoch(*sc, *a, sch), 5)
        log(f"jodie_epoch vs twin at D={dim} (T=1,500, {sch.n_levels:,} "
            f"levels): max |diff| {e:.3e}; kernel {t:.4f} ms, plain loop "
            f"{p_ms:.1f} ms; {_jodie_layout(dim, sch)} [{card}]")
    os.remove(small)
    return out


def phase_jodie(path: str, device) -> int:
    """JODIE's main path in this process: go_oracle_parity.run_jodie's
    settings at dim D, both arms (bce_lr at its default and 0.2), every
    kernel count 0 before the first: one jodie_epoch launch an epoch and
    no other kernel, finite tables, the static tables' pairwise accuracy
    gated at the JAX record less REC_MARGIN. Returns the launches."""
    from smore_tpu_torch.models import JODIE
    from smore_tpu_torch.utils import seq_data as sd

    card = _card()
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    epochs = sd.JODIE_RUN["epochs"]
    for arm, bce in sd.JODIE_ARMS.items():
        m = JODIE.load_interactions(path, seed=0, device=device)
        m.init(D)
        t0 = time.perf_counter()
        m.train(bce_lr=bce, verbose=False, **sd.JODIE_RUN)
        dt = time.perf_counter() - t0  # train() synchronises at its end
        ig = m.ig
        st = {k: m.state[k] for k in ("user_static", "item_static")}
        _finite(arm, dict(st, user_dyn=m.user_dyn, item_dyn=m.item_dyn))
        acc = sd.jodie_eval(st["user_static"].cpu().numpy(),
                            st["item_static"].cpu().numpy(), ig.user_ids,
                            ig.item_ids, ig.n_items)
        events = epochs * ig.n_interactions
        log(f"{arm} ({ig.n_interactions:,} events, {ig.n_users} users x "
            f"{ig.n_items} items, dim {D}, {epochs} epochs, lr "
            f"{sd.JODIE_RUN['learning_rate']}, bce_lr "
            f"{bce if bce is not None else 'the lr'}): {dt:.3f} s = "
            f"{dt / epochs * 1e3:.2f} ms an epoch, {events / dt:,.0f} "
            f"events/s; static "
            f"{_typed_gate(arm, acc, 'pairwise accuracy', SEQ_RECORDS)}; "
            f"dynamic {m.evaluate_predictions():.4f} [{card}]")
    launches = counters["jodie_epoch"].launches
    require(launches == 2 * epochs,
            f"jodie: {launches} jodie_epoch launches, not {2 * epochs}")
    _no_launch("jodie", {k: c for k, c in counters.items()
                         if k != "jodie_epoch"})
    return launches


JODIE_FULL_DIM = 128  # the JODIE paper's embedding dim


def phase_jodie_full(path: str, device) -> None:
    """JODIE at full width: both arms on the 8,000-event set at dim 128,
    gated at SEQ_RECORDS_128 less REC_MARGIN; then the Wikipedia shape at
    dim 128, 172 features: the kernel against its plain loop on the first
    4,000 events, eight epochs of train() (one launch each), finite tables,
    the static tables' pairwise accuracy, the kernel's and the schedule's
    ms, the levels and the share of the bound."""
    from smore_tpu_torch.graph.bipartite import InteractionGraph
    from smore_tpu_torch.models import JODIE
    from smore_tpu_torch.ops import jodie_epoch as je
    from smore_tpu_torch.utils import seq_data as sd

    card = _card()
    counters = _counters()
    dim = JODIE_FULL_DIM
    epochs = sd.JODIE_RUN["epochs"]
    for c in counters.values():
        c.launches = 0
    for arm, bce in sd.JODIE_ARMS.items():
        m = JODIE.load_interactions(path, seed=0, device=device)
        m.init(dim)
        t0 = time.perf_counter()
        m.train(bce_lr=bce, verbose=False, **sd.JODIE_RUN)
        dt = time.perf_counter() - t0
        st = {k: m.state[k] for k in ("user_static", "item_static")}
        _finite(arm, dict(st, user_dyn=m.user_dyn, item_dyn=m.item_dyn))
        acc = sd.jodie_eval(st["user_static"].cpu().numpy(),
                            st["item_static"].cpu().numpy(), m.ig.user_ids,
                            m.ig.item_ids, m.ig.n_items)
        log(f"{arm} at dim {dim} ({m.ig.n_interactions:,} events, {epochs} "
            f"epochs): {dt / epochs * 1e3:.2f} ms an epoch; static "
            f"{_typed_gate(arm, acc, 'pairwise accuracy', SEQ_RECORDS_128)}"
            f" [{card}]")
    require(counters["jodie_epoch"].launches == 2 * epochs,
            f"jodie at dim {dim}: {counters['jodie_epoch'].launches} "
            f"launches, not {2 * epochs}")

    t0 = time.perf_counter()
    ig = InteractionGraph.from_events(*sd.interaction_arrays(
        **sd.WIKIPEDIA))
    build_s = time.perf_counter() - t0
    m = JODIE(ig, seed=0, device=device)
    T, U, I = ig.n_interactions, ig.n_users, ig.n_items
    args, sched = _jodie_epoch_inputs(m, dim, device, events=4000)
    err, plain_ms = _jodie_check("jodie_epoch (Wikipedia shape)", m, args,
                                 sched)
    log(f"Wikipedia shape ({U:,} users, {I:,} items, {T:,} events, "
        f"{ig.feature_dim} features; built in {build_s:.1f} s): the first 4,000 events at D={dim} ({sched.n_levels:,} "
        f"levels) against the plain loop: max |diff| {err:.3e} ({plain_ms:.0f}"
        f" ms for the loop) [{card}]")
    args, sched = _jodie_epoch_inputs(m, dim, device)
    sched_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        je.level_schedule(ig.user_ids, ig.item_ids, args[2], U, I, device)
        torch.cuda.synchronize()
        sched_ms.append((time.perf_counter() - t0) * 1e3)
    scratch = _jodie_tables(m)
    t_kern = [_time_ms(lambda: je.jodie_epoch(*scratch, *args, sched), 3)
              for _ in range(2)]
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    m.train(epochs=epochs, learning_rate=sd.JODIE_RUN["learning_rate"],
            bce_lr=sd.JODIE_ARMS["jodie_bce"], verbose=False)
    dt = time.perf_counter() - t0
    launches = counters["jodie_epoch"].launches
    require(launches == epochs,
            f"jodie, Wikipedia shape: {launches} launches, not {epochs}")
    _no_launch("jodie", {k: c for k, c in counters.items()
                         if k != "jodie_epoch"})
    st = {k: m.state[k] for k in ("user_static", "item_static")}
    _finite("jodie (Wikipedia shape)",
            dict(st, user_dyn=m.user_dyn, item_dyn=m.item_dyn))
    require(m.user_dyn.shape == (U, dim), "jodie: user table shape")
    acc = sd.jodie_eval(st["user_static"].cpu().numpy(),
                        st["item_static"].cpu().numpy(), ig.user_ids,
                        ig.item_ids, I)
    bound = _jodie_bound(T, U, I, dim)
    ms = min(t_kern)
    log(f"jodie, Wikipedia shape at D={dim}: {epochs} epochs in {dt:.3f} s "
        f"= {dt / epochs * 1e3:.2f} ms an epoch, {epochs * T / dt:,.0f} "
        f"events/s, {launches} jodie_epoch launches; kernel {ms:.4f} ms an "
        f"epoch {t_kern}; schedule {min(sched_ms):.2f} ms {sched_ms}; "
        f"{sched.n_levels:,} levels, mean width {T / sched.n_levels:.1f}, "
        f"widest {sched.max_width}; {_jodie_layout(dim, sched)}; bound "
        f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}), "
        f"{bound['bound_ms'] / ms:.1%} of it; static pairwise accuracy "
        f"{acc:.4f} (ungated) [{card}]")


def phase_seq(path: str, device) -> dict:
    """SASRec, gSASRec and Rec-Denoiser in this process on sasrec_eval's
    Markov set at its full-autodiff settings (dim D, max_seq_len 30, 2
    blocks, 1 head, dropout 0.2, 5 negatives, lr 3e-3, batch 128, 100
    epochs, the last item held out): every kernel count 0 before each, none
    launched, finite parameters, recall@10 gated at the JAX record less
    REC_MARGIN; steps/s and sequences/s printed."""
    from smore_tpu_torch import models
    from smore_tpu_torch.utils import seq_data as sd

    card = _card()
    counters = _counters()
    out = {}
    tr = sd.SEQ_TRAIN
    for model, cls_name in sd.SEQ_MODELS.items():
        m = getattr(models, cls_name).load_edge_list(
            path, seed=0, negative_samples=sd.SEQ_NEG, device=device)
        m.init(dim=D, **sd.SEQ_INIT)
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        m.train(verbose=False, **tr)
        dt = time.perf_counter() - t0  # train() synchronises at its end
        _no_launch(model, counters)
        _finite(model, dict(m.net.named_parameters()))
        n_seq = len(m._holdout_seqs)
        bs = min(tr["batch_size"], n_seq)
        steps = tr["epochs"] * (n_seq // bs)
        r = m.evaluate_ranking(ks=(10,))
        log(f"{model} ({n_seq:,} sequences, {m.graph.n_vertices:,} "
            f"vertices, dim {D}, {sd.SEQ_INIT}, {sd.SEQ_NEG} negatives, "
            f"{tr}): {steps:,} steps in {dt:.3f} s = {steps / dt:.1f} "
            f"steps/s, {steps * bs / dt:,.0f} sequences/s; "
            f"{_typed_gate(model, r['recall@10'], 'recall@10', SEQ_RECORDS)}"
            f" NDCG@10 {r['ndcg@10']:.4f}; no kernel launched [{card}]")
        out[model] = m
    return out


def phase_seq_cli(f: dict) -> None:
    """``jodie`` and ``sasrec -forward_only 1 -eval_holdout 1`` through the
    command line: exit 0, well-formed files with finite rows, one
    jodie_epoch launch an epoch; the forward-only recall@10 printed beside
    its JAX record."""
    import re

    from smore_tpu_torch.graph.bipartite import InteractionGraph
    from smore_tpu_torch.graph.graph import Graph
    from smore_tpu_torch.io.embeddings import load_embeddings
    from smore_tpu_torch.utils import seq_data as sd

    card = _card()

    def well_formed(path, names, dim=D):
        with open(path) as fh:
            header = fh.readline().split()
        emb = load_embeddings(path)
        require(header == [str(len(names)), str(dim)] and set(emb) ==
                set(names), f"{path}: header {header}, {len(emb)} rows")
        rows = np.stack([emb[n] for n in names])
        require(rows.shape == (len(names), dim) and np.isfinite(rows).all(),
                f"{path}: rows {rows.shape}, finite "
                f"{np.isfinite(rows).all()}")
        return rows

    epochs = sd.JODIE_RUN["epochs"]
    files = [os.path.join(OUT, f"cli_jodie_{k}.txt") for k in ("u", "i")]
    ig = InteractionGraph.load_interactions(f["events"])
    for dim in (D, JODIE_FULL_DIM):
        r = run_cli(["jodie", "-train", f["events"], "-save_user", files[0],
                     "-save_item", files[1], "-dimensions", str(dim),
                     "-epochs", str(epochs), "-alpha",
                     str(sd.JODIE_RUN["learning_rate"])])
        others = {k: v for k, v in r["launches"].items()
                  if k != "jodie_epoch"}
        require(r["launches"]["jodie_epoch"] == epochs and not any(
            others.values()),
            f"jodie -dimensions {dim} through the CLI launched "
            f"{r['launches']}")
        ue = well_formed(files[0], ig.users, dim)
        ie = well_formed(files[1], ig.items, dim)
        acc = sd.jodie_eval(ue, ie, ig.user_ids, ig.item_ids, ig.n_items)
        log(f"jodie (CLI, -dimensions {dim} -epochs {epochs}): "
            f"{r['launches']['jodie_epoch']} jodie_epoch launches; files "
            f"{len(ig.users)} x {dim} and {len(ig.items)} x {dim}, finite; "
            f"dynamic tables' pairwise accuracy {acc:.4f} (ungated); "
            f"{_wall(r)} [{card}]")
        for p in files:
            os.remove(p)

    tr = sd.SEQ_TRAIN
    save = os.path.join(OUT, "cli_sasrec.txt")
    r = run_cli(["sasrec", "-train", f["seq"], "-save", save, "-dimensions",
                 str(D), "-max_seq_len", str(sd.SEQ_INIT["max_seq_len"]),
                 "-epochs", str(tr["epochs"]), "-batch_size",
                 str(tr["batch_size"]), "-alpha", str(tr["alpha"]),
                 "-negative_samples", str(sd.SEQ_NEG), "-forward_only", "1",
                 "-eval_holdout", "1"], timeout=600)
    require(not any(r["launches"].values()),
            f"sasrec through the CLI launched {r['launches']}")
    found = re.findall(r"recall@10: ([\d.]+)", r["stdout"])
    require(len(found) == 1, "sasrec: no recall@10 line")
    well_formed(save, Graph.load_edge_list(f["seq"], undirected=False).names)
    log(f"sasrec (CLI, -forward_only 1 -eval_holdout 1, -epochs "
        f"{tr['epochs']}): recall@10 {found[0]} (JAX forward-only "
        f"{SASREC_FORWARD_ONLY_JAX}, one seed; ungated); file well-formed; "
        f"no kernel launched; {_wall(r)} [{card}]")
    os.remove(save)


# ------------------------------------------ multi-device modes (phase 33)
# (a) one NCCL rank in this process at MESH_ONE_MILLIONS a mode, eager and
# captured; (b) two gloo ranks sharing the card, as child processes of this
# script. A "dp" call is 128 steps of 32,768 samples and a "rows" call 4 of
# 32 x 32,768, so 16M is 4 calls: the eager first call, the capture and 3
# replays ("hogwild" calls are 262,144 samples: 62 calls)
MESH_ONE_MILLIONS = 16
MESH_RANKS = 2
MESH_RUNS = (  # (mode, millions in all, LINE o2 train kwargs, kernel)
    # rows: one logical stream, so the single-device run's AUC less atomics'
    # reordering; dp: each rank's batch is the single-device batch / ranks,
    # so a merged step applies the 32768 samples the 0.99 gate was
    # measured at; hogwild: the multiblock route on every rank
    ("rows", 8, dict(sharding="rows", use_pallas=True), "sgns_shared_grads"),
    ("dp", SAMPLE_TIMES, dict(use_pallas=True,
                              batch=B_UNBANDED // MESH_RANKS),
     "sgns_shared_grads"),
    ("hogwild", SAMPLE_TIMES, dict(banded=True), "sgns_banded_multiblock"),
)
AUC_ROWS_TOL = 0.005  # rows against one device at the same seed and budget
AUC_HOG_TOL = 0.01  # hogwild against one device's banded run


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mesh_run(m, millions: float, counter: str, warm: bool = True,
              **kw) -> dict:
    """With ``warm``, 1M samples (tables, stream, warm-up) and fresh tables
    first; then ``m.train`` with every launch count set to 0 just before
    it. Returns its samples/s, collectives, launches of ``counter`` (gated
    on > 0), calls and replays, the split of a captured run's seconds and
    its graph's nodes; checks that the tables are finite."""
    from smore_tpu_torch.parallel.mesh import full_table

    if warm:
        m.train(sample_times=1, **TRAIN_KW, **kw)
        m.init(dim=D, order=2)
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m.train(sample_times=millions, **TRAIN_KW, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    d = m.last_driver
    launches = counters[counter].launches
    mode = d.sharding if kw.get("mesh") is not None else "single device"
    require(launches > 0, f"{mode}: the path never launched {counter}")
    for k, t in m.state.items():
        require(bool(torch.isfinite(full_table(t)).all()),
                f"non-finite {k} table")
    return dict(rate=d.executed_samples / dt, seconds=dt,
                executed=d.executed_samples, launches=launches,
                comm_s=d.comm.seconds, comm_calls=d.comm.calls,
                comm_bytes=d.comm.bytes, calls=d.calls, replays=d.replays,
                first_call_s=d.first_call_s, capture_s=d.capture_s,
                replay_s=d.replay_s, replay_host_s=d.replay_host_s,
                nodes=sum(d.loop.nodes.values()),
                per_call=d.steps_per_call * d.samples_per_step)


def _mesh_line(r: dict) -> str:
    """A mesh run's samples/s, collectives and launches. The collectives'
    seconds: an eager run's host seconds inside them, the device
    synchronised before and after each; a captured run's collectives run
    inside CUDA graphs, where nothing can be timed: "not timed"."""
    secs = ("not timed (captured)" if r["comm_s"] is None
            else f"{r['comm_s']:.3f} s")
    return (f"{r['executed']:,} samples in {r['seconds']:.3f} s = "
            f"{r['rate']:,.0f} samples/s; collectives {r['comm_calls']} "
            f"calls, {r['comm_bytes'] / 1e9:.3f} GB, {secs}; "
            f"launches {r['launches']}")


def mesh_rank_main(rank: int, world: int, port: int) -> None:
    """One gloo rank of phase 33 (b): the MESH_RUNS on the 50k graph that
    phase 16 wrote, printing one ``MESH_RANK {json}`` line."""
    from smore_tpu_torch.graph.graph import Graph
    from smore_tpu_torch.models.line import LINE
    from smore_tpu_torch.parallel.mesh import (
        backend_of,
        full_table,
        init_distributed,
        make_mesh,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    g = Graph.load_edge_list(os.path.join(OUT, "comm_net_50k.txt"),
                             undirected=True)
    sys.stdin.readline()  # the parent's go, after its own runs
    init_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo")
    mesh = make_mesh()
    out = dict(rank=rank, backend=backend_of(mesh))
    for mode, millions, kw, counter in MESH_RUNS:
        m = LINE(g, seed=0, device="cuda")
        m.init(dim=D, order=2)
        # not warmed: at 8M and 40M the set-up is small beside the gloo
        # collectives, and a warm-up rounds up to a whole call (4M)
        r = _mesh_run(m, millions, counter, warm=False, mesh=mesh, **kw)
        r["sharding"] = m.last_driver.sharding
        emb = full_table(m.state["vertex"]).cpu().numpy()
        if rank == 0:
            r["auc"] = community_auc_50k(emb, g.names)
            if mode == "rows":
                np.save(os.path.join(OUT, "mesh_rows_vertex.npy"), emb)
        out[mode] = r
    torch.distributed.destroy_process_group()
    print("MESH_RANK " + json.dumps(out), flush=True)


def phase_mesh(g, device) -> None:
    """(a) LINE o2 on the 50k graph under dp and rows (unbanded,
    use_pallas=True: K1) and hogwild (banded=True: the multiblock route,
    K4) on a one-rank NCCL mesh in this process, each eager and captured
    from one seed and budget and gated captured against eager, beside a
    single-device run; (b) MESH_RUNS on two gloo ranks sharing the card
    (eager: gloo's collectives cannot be captured), child processes, gated
    against single-device runs in this process."""
    card = _card()
    # the ranks of (b) start now: their imports and graph load overlap (a)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-rank", str(r),
         "--mesh-world", str(MESH_RANKS), "--mesh-port", str(port)],
        cwd=HERE, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(MESH_RANKS)]
    try:
        ranks, ref = _mesh_phases(g, device, card, procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    _mesh_report(ranks, ref, card)


def _mesh_phases(g, device, card, procs):
    """(a) and (b)'s single-device references in this process, then the
    ranks' go; returns the ranks' results and the references."""
    from smore_tpu_torch.models.line import LINE
    from smore_tpu_torch.parallel.mesh import (
        backend_of,
        init_distributed,
        make_mesh,
    )

    unbanded = dict(use_pallas=True)
    m_u = LINE(g, seed=0, device=device)
    m_u.init(dim=D, order=2)
    one_u = _mesh_run(m_u, MESH_ONE_MILLIONS, "sgns_shared_grads",
                      **unbanded)
    m_b = LINE(g, seed=0, device=device)
    m_b.init(dim=D, order=2)
    one_b = _mesh_run(m_b, MESH_ONE_MILLIONS, "sgns_banded_multiblock",
                      banded=True)
    init_distributed(f"127.0.0.1:{_free_port()}", 1, 0, backend="nccl")
    try:
        mesh = make_mesh()
        log(f"(a) one rank, backend {backend_of(mesh)}, "
            f"{MESH_ONE_MILLIONS}M samples a mode, eager then captured from "
            f"one seed [{card}]")
        for mode, m, kw, counter, one in (
            ("dp", m_u, unbanded, "sgns_shared_grads", one_u),
            ("rows", m_u, dict(unbanded, sharding="rows"),
             "sgns_shared_grads", one_u),
            ("hogwild", m_b, dict(banded=True), "sgns_banded_multiblock",
             one_b),
        ):
            _mesh_captured_vs_eager(m, mode, mesh, kw, counter, one)
    finally:
        torch.distributed.destroy_process_group()

    ref = {}
    for mode, millions, kw, counter in MESH_RUNS:
        if mode == "dp":  # gated at AUC_MIN_50K, not against a run
            continue
        m = LINE(g, seed=0, device=device)
        m.init(dim=D, order=2)
        kw = {k: v for k, v in kw.items() if k != "sharding"}
        ref[mode] = _mesh_run(m, millions, counter, warm=False, **kw)
        ref[mode]["vertex"] = m.state["vertex"].cpu().numpy()
        ref[mode]["auc"] = community_auc_50k(ref[mode]["vertex"], g.names)
    for p in procs:
        p.stdin.write("go\n")
        p.stdin.flush()
    outs = [p.communicate(timeout=400)[0] for p in procs]
    ranks = []
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            log(text[-4000:])
        require(p.returncode == 0, f"mesh rank {r} exited {p.returncode}")
        ranks.append(json.loads(text.rsplit("MESH_RANK ", 1)[1]
                                .splitlines()[0]))
    return ranks, ref


def _mesh_captured_vs_eager(m, mode: str, mesh, kw: dict, counter: str,
                            one: dict) -> None:
    """Phase 33 (a) for one mode: ``m`` trained on ``mesh`` eagerly
    (capture=False) and captured (the first call eager, every later call
    one replay of one CUDA graph holding the call's collectives), each
    after 1M of warm-up on fresh tables from one seed: the captured tables
    within RTOL / ATOL of the eager ones, equal generator states, the same
    collectives' calls and bytes and the same launches, at least 2
    replays; samples/s of both, the captured run's split and nodes."""
    from smore_tpu_torch.parallel.mesh import full_table

    runs = {}
    for capture in (False, True):
        m.capture = capture
        r = _mesh_run(m, MESH_ONE_MILLIONS, counter, mesh=mesh, **kw)
        d = m.last_driver
        require(d.sharding == mode, f"{mode}: TrainDriver ran {d.sharding}")
        r["gen"] = d.gen.get_state()
        r["tables"] = {k: full_table(t).clone() for k, t in m.state.items()}
        runs["captured" if capture else "eager"] = r
    m.capture = True
    e, c = runs["eager"], runs["captured"]
    log(f"  {mode} eager: {_mesh_line(e)}; {e['calls']} calls")
    log(f"  {mode} captured: {_mesh_line(c)}; {c['calls']} calls of "
        f"{c['per_call']:,} samples ({c['replays']} replays)")
    steady = c["replays"] * c["per_call"] / max(c["replay_s"], 1e-9)
    log(f"  {mode} captured: the eager first call "
        f"{1e3 * c['first_call_s']:.1f} ms, the capture "
        f"{1e3 * c['capture_s']:.1f} ms ({c['nodes']} graph nodes), "
        f"{c['replays']} replays {1e3 * c['replay_s']:.1f} ms = "
        f"{steady:,.0f} samples/s in the steady state, host ms a replay "
        f"{1e3 * c['replay_host_s'] / max(c['replays'], 1):.3f}")
    log(f"  {mode}: samples/s eager {e['rate']:,.0f}, captured "
        f"{c['rate']:,.0f} ({c['rate'] / e['rate']:.2f}x); one device, no "
        f"mesh: {one['rate']:,.0f}")
    require(e["replays"] == 0 and c["replays"] >= 2
            and c["replays"] == c["calls"] - 1,
            f"{mode}: {c['replays']} replays of {c['calls']} calls captured, "
            f"{e['replays']} eager")
    require(e["comm_s"] is not None and c["comm_s"] is None,
            f"{mode}: collective seconds eager {e['comm_s']}, captured "
            f"{c['comm_s']}")
    require((c["comm_calls"], c["comm_bytes"])
            == (e["comm_calls"], e["comm_bytes"]),
            f"{mode}: collectives captured {c['comm_calls']} calls "
            f"{c['comm_bytes']} B, eager {e['comm_calls']} {e['comm_bytes']}")
    require(c["launches"] == e["launches"],
            f"{mode}: {counter} launches captured {c['launches']}, eager "
            f"{e['launches']}")
    require(torch.equal(c["gen"], e["gen"]),
            f"{mode}: the generators' states differ")
    for k, v in e["tables"].items():
        got = c["tables"][k]
        err = float((got - v).abs().max())
        log(f"  {mode} {k} table, captured against eager: max |diff| "
            f"{err:.3e} (rtol {RTOL}, atol {ATOL})")
        require(bool(torch.allclose(got, v, rtol=RTOL, atol=ATOL)),
                f"{mode}: captured {k} table off the eager one by {err:.3e}")


def _mesh_report(ranks: list, ref: dict, card: str) -> None:
    """(b)'s gates and prints."""
    log(f"(b) {MESH_RANKS} ranks sharing the card, backend "
        f"{ranks[0]['backend']}: eager (gloo's collectives cannot be "
        f"captured) [{card}]")
    for mode, millions, kw, counter in MESH_RUNS:
        got = ranks[0][mode]
        require(got["sharding"] == mode,
                f"{mode}: TrainDriver ran {got['sharding']}")
        require(all(r[mode]["replays"] == 0 for r in ranks),
                f"{mode}: a gloo rank replayed a captured call")
        for r in ranks[1:]:
            log(f"  {mode} rank {r['rank']}: {_mesh_line(r[mode])}")
        auc = got["auc"]
        if mode == "dp":
            gate, ok = f">= {AUC_MIN_50K}", auc >= AUC_MIN_50K
            beside = ""
        else:
            tol = AUC_ROWS_TOL if mode == "rows" else AUC_HOG_TOL
            want = ref[mode]["auc"]
            gate, ok = f"within {tol} of one device's {want:.4f}", \
                abs(auc - want) <= tol
            beside = f" (one device: {ref[mode]['rate']:,.0f} samples/s)"
        log(f"  {mode} rank 0: {_mesh_line(got)}{beside}")
        log(f"  {mode}: {millions}M samples in all, community AUC "
            f"{auc:.4f} (gate {gate})")
        if mode == "rows":  # one logical stream: only atomics' order differs
            diff = np.abs(np.load(os.path.join(OUT, "mesh_rows_vertex.npy"))
                          - ref[mode]["vertex"])
            log(f"  rows: vertex table against one device's: max |diff| "
                f"{diff.max():.3e}, mean {diff.mean():.3e} (ungated)")
        require(ok, f"{mode} on {MESH_RANKS} ranks: community AUC {auc:.4f}, "
                f"gate {gate}")


# ------------------------------ the models with loops of their own (36)
# the HAN paper's DBLP shape (Wang et al., WWW 2019, Table 2) by
# make_hetero: 4,056 authors, 14,328 papers, 20 venues (it makes no terms)
HAN_DBLP = dict(topics=4, authors_pt=1014, papers_pt=3582, venues_pt=5)
# the SASRec paper's ML-1M setting (Kang and McAuley, ICDM 2018, IV), on
# seq_data.ML1M's Markov sequences
SEQ_ML1M_INIT = dict(max_seq_len=200, num_blocks=2, num_heads=1,
                     dropout=0.2)
SEQ_ML1M_DIM, SEQ_ML1M_NEG = 50, 5
# a captured SASRec-family run against the eager one: the same kernels on
# the same inputs; the card's sums may still run in another order
SEQ_RTOL, SEQ_ATOL = 1e-4, 1e-5


def own_loop_files() -> dict:
    """Phase 36's sets under OUT: FB15k-237's shape (make_kg), DBLP's
    (make_hetero), ML-1M's (seq_data.make_data)."""
    from smore_tpu_torch.utils import oracle_data as od
    from smore_tpu_torch.utils import seq_data as sd

    os.makedirs(OUT, exist_ok=True)
    f = {"kg": os.path.join(OUT, "fb15k_shape.txt"),
         "hetero": os.path.join(OUT, "dblp_shape.txt"),
         "seq": os.path.join(OUT, "ml1m_shape.txt")}
    od.make_kg(f["kg"], **FB15K_SHAPE)
    od.make_hetero(f["hetero"], **HAN_DBLP)
    if os.path.exists(f["seq"]):
        os.remove(f["seq"])  # make_data keeps an existing file
    sd.make_data(f["seq"], **sd.ML1M)
    return f


# phase 36's models: (family, the unit of a step, epochs timed)
OWN_LOOP_MODELS = {"transe": ("kg", "triples", 5),
                   "rotate": ("kg", "triples", 5),
                   "complex": ("kg", "triples", 5),
                   "han": ("han", "node updates", 2),
                   "sasrec": ("seq", "sequences", 3),
                   "gsasrec": ("seq", "sequences", 3),
                   "recdenoiser": ("seq", "sequences", 3)}


def own_loop_model(model: str, f: dict, device, steps_per_call=None):
    """A phase-36 model with fresh tables from seed 0: (model, the
    ``train()`` arguments, steps an epoch, a step's units). A call is
    ``steps_per_call`` steps (default the model's own; an epoch when it
    exceeds one)."""
    from smore_tpu_torch import models
    from smore_tpu_torch.models.base import clamp_batch
    from smore_tpu_torch.utils import oracle_data as od

    family, _, epochs = OWN_LOOP_MODELS[model]
    if family == "kg":
        cls = dict(transe=models.TransE, rotate=models.RotatE,
                   complex=models.ComplEx)[model]
        m = cls.load_triples(f["kg"], seed=0, device=device)
        m.init(dim=D)
        kw = dict(epochs=epochs, batch=1024, alpha=0.01)
        per_step = clamp_batch(min(m.kg.n_triples, m.kg.n_entities), 1024)
        per_epoch = m.kg.n_triples // per_step
    elif family == "han":
        m = models.HAN.load_edge_list(f["hetero"], seed=0, device=device)
        r = dict(od.RUNS["han"])
        for mp in r.pop("meta_paths"):
            m.add_meta_path(mp)
        m.init(dim=D, learning_rate=r["learning_rate"])
        kw = dict(epochs=epochs, batch=512, walk_times=r["walk_times"],
                  walk_steps=r["walk_steps"])
        per_epoch, per_step = m.hg.n_vertices // 512 + 1, 512
    else:
        from smore_tpu_torch.utils import seq_data as sd

        m = getattr(models, sd.SEQ_MODELS[model]).load_edge_list(
            f["seq"], seed=0, negative_samples=SEQ_ML1M_NEG, device=device)
        m.init(dim=SEQ_ML1M_DIM, **SEQ_ML1M_INIT)
        kw = dict(epochs=epochs, batch_size=128, alpha=1e-3)
        n_seq = len(m.build_sequences())
        per_epoch, per_step = n_seq // 128, 128
    if steps_per_call is not None:
        m.steps_per_call = steps_per_call
    return m, dict(kw, verbose=False), per_epoch, per_step


def own_loop_state(m) -> dict:
    return dict(m.net.state_dict()) if hasattr(m, "net") else dict(m.state)


def own_loop_run(model: str, f: dict, device, capture: bool,
                 steps_per_call=None) -> dict:
    """One phase-36 run: KG one warm-up epoch first (a train() of its
    own), then the timed train() with every kernel count 0. Returns the
    model, its seconds, steps, rates and the split of a captured run."""
    m, kw, per_epoch, per_step = own_loop_model(model, f, device,
                                                steps_per_call)
    m.capture = capture
    if OWN_LOOP_MODELS[model][0] == "kg":
        m.train(**dict(kw, epochs=1))
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    m.train(**kw)
    dt = time.perf_counter() - t0  # train() synchronises at its end
    _no_launch(model, counters)
    _finite(model, own_loop_state(m))
    c = m.last_calls
    steps = kw["epochs"] * per_epoch
    first = min(per_epoch, m.steps_per_call or per_epoch)
    out = dict(m=m, dt=dt, steps=steps, per_step=per_step, calls=c,
               rate=steps / dt, units=steps * per_step / dt)
    if c.replays:
        out["nodes"] = {str(k): n for k, n in c.nodes.items()}
        out["replay_rate"] = (steps - first) / c.replay_s
        out["host_ms"] = 1e3 * c.replay_host_s / c.replays
    return out


def phase_own_loops(f: dict, device, steps_per_call=None,
                    models=tuple(OWN_LOOP_MODELS)) -> None:
    """Phase 36: TransE, RotatE and ComplEx at FB15k-237's shape (one
    warm-up epoch, then 5 timed), HAN at DBLP's (2 epochs) and SASRec,
    gSASRec and Rec-Denoiser at ML-1M's (3 epochs), each from seed 0
    eagerly (capture=False) and then on captured calls: steps/s and units
    a second of both, the captured run's split (the eager first call, the
    capture, the replays and their own rate, the host's ms a replay), the
    graphs' node counts; equal generator states, the captured tables or
    parameters within tolerance of the eager ones, no kernel launched.
    ``steps_per_call``: {family: steps of a call} (default each model's
    own)."""
    card = _card()
    for model in models:
        family, unit, epochs = OWN_LOOP_MODELS[model]
        k = (steps_per_call or {}).get(family)
        e = own_loop_run(model, f, device, False, k)
        r = own_loop_run(model, f, device, True, k)
        c = r["calls"]
        require(e["calls"].replays == 0 and c.replays == c.calls - 1,
                f"{model}: {c.replays} replays of {c.calls} calls")
        require(torch.equal(e["calls"].gen.get_state(), c.gen.get_state()),
                f"{model}: the generators' states differ")
        rtol, atol = (SEQ_RTOL, SEQ_ATOL) if family == "seq" else (RTOL,
                                                                   ATOL)
        want, got = own_loop_state(e["m"]), own_loop_state(r["m"])
        errs = {}
        for name, v in want.items():
            errs[name] = float((got[name] - v).abs().max())
            require(bool(torch.allclose(got[name], v, rtol=rtol, atol=atol)),
                    f"{model}: captured {name} off the eager one by "
                    f"{errs[name]:.3e} (rtol {rtol}, atol {atol})")
        worst = max(errs, key=errs.get)
        spc = r["m"].steps_per_call
        call = ("an epoch" if spc is None or spc >= r["steps"] // epochs
                else f"{spc} steps")
        log(f"{model} ({epochs} epochs of {r['steps'] // epochs} steps of "
            f"{r['per_step']} {unit}; a call {call}): eager "
            f"{e['rate']:.1f} steps/s = {e['units']:,.0f} {unit}/s; "
            f"captured {r['rate']:.1f} steps/s = {r['units']:,.0f} {unit}/s "
            f"({r['rate'] / e['rate']:.2f}x)")
        log(f"  captured split: the eager first call "
            f"{1e3 * c.first_call_s:.1f} ms, {len(c.nodes)} capture(s) "
            f"{1e3 * c.capture_s:.1f} ms, {c.replays} replays "
            f"{1e3 * c.replay_s:.1f} ms = {r['replay_rate']:.1f} steps/s; "
            f"host {r['host_ms']:.3f} ms a replay; graph nodes "
            f"{r['nodes']}; generator states equal; max |captured - eager| "
            f"{errs[worst]:.3e} ({worst}; rtol {rtol}, atol {atol}); no "
            f"kernel launched [{card}]")


def phase_profile(m, out_dir: str, name: str, warm=None, run=None,
                  steps=None, **kw) -> None:
    """Kernel time by name, the card's busy share and the host's ops and
    launches a driver step over 4M samples after 1M (``run`` and ``warm``:
    other train() arguments, for a walk model). A model trained by its own
    loop (KG, HAN) gives ``steps``: (steps of the profiled run, samples a
    step, what a sample is)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    m.train(**(warm or dict(sample_times=1, **TRAIN_KW, **kw)))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m.train(**(run or dict(sample_times=4, **TRAIN_KW, **kw)))
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
    if steps is None:
        d = m.last_driver
        steps = (d.executed_samples / d.samples_per_step, d.samples_per_step,
                 "samples")
    n, per_step, unit = steps
    ops, nested, work = _host_ops(prof.events())
    log(f"profile {name}: {round(n * per_step):,} {unit}, wall {wall:.3f} "
        f"s, device busy {busy:.3f} s ({100 * busy / wall:.1f}%), idle "
        f"{100 * (1 - busy / wall):.1f}%; a step of "
        f"{per_step:,} {unit}: {ops / n:.1f} torch ops "
        f"({nested / n:.1f} aten calls with the nested ones), "
        f"{work / n:.1f} CUDA launch, memset and copy calls [{_card()}]")
    log(table)


def _host_ops(events) -> tuple:
    """What the host issued in a profile: the aten ops that Python code
    called (an aten op not inside another), every aten call, and the
    runtime calls that put work on the card."""
    aten = [e for e in events if e.name.startswith("aten::")]
    ops = sum(1 for e in aten if e.cpu_parent is None
              or not e.cpu_parent.name.startswith("aten::"))
    work = sum(1 for e in events if e.name.startswith(_RUNTIME_WORK))
    return ops, len(aten), work


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile the main paths; write results to DIR")
    # one rank of phase 33 (b), started by phase_mesh
    ap.add_argument("--mesh-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-port", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.mesh_rank is not None:
        mesh_rank_main(args.mesh_rank, args.mesh_world, args.mesh_port)
        return
    try:
        run_phases(args)
    finally:
        close_spare_cli()


def run_phases(args) -> None:
    t_start = time.perf_counter()

    def timed(name, phase, *a):
        t0 = time.perf_counter()
        out = phase(*a)
        log(f"[{name}: {time.perf_counter() - t0:.1f} s]")
        return out

    device = phase_device()
    timed("build", phase_build)
    k4 = timed("K4 vs twin", phase_k4_vs_twin, device)
    k5 = timed("K5 vs twin", phase_k5_vs_twin, device)
    k1 = timed("K1 vs twin", phase_k1_vs_twin, device)
    k3 = timed("K3 vs twin", phase_k3_vs_twin, device)
    k2 = timed("K2 vs twin", phase_k2_vs_twin, device)
    kw_ = timed("random_walk vs twin", phase_random_walk_vs_twin, device)
    kn = timed("node2vec_walk vs twin", phase_node2vec_walk_vs_twin, device)
    g_yt, m_yt, k4_launches = timed("Youtube multiblock and unbanded",
                                    phase_youtube, device)
    routes = timed("Youtube routes", phase_youtube_routes, g_yt, device)
    m_fused, k3_launches = routes["fused"]
    m_o1, k2_launches = routes["order 1"]
    m_nb, k5_launches = routes["neg_band"]
    unbanded = timed("50k graph", phase_unbanded, device)
    m_50k, k1_launches = unbanded["group 8 (main path)"]
    t0 = time.perf_counter()
    walk_graph = timed("walks through the CLI", phase_walks_cli)
    m_dw, kw_launches = timed("kill and resume", phase_walk_kill_resume,
                              walk_graph, device)
    timed("line through the CLI", phase_line_cli, g_yt)
    log(f"CLI, walk and checkpoint phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    files = rec_files()
    rec = timed("rec family", phase_rec, files, device)
    timed("rec family through the CLI", phase_rec_cli, files)
    log(f"rec phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sp = structured_files()
    comm = timed("community family", phase_community, sp, files, device)
    timed("msfine through the CLI", phase_community_cli, files)
    log(f"community phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tf = typed_files()
    typed = timed("KG and typed-graph family", phase_typed, tf, device)
    m_fb = timed("TransE and FastRP at scale", phase_typed_scale, g_yt,
                 device)
    timed("rotate and cpr through the CLI", phase_typed_cli, tf)
    log(f"KG and typed-graph phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sf = seq_files()
    kj = timed("jodie_epoch vs twin", phase_jodie_vs_twin, sf["events"],
               device)
    kj_launches = timed("JODIE", phase_jodie, sf["events"], device)
    timed("JODIE at full width", phase_jodie_full, sf["events"], device)
    seq = timed("SASRec family", phase_seq, sf["seq"], device)
    timed("jodie and sasrec through the CLI", phase_seq_cli, sf)
    log(f"JODIE and SASRec-family phases: {time.perf_counter() - t0:.1f} s")
    timed("multi-device modes", phase_mesh, m_50k.graph, device)
    timed("captured against eager", phase_captured_vs_eager, g_yt,
          m_50k.graph, device)
    timed("own loops captured against eager", phase_own_loops,
          own_loop_files(), device)
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
        for name, m, kw in (("line_yt_eager", m_yt, {}),
                            ("line_50k_unbanded_eager", m_50k,
                             dict(use_pallas=True))):
            m.capture = False
            phase_profile(m, args.profile, name, **kw)
            m.capture = True
        # the default budget in both runs: a truncated warm-up would leave
        # the model on four inner passes (WalkSGNSBase._run)
        walk_kw = dict(walk_times=10, walk_steps=40, window_size=5,
                       negative_samples=5, alpha=0.025, verbose=False)
        phase_profile(m_dw, args.profile, "deepwalk_20k", warm=walk_kw,
                      run=walk_kw)
        for name, kw in (("bpr", {}), ("nemf", dict(walk_steps=2))):
            phase_profile(rec[name], args.profile, f"{name}_rec",
                          warm=dict(sample_times=REC_WARM, verbose=False,
                                    **kw),
                          run=dict(sample_times=2, verbose=False, **kw))
        for name, _, _, kw, _, _ in COMM_RUNS:
            phase_profile(comm[name], args.profile, f"{name}_community",
                          warm=dict(sample_times=REC_WARM, verbose=False,
                                    **kw),
                          run=dict(sample_times=2, verbose=False, **kw))
        kg = m_fb.kg
        epoch = (kg.n_triples // 1024, 1024, "triples")
        han = typed["han"]
        han_kw = dict(walk_times=5, walk_steps=4, verbose=False)
        for capture, tag in ((True, ""), (False, "_eager")):
            # the own loops in both modes (phase 36)
            m_fb.capture = han.capture = capture
            phase_profile(m_fb, args.profile, "transe_fb15k_shape" + tag,
                          warm=dict(epochs=1, batch=1024, alpha=0.01,
                                    verbose=False),
                          run=dict(epochs=2, batch=1024, alpha=0.01,
                                   verbose=False),
                          steps=(2 * epoch[0],) + epoch[1:])
            phase_profile(han, args.profile, "han_hetero" + tag,
                          warm=dict(epochs=1, **han_kw),
                          run=dict(epochs=2, **han_kw),
                          steps=(2 * (han.hg.n_vertices // 512 + 1), 512,
                                 "node updates"))
        from smore_tpu_torch.models import JODIE
        from smore_tpu_torch.utils import seq_data as sd

        jodie = JODIE.load_interactions(sf["events"], seed=0, device=device)
        jodie.init(D)
        jodie_kw = dict(learning_rate=0.05, bce_lr=0.2, verbose=False)
        phase_profile(jodie, args.profile, "jodie_events",
                      warm=dict(epochs=1, **jodie_kw),
                      run=dict(epochs=2, **jodie_kw),
                      steps=(2, jodie.ig.n_interactions, "events"))
        m_seq = seq["sasrec"]
        n_seq = len(m_seq._holdout_seqs)
        seq_kw = dict(sd.SEQ_TRAIN, verbose=False)
        for capture, tag in ((True, ""), (False, "_eager")):
            m_seq.capture = capture
            phase_profile(m_seq, args.profile, "sasrec_markov" + tag,
                          warm=dict(seq_kw, epochs=1),
                          run=dict(seq_kw, epochs=2),
                          steps=(2 * (n_seq // 128), 128, "sequences"))
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
        {
            "name": "jodie_epoch",
            "route": "cuda",
            "source": "smore_tpu_torch/csrc/jodie_epoch.cu",
            "replaces": "smore_tpu/models/jodie.py:141",
            "launches": kj_launches,
            **kj,
        },
        {
            "name": "random_walk",
            "route": "cuda",
            "source": "smore_tpu_torch/csrc/random_walk.cu",
            "replaces": "smore_tpu/sampling/walks.py:39",
            "launches": kw_launches,
            **kw_,
        },
        {
            "name": "node2vec_walk",
            "route": "cuda",
            "source": "smore_tpu_torch/csrc/node2vec_walk.cu",
            "replaces": "smore_tpu/sampling/walks.py:151",
            "launches": WALK_CLI_LAUNCHES["node2vec"]["node2vec_walk"],
            **kn,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
