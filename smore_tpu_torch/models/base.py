"""Shared model scaffolding: embedding tables and the training driver.

Port of ``smore_tpu/models/base.py`` (``hoisted_scan_step``,
``freshness_policy``, ``trunc_mass_multiplier``, ``clamp_batch``,
``init_embedding``, ``zeros_embedding``, ``TrainDriver`` with its compiled
call, its "dp", "hogwild" and "rows" modes on a mesh and checkpoint and
resume, ``PairModelBase``). The JAX driver ran ``steps_per_call`` steps as
one jitted ``lax.scan`` with the tables donated; here one call of those
steps is a Python function of static buffers (the tables, the call's
alphas, its loss) that, on the card, is captured once as a CUDA graph and
replayed for every later call (``TrainDriver``); on a mesh the graph holds
the call's collectives too, where the group's backend (NCCL) can capture
them. The update
is hand-derived SGD, so no autograd is involved. The models that run
their own epoch loops (the JAX package jitted their step) capture their
calls the same way (``CapturedCalls``, ``OwnLoop``).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from smore_tpu_torch.graph.graph import Graph
from smore_tpu_torch.io.embeddings import save_embeddings, warm_start
from smore_tpu_torch.ops import launches
from smore_tpu_torch.parallel.mesh import (
    CommStats,
    RowShard,
    backend_of,
    full_table,
    gather_rows,
    is_dtensor,
    row_mesh,
    row_range,
    rows_to_dtensor,
)
from smore_tpu_torch.sampling.tables import SamplerTables
from smore_tpu_torch.utils import profiling
from smore_tpu_torch.utils.checkpoint import (
    checkpoint_exists,
    load_checkpoint,
    save_checkpoint,
)

State = Dict[str, torch.Tensor]
# step_fn(state, ctx, gen, alpha) -> (state, loss); ``ctx`` holds the
# read-only sampler tensors, ``gen`` is the torch.Generator the step draws
# from, alpha is a () tensor, or (micro_steps,) when micro_steps > 1.
StepFn = Callable[[State, object, torch.Generator, torch.Tensor],
                  Tuple[State, torch.Tensor]]

ALPHA_MIN_FRAC = 1e-4  # reference: alpha_min = alpha * 0.0001
INIT_STREAM, TRAIN_STREAM = 0, 1  # generator streams of a model seed
# freshness_policy: the sequential-update floor and the smallest batch
FRESH_MIN_UPDATES = 1536
FRESH_MIN_BATCH = 8
# trunc_mass_multiplier: the largest re-batched step that takes x3
TRUNC_TINY_BATCH = 64


def hoisted_scan_step(draw_fn, update_fn, hoist: int,
                      update_segment: Optional[str] = None) -> StepFn:
    """The StepFn of every mega-draw path: ``draw_fn(ctx, gen)`` returns a
    tuple of tensors with a leading (hoist,) axis (the draws of ``hoist``
    inner batches in one shot; they do not depend on the state, so hoisting
    them keeps the sampling law), and ``update_fn(state, x, alpha) ->
    (state, loss)`` applies one inner batch. The step takes the (hoist,)
    alpha vector of TrainDriver(micro_steps=hoist) and returns the mean
    loss of its inner batches. ``update_segment`` names the tracer's
    segment around the whole inner loop."""

    def step(state, ctx, gen, alphas):
        xs = draw_fn(ctx, gen)
        losses = []
        with profiling.segment(update_segment):
            for i in range(hoist):
                state, loss = update_fn(state, tuple(x[i] for x in xs),
                                        alphas[i])
                losses.append(loss)
        return state, torch.stack(losses).mean()

    return step


def draw_update_step(draw_fn, update_fn) -> StepFn:
    """The StepFn of a model whose step is ``draw_fn(ctx, gen)`` (the
    draws, independent of the state) then ``update_fn(state, x, alpha) ->
    (state, loss)``."""

    def step(state, ctx, gen, alpha):
        return update_fn(state, draw_fn(ctx, gen), alpha)

    return step


def tiny_graph_pool(n_rows: int, shared_negatives: int) -> int:
    """The shared negative pool's size on a graph of ``n_rows`` vertices:
    none under four pools' worth, where a pool drawn with replacement from
    a set not much larger than itself puts the batch's negative mass on a
    few rows each step (sum-collision overshoot, NaN on toy nets); per-sample
    negatives there."""
    return 0 if n_rows < 4 * shared_negatives else shared_negatives


def freshness_policy(total_units: int, batch: int, hoist: int) -> tuple:
    """Truncated-budget freshness floor. A batched step applies ``batch``
    samples against one table snapshot, where the reference applies them
    one at a time; when the run would see fewer than FRESH_MIN_UPDATES
    sequential updates, shrink the batch and raise the micro-step factor
    by as much, so that the draws per call stay about the same. 1536 sits
    just below the walk family's default budget on the 20k-vertex parity
    graph (1562 steps of 128 walks), which is left untouched. Returns the
    adjusted (batch, hoist)."""
    if batch <= FRESH_MIN_BATCH or total_units >= FRESH_MIN_UPDATES * batch:
        return batch, hoist
    new_batch = int(max(FRESH_MIN_BATCH, total_units // FRESH_MIN_UPDATES))
    grow = max(1, batch // new_batch)
    return new_batch, min(max(1, hoist) * grow, 64)


def trunc_mass_multiplier(rebatched: int) -> float:
    """Step-mass multiplier of the inner-pass bootstrap at truncated
    budgets (``WalkSGNSBase._run``): x3 where the re-batched step is tiny
    (the JAX package's calibration at 8-26 rows), x2 above, where x3
    collapsed APP's tables in its measurements."""
    return 3.0 if rebatched <= TRUNC_TINY_BATCH else 2.0


def clamp_batch(n_rows: int, batch: int, group: int = 1) -> int:
    """Cap the batch at the table's row count (a batched step applies each
    row's summed in-batch gradient against one stale snapshot, so a batch
    far above the row count overshoots), keeping it a multiple of the
    source draw group."""
    b = max(min(batch, n_rows), group)
    return max(b - b % group, group)


def init_embedding(gen: torch.Generator, rows: int, dim: int,
                   device: torch.device | str = "cuda",
                   scale: Optional[float] = None) -> torch.Tensor:
    """Reference init: uniform(-0.5, 0.5) / dim, or times ``scale`` when
    given (ECO: 1.0)."""
    u = torch.rand(rows, dim, generator=gen, dtype=torch.float32,
                   device=device)
    if scale is None:
        return (u - 0.5) / dim
    return (u - 0.5) * scale


def zeros_embedding(rows: int, dim: int,
                    device: torch.device | str = "cuda") -> torch.Tensor:
    return torch.zeros(rows, dim, dtype=torch.float32, device=device)


def seeded_generator(seed: int, stream: int,
                     device: torch.device | str = "cuda",
                     rank: Optional[int] = None) -> torch.Generator:
    """A generator on ``device``, seeded from (model seed, stream): the
    counterpart of the JAX package's keys split from ``PRNGKey(seed)``, so
    init and training draw independent streams and every ``train()`` call
    replays the same draws. ``rank`` gives each rank of a "dp" or "hogwild"
    mesh a stream of its own (JAX: the key split over the devices)."""
    entropy = [seed, stream] + ([] if rank is None else [rank])
    s = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(s))
    return gen


def alpha_schedule(step0: int, steps: int, micro_steps: int, alpha: float,
                   inv_total: float) -> np.ndarray:
    """The learning rates of ``steps`` consecutive steps from ``step0``:
    linear decay in the global step counter, clipped at ``alpha * 1e-4``,
    per micro-step when micro_steps > 1. Returns (steps,) or (steps,
    micro_steps) float32, equal bit for bit to the JAX driver's float32
    schedule. With one micro-step that driver's compiled program evaluates
    ``1 - x * inv_total`` as a fused multiply-add, rounding once; the
    float64 product here is exact, so it rounds the same way."""
    f32 = np.float32
    a0, a_min, inv = f32(alpha), f32(alpha * ALPHA_MIN_FRAC), f32(inv_total)
    x = f32(step0) + np.arange(steps, dtype=f32)
    if micro_steps > 1:
        progress = (x * inv)[:, None] + (
            np.arange(micro_steps, dtype=f32) / f32(micro_steps)) * inv
        rest = f32(1.0) - progress
    else:
        rest = (1.0 - x.astype(np.float64) * np.float64(inv)).astype(f32)
    return np.maximum(a0 * rest, a_min)


class CallGraph:
    """One call captured as a ``torch.cuda.CUDAGraph``, with the training
    generator registered with it: each replay draws the numbers the eager
    call would have drawn next and advances the generator past them. The
    captured graph is kept (``keep_graph``) so that its nodes can be
    counted (``kernel_launches``, and the count ``capture`` returns).
    ``error_mode`` is ``torch.cuda.graph``'s ``capture_error_mode``."""

    def __init__(self, gen: torch.Generator, error_mode: str = "global"):
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        self.graph.register_generator_state(gen)
        self.error_mode = error_mode

    def capture(self, run: Callable[[], None]) -> int:
        """Record ``run``'s work on the card and instantiate it; nothing
        runs. Returns the graph's nodes: kernels, memsets and copies. The
        tracer's spans: ``capture.prepare`` (``torch.cuda.graph``'s entry:
        it waits for the card, empties the allocator's and the pinned host
        memory's caches, and begins the capture), ``capture.record`` (the
        call's Python and the capture's end), ``capture.instantiate``,
        ``capture.count``."""
        ctx = torch.cuda.graph(self.graph,
                               capture_error_mode=self.error_mode)
        with profiling.span("capture.prepare"):
            ctx.__enter__()
        with profiling.span("capture.record"):
            try:
                run()
            finally:
                ctx.__exit__(None, None, None)
        with profiling.span("capture.instantiate"):
            self.graph.instantiate()
        with profiling.span("capture.count"):
            return launches.node_count(self.graph.raw_cuda_graph())

    def kernel_launches(self) -> Dict[str, int]:
        """The launches of each kernel the graph holds, by kernel name, read
        from its nodes."""
        return launches.in_graph(self.graph.raw_cuda_graph())

    def replay(self) -> None:
        self.graph.replay()


class _AlphaStaging:
    """The pinned host buffers a call's alphas go through to the static
    buffer: two, used in turn, so that the host writes the next call's
    while the card may still be copying the last one's."""

    def __init__(self, shape: tuple, device: torch.device):
        self.cuda = device.type == "cuda"
        self.host = torch.empty((2,) + shape, dtype=torch.float32,
                                pin_memory=self.cuda)
        self.copied = [None, None]
        self.i = 0

    def put(self, values: np.ndarray, dst: torch.Tensor) -> None:
        i, self.i = self.i, 1 - self.i
        if self.copied[i] is not None:
            profiling.wait(self.copied[i], "driver.alphas.wait")
        self.host[i].copy_(torch.from_numpy(values))
        dst.copy_(self.host[i], non_blocking=self.cuda)
        if self.cuda:
            self.copied[i] = torch.cuda.Event()
            self.copied[i].record()


def _warm_up(run: Callable[[], None], device: torch.device) -> None:
    """Run ``run`` on a side stream that starts after the current one
    (torch.cuda.graph's warm-up before a capture) and wait for it, as the
    capture that follows would."""
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        run()
    cur.wait_stream(side)
    torch.cuda.synchronize(device)


class CapturedCalls:
    """The calls of one ``train()``, each a function of static buffers: the
    counterpart of the JAX package's compiled programs, one dispatch a
    call. With ``captured`` False every call runs eagerly (the CPU,
    ``capture=False``, a mesh whose backend cannot capture collectives:
    gloo). On the card the first call runs eagerly on a side stream
    (``_warm_up``: it trains, and builds what is built at first use:
    kernels, the autograd engine's state, an optimiser's moments, NCCL's
    communicator); a later call of a ``kind`` not captured yet is captured
    into a ``CallGraph`` of its own (the training generator registered
    with it, so a replay draws what the eager call would) and replayed, and
    so is every later call of that kind: one replay a call. ``kind`` names what a
    call's graph holds (a call of another length, or one that also starts
    or ends an epoch, is another kind). The graph replays no Python, so
    each kernel's launch counter is credited, on every replay, the
    launches its graph's nodes hold, which must equal what the kernels
    launched while it was captured (``ops.launches``).

    ``comm``, given when the calls issue collectives (a mesh), is credited
    the same way the collectives' calls and bytes that a capture tallied
    (``parallel.mesh.CommStats``). Such a call is captured with
    ``capture_error_mode="thread_local"``: NCCL's watchdog thread queries
    the events of earlier collectives (the eager first call's) at any
    time, and under the default "global" mode such a query from another
    thread invalidates the capture. A capture that fails raises with
    CUDA's or NCCL's message; nothing falls back.

    ``calls`` and ``replays`` count; ``nodes`` holds the node count of
    each kind's graph. ``graphs`` holds the graphs themselves until
    ``close()`` drops them: an owner may sit in a reference cycle, and a
    graph that the cyclic collector frees during another capture
    invalidates that capture. The seconds split into ``first_call_s``
    (the eager first call, to its end on the card), ``capture_s``
    (recording, instantiating and counting every graph), ``replay_s``
    (the rest from the first capture on, to the end on the card: the
    replays and what the host does between them) and, within that,
    ``replay_host_s`` (the host's time issuing the replays); with the
    tracer on (``utils.profiling``) the same clock readings are its spans
    ``calls.first``, ``calls.capture`` and ``driver.replay``, each call's
    first and last node are stamped on the card, and ``close()`` ends the
    tracer's group of this ``train()``."""

    def __init__(self, gen: Optional[torch.Generator],
                 device: torch.device, captured: bool,
                 comm: Optional[CommStats] = None):
        self.gen, self.device, self.captured = gen, device, captured
        self.comm = comm
        self.graphs: Dict[object, CallGraph] = {}
        self.nodes: Dict[object, int] = {}
        self._credit: Dict[object, launches.Credit] = {}
        self._comm_credit: Dict[object, Tuple[int, int]] = {}
        self.calls = self.replays = 0
        self.first_call_s = self.capture_s = self.replay_s = 0.0
        self.replay_host_s = 0.0
        self._t_capture = None  # when the first capture began (ns)

    def __call__(self, run: Callable[[], None], kind=None) -> None:
        """One call of ``run`` (see the class docstring)."""
        if self.calls == 0:
            profiling.begin(self.device)
        run = profiling.stamped(run, self.device)
        if not self.captured:
            run()
        elif self.calls == 0:
            with profiling.timed("calls.first") as t:
                _warm_up(run, self.device)
            self.first_call_s = t.seconds
        else:
            graph = self.graphs.get(kind)
            if graph is None:
                with profiling.timed("calls.capture") as t:
                    graph = CallGraph(self.gen, "global" if self.comm is None
                                      else "thread_local")
                    before = launches.read()
                    if self.comm is not None:
                        comm_before = self.comm.read()
                    self.nodes[kind] = graph.capture(run)
                    with profiling.span("capture.count"):
                        self._credit[kind] = launches.recorded(
                            before, graph.kernel_launches())
                        if self.comm is not None:
                            self._comm_credit[kind] = self.comm.recorded(
                                comm_before)
                    self.graphs[kind] = graph
                if self._t_capture is None:
                    self._t_capture = t.t0
                self.capture_s += t.seconds
            with profiling.timed("driver.replay") as t:
                graph.replay()
                launches.credit(self._credit[kind])
                if self.comm is not None:
                    self.comm.credit(self._comm_credit[kind])
            self.replay_host_s += t.seconds
            self.replays += 1
        self.calls += 1

    def close(self) -> None:
        """Wait for the card (the graphs, their memory pools and the
        buffers may go with the caller's frame, also when a call or a
        checkpoint raised), drop the graphs and close the split of the
        seconds."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.graphs.clear()
        if self._t_capture is not None:
            self.replay_s = ((time.perf_counter_ns() - self._t_capture) * 1e-9
                             - self.capture_s)
        profiling.end(captured=self.captured, calls=self.calls,
                      replays=self.replays, nodes=dict(self.nodes))


def epoch_calls(steps: int, steps_per_call: Optional[int]) -> list:
    """The lengths of the calls of an epoch of ``steps`` steps:
    ``steps_per_call`` whole steps each (None: the epoch in one call), the
    last one the rest."""
    k = min(steps, steps_per_call or steps)
    return [k] * (steps // k) + ([steps % k] if steps % k else [])


class OwnLoop:
    """What the models that run their own epoch loops share (the KG
    family, HAN, the SASRec family): their calls are ``CapturedCalls``
    (the last ``train()``'s are ``last_calls``), captured on the card
    unless ``capture`` is False, eager on the CPU."""

    # False runs every call eagerly on the card too (to compare the two in
    # one process)
    capture = True
    last_calls: Optional[CapturedCalls] = None

    def _captures(self) -> bool:
        return self.capture and self.device.type == "cuda"

    def _new_calls(self, gen: torch.Generator) -> CapturedCalls:
        self.last_calls = CapturedCalls(gen, self.device, self._captures())
        return self.last_calls


class TrainDriver:
    """Runs a StepFn for a total number of samples with linear alpha decay.

    samples_per_step counts every sample a step consumes (batch *
    micro_steps on the multiblock path); it sets the alpha schedule and the
    throughput report. ``device`` (default the CUDA card) holds the alpha
    schedule and the loss.

    mesh: a 1-D ``DeviceMesh`` over the process group
    (``parallel.mesh.make_mesh``; every rank runs this driver with its own
    generator), with ``sharding``:

    - "dp": every step, each rank runs the step on its replicated tables
      from its own sample stream, and the ranks' deltas (new - old) are
      summed by ``all_reduce`` and added to the step's starting tables, so
      a step applies the combined batch with collision "sum". The alpha
      schedule counts samples_per_step * world samples a step.
    - "hogwild": the same merge once per call of ``steps_per_call`` steps,
      each rank's copy running its own stream in between (the reference's
      hogwild threads, merged at call cadence).
    - "rows": one logical sample stream (every rank passes the same
      generator), each rank storing only its ``Shard(0)`` rows of every
      table; the step sees ``parallel.mesh.RowShard`` tables, and the result
      is the single-device run's. The tables come back as ``Shard(0)``
      DTensors; tables that arrive as such train this way without ``mesh``.

    The collectives' count, bytes and seconds are ``comm``
    (``parallel.mesh.CommStats``: the seconds of eager collectives; None,
    not timed, once a call's collectives were captured).

    A call of ``steps_per_call`` steps is ``_call``: S steps on static
    buffers (the tables of ``state``, the call's (S,) or (S, M) ``alphas``,
    a () ``loss``, the mean of the steps' losses as JAX's
    ``jnp.mean(losses)``), with the mode's merges on a mesh ("dp" the
    snapshot, the delta, its ``all_reduce`` and the add every step,
    "hogwild" once a call, "rows" the ``RowShard`` gathers' ``all_reduce``
    in the steps; the loss's mean over the "dp" or "hogwild" ranks, as
    JAX's ``pmean``, when ``train`` prints). Each call's alphas are copied
    in from pinned host memory. The calls are ``CapturedCalls``
    (``loop``): on the card (``capture`` True), without a mesh or on a
    mesh whose backend is NCCL, the first call of a ``train()`` runs
    eagerly on a side stream (building NCCL's communicator, which a capture
    cannot), the second is captured into one CUDA graph (with its
    collectives) and replayed, and so is every later call: one replay a
    call. The tables are the graph's own buffers (the JAX call donated
    them): the steps update most in place, and a table a step returns anew
    is copied back once a call (``copy_back_bytes``; a ``RowShard``'s
    ``.local``); the merges' snapshot is built in the eager first call and
    reused by every replay. ``capture=False`` runs every call eagerly (for
    a comparison on the card), as the CPU does and a gloo mesh does (gloo's
    collectives cannot be captured). ``calls`` counts the last
    ``train()``'s calls; ``replays`` and the split of its seconds
    (``first_call_s``, ``capture_s``, ``replay_s``, ``replay_host_s``) are
    its ``loop``'s. Checkpoints gather eagerly between calls.

    checkpoint_path: the training state (tables, the generator's state and
    the step counter) is saved there every ``checkpoint_every`` calls of
    ``steps_per_call`` steps and after the last one; with ``resume`` and a
    checkpoint already there, training continues from it. The learning
    rate is a function of the step counter and the draws of the generator's
    state, so a killed and resumed run takes the steps of an uninterrupted
    one. On a mesh rank 0 writes the whole tables and every rank's
    generator state, and a resume takes its rows or its copy and its own
    generator state; a checkpoint of another world size raises.
    """

    def __init__(
        self,
        step_fn: StepFn,
        ctx,
        samples_per_step: int,
        alpha: float,
        total_samples: int,
        steps_per_call: int = 256,
        mesh=None,
        sharding: str = "dp",
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 1,
        resume: bool = True,
        micro_steps: int = 1,
        device: torch.device | str = "cuda",
        capture: bool = True,
    ):
        if sharding not in ("dp", "rows", "hogwild"):
            raise ValueError(
                f"sharding must be 'dp', 'rows' or 'hogwild', got {sharding!r}"
            )
        if micro_steps > 1 and mesh is not None and sharding == "dp":
            # dp merges the ranks' deltas every step; callers set hoist 1
            raise ValueError("micro_steps > 1 is incompatible with DP "
                             "sharding (use sharding='rows' or no mesh)")
        if mesh is not None and not (isinstance(mesh, DeviceMesh)
                                     and mesh.ndim == 1):
            raise TypeError(f"mesh must be a 1-D DeviceMesh, got {mesh!r}")
        self.step_fn = step_fn
        self.ctx = ctx
        self.mesh = mesh
        self.sharding = sharding
        self.n_shards = (1 if mesh is None or sharding == "rows"
                         else mesh.size())
        self.samples_per_step = int(samples_per_step) * self.n_shards
        self.alpha = float(alpha)
        self.total_samples = int(total_samples)
        self.steps_per_call = int(steps_per_call)
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = max(1, int(checkpoint_every))
        self.resume = resume
        self.micro_steps = max(1, int(micro_steps))
        self.device = torch.device(device)
        self.capture = capture
        self.executed_samples = 0
        self.comm = CommStats()
        self.calls = 0
        self.loop = CapturedCalls(None, self.device, False)
        self.copy_back_bytes = 0
        self._old: Optional[State] = None  # the merges' snapshot

    # the last train()'s replays and the split of its seconds
    replays = property(lambda self: self.loop.replays)
    first_call_s = property(lambda self: self.loop.first_call_s)
    capture_s = property(lambda self: self.loop.capture_s)
    replay_s = property(lambda self: self.loop.replay_s)
    replay_host_s = property(lambda self: self.loop.replay_host_s)

    def _placement(self, state: State):
        """(mesh, mode, group, rank, world) of a train() call: this
        TrainDriver's mesh and sharding, or "rows" on the mesh of
        row-sharded tables."""
        mesh, mode = self.mesh, self.sharding
        if mesh is None:
            mesh, mode = row_mesh(state), "rows"
        elif mode != "rows" and row_mesh(state) is not None:
            raise ValueError(f"row-sharded tables train under sharding="
                             f"'rows', not {mode!r}")
        if mesh is None:
            return None, None, None, 0, 1
        group = mesh.get_group()
        return (mesh, mode, group, dist.get_rank(group),
                dist.get_world_size(group))

    def _merge(self, old: State, new: State) -> State:
        """new = old + the ranks' summed deltas (new - old), in place."""
        for k, v in new.items():
            delta = v - old[k]
            self.comm.all_reduce(delta, self._group)
            torch.add(old[k], delta, out=v)
        return new

    def _save_ckpt(self, state: State, gen: torch.Generator,
                   done: int) -> None:
        if self._mesh is None:
            save_checkpoint(self.checkpoint_path, state, step=done,
                            extra={"gen": gen.get_state()})
            return
        gens = [None] * self._world
        dist.all_gather_object(gens, gen.get_state(), group=self._group)
        tables = {k: gather_rows(v.local, v.shape[0], self._group)
                  if isinstance(v, RowShard) else v
                  for k, v in state.items()}
        if self._rank == 0:
            save_checkpoint(self.checkpoint_path, tables, step=done,
                            extra={"gens": gens, "world": self._world})
        dist.barrier(group=self._group)

    def _maybe_resume(self, state: State, gen: torch.Generator) -> int:
        """Restore the tables (in place: this rank's rows of a row-sharded
        one) and the generator's state from checkpoint_path when resuming
        and a checkpoint is there; returns the steps already done."""
        if not (self.resume and checkpoint_exists(self.checkpoint_path)):
            return 0
        loaded, done, extra = load_checkpoint(self.checkpoint_path)
        shapes = {k: tuple(v.shape) for k, v in state.items()}
        saved = {k: tuple(v.shape) for k, v in loaded.items()}
        if saved != shapes:
            raise ValueError(
                f"checkpoint {self.checkpoint_path} holds tables {saved}, "
                f"this run trains {shapes}")
        saved_by = extra.get("world")  # None: saved without a mesh
        here = None if self._mesh is None else self._world

        def ranks(w):
            return "no mesh" if w is None else f"{w} ranks"

        if saved_by != here:
            raise ValueError(
                f"checkpoint {self.checkpoint_path} was saved by "
                f"{ranks(saved_by)}; this run has {ranks(here)}")
        for k, v in state.items():
            if isinstance(v, RowShard):
                v.local.copy_(loaded[k][v.lo:v.lo + v.local.shape[0]])
            else:
                v.copy_(loaded[k])
        gen.set_state(extra["gen"] if self._mesh is None
                      else extra["gens"][self._rank])
        return done

    def train(self, state: State, gen: torch.Generator,
              verbose: bool = True) -> State:
        mesh, mode, group, rank, world = self._placement(state)
        self._mesh, self._group, self._rank, self._world = (mesh, group,
                                                            rank, world)
        self._mode = mode
        self.gen = gen  # the generator of the last train(), for its state
        self.comm = CommStats()
        if mode == "rows":
            state = {k: self._row_shard(v, rank, world)
                     if getattr(v, "ndim", 0) == 2 else v
                     for k, v in state.items()}
        show, verbose = verbose, verbose and rank == 0  # rank 0 prints
        steps_total = max(1, -(-self.total_samples // self.samples_per_step))
        inv_total = float(self.samples_per_step) / float(
            max(self.total_samples, 1))
        done = self._maybe_resume(state, gen) if self.checkpoint_path else 0
        done0 = done
        t0 = time.time()
        self.calls = 0
        # the loss's mean over the ranks that train copies, when printed
        self._pmean = show and mode in ("dp", "hogwild")
        captured = ((mode is None or backend_of(mesh) == "nccl")
                    and self._captures())
        self.loop = CapturedCalls(gen, self.device, captured,
                                  None if mode is None else self.comm)
        done = self._train_calls(state, gen, done, steps_total, inv_total,
                                 verbose, t0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        # the steps this call ran (not those restored from a checkpoint);
        # the loop rounds the budget up to whole calls, so rates divide
        # this, not the request
        self.executed_samples = (done - done0) * self.samples_per_step
        if verbose:
            el = time.time() - t0
            print(f"\n\tdone: {self.executed_samples:,} samples in {el:.2f}s "
                  f"({self.executed_samples / max(el, 1e-9):,.0f} samples/sec)")
        if mode == "rows":
            state = {k: rows_to_dtensor(v.local, v.shape[0], mesh)
                     if isinstance(v, RowShard) else v
                     for k, v in state.items()}
        return state

    def _checkpoint(self, state: State, gen: torch.Generator, done: int,
                    steps_total: int) -> None:
        """Save after every ``checkpoint_every`` calls and after the last."""
        if self.checkpoint_path and (self.calls % self.checkpoint_every == 0
                                     or done >= steps_total):
            with profiling.span("driver.checkpoint"):
                self._save_ckpt(state, gen, done)

    def _progress(self, loss, done, done0, steps_total, t0) -> None:
        last = float(loss)
        el = time.time() - t0
        rate = (done - done0) * self.samples_per_step / max(el, 1e-9)
        print(f"\tloss: {last:.5f}\tprogress: "
              f"{min(100.0, 100.0 * done / steps_total):.1f}%\t"
              f"samples/sec: {rate:,.0f}", end="\r", flush=True)

    def _captures(self) -> bool:
        """Whether this driver captures its calls: ``capture`` on the card
        (``train`` also needs an NCCL group on a mesh)."""
        return self.capture and self.device.type == "cuda"

    def _call(self, state: State, gen: torch.Generator,
              alphas: torch.Tensor, loss: torch.Tensor) -> None:
        """One call: ``steps_per_call`` steps on the tables of ``state``
        with the rates ``alphas`` and the mesh mode's merges, the tables
        left in ``state``'s tensors (a table a step returned anew is copied
        back), the mean of the steps' losses written to ``loss``."""
        mode, cur, losses = self._mode, dict(state), []
        if mode == "hogwild":
            self._old = _snapshot(cur, self._old)
        for i in range(self.steps_per_call):
            if mode == "dp":
                self._old = _snapshot(cur, self._old)
            with profiling.step(i):
                cur, step_loss = self.step_fn(cur, self.ctx, gen, alphas[i])
            if mode == "dp":
                cur = self._merge(self._old, cur)
            losses.append(step_loss)
        if mode == "hogwild":
            cur = self._merge(self._old, cur)
        nbytes = 0
        for k, t in state.items():
            v = cur[k]
            if isinstance(t, RowShard):
                t, v = t.local, v.local
            if v is not t and v.data_ptr() != t.data_ptr():
                t.copy_(v)
                nbytes += t.numel() * t.element_size()
        self.copy_back_bytes = nbytes
        loss.copy_(torch.stack(losses).mean())
        if self._pmean:
            self.comm.all_reduce(loss, self._group)
            loss /= self._world

    def _train_calls(self, state: State, gen: torch.Generator, done: int,
                     steps_total: int, inv_total: float, verbose: bool,
                     t0: float) -> int:
        """The calls of a train() (eager, or the first eager and the rest
        replays of one captured call; see the class docstring). Returns the
        steps done."""
        S, M, dev = self.steps_per_call, self.micro_steps, self.device
        shape = (S, M) if M > 1 else (S,)
        alphas = torch.empty(shape, dtype=torch.float32, device=dev)
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        staging = _AlphaStaging(shape, dev)
        done0 = done

        def run():
            self._call(state, gen, alphas, loss)

        try:
            while done < steps_total:
                with profiling.span("driver.alphas"):
                    staging.put(alpha_schedule(done, S, M, self.alpha,
                                               inv_total), alphas)
                self.loop(run)
                done += S
                self.calls += 1
                self._checkpoint(state, gen, done, steps_total)
                if verbose:
                    self._progress(loss, done, done0, steps_total, t0)
        finally:
            self.loop.close()
            self._old = None
        return done

    def _row_shard(self, t: torch.Tensor, rank: int, world: int) -> RowShard:
        """This rank's rows of a whole table (copied) or of a row-sharded
        DTensor (its shard), as the table a "rows" step sees."""
        n = t.shape[0]
        lo, hi = row_range(n, world, rank)
        local = t.to_local() if is_dtensor(t) else t[lo:hi].clone()
        return RowShard(local, n, lo, self.comm, self._group)


def _snapshot(state: State, old: Optional[State]) -> State:
    """A copy of the tables, into ``old``'s buffers when given."""
    if old is None:
        return {k: v.clone() for k, v in state.items()}
    for k, v in state.items():
        old[k].copy_(v)
    return old


class PairModelBase:
    """Base for sampled-pair embedding models (the LINE family).

    ``device`` is where the tables and every draw live: the CUDA card
    unless the caller asks for another (``device="cpu"``); without a card
    the first allocation raises, there is no fallback. ``seed`` seeds the
    model's torch.Generators (init and training draws)."""

    vertex_method = "out_degrees"
    negative_method = "degrees"
    # TrainDriver's ``capture``: False runs every call eagerly on the card
    # too (to compare the two in one process)
    capture = True

    def __init__(self, graph: Graph, seed: int = 0,
                 device: torch.device | str = "cuda"):
        self.graph = graph
        self.seed = seed
        self.device = torch.device(device)
        self.tables: Optional[SamplerTables] = None
        self.state: State = {}
        self.dim: int = 0
        self.last_driver: Optional[TrainDriver] = None  # of the last train()

    @classmethod
    def load_edge_list(cls, path: str, undirected: bool = True, **kw):
        return cls(Graph.load_edge_list(path, undirected=undirected), **kw)

    def build_sampler(self) -> SamplerTables:
        """The device sampler, built at first use on the model's device."""
        if self.tables is None:
            self.tables = SamplerTables.build(
                self.graph,
                vertex_method=self.vertex_method,
                negative_method=self.negative_method,
                device=self.device,
            )
        return self.tables

    def init(self, dim: int, **kw) -> None:
        raise NotImplementedError

    def train(self, **kw) -> None:
        raise NotImplementedError

    def _generator(self, stream: int) -> torch.Generator:
        return seeded_generator(self.seed, stream, self.device)

    def set_checkpoint(self, path: Optional[str], every: int = 1,
                       resume: bool = True) -> None:
        """Checkpoint every ``every`` driver calls of later ``train()``
        calls to the directory ``path``, resuming from it when ``resume``
        (None turns checkpoints off). Models with several training phases
        give each phase a subdirectory."""
        if path is None:
            self._ckpt = None
        else:
            self._ckpt = {"checkpoint_path": path, "checkpoint_every": every,
                          "resume": resume}

    def _ckpt_kw(self, phase: Optional[str] = None) -> dict:
        """The TrainDriver checkpoint arguments of a training phase."""
        ck = getattr(self, "_ckpt", None)
        if not ck:
            return {}
        kw = dict(ck)
        if phase:
            kw["checkpoint_path"] = os.path.join(kw["checkpoint_path"], phase)
        return kw

    def load_pretrain(self, path: str, table: str = "vertex") -> None:
        """Warm start: overwrite rows of ``table`` by name from a saved
        embedding file (reference LoadPreTrain); a row-sharded table takes
        its own rows of the result."""
        t = self.state[table]
        new = torch.from_numpy(warm_start(
            full_table(t).detach().cpu().numpy(), self.graph.names, path))
        if is_dtensor(t):
            local = t.to_local()
            lo, _ = row_range(t.shape[0], t.device_mesh.size(),
                              t.device_mesh.get_local_rank())
            local.copy_(new[lo:lo + local.shape[0]])
        else:
            t.copy_(new)

    def load_state_numpy(self, tables: Dict[str, np.ndarray],
                         device: torch.device | str | None = None) -> None:
        """Take parameters given as numpy arrays (for example the JAX
        package's ``{"vertex": ..., "context": ...}``) as this model's
        float32 tables on ``device`` (default: the model's)."""
        if device is not None and torch.device(device) != self.device:
            self.device = torch.device(device)
            self.tables = None  # built again on the new device
        self.state = {
            k: torch.from_numpy(np.array(v, dtype=np.float32)).to(self.device)
            for k, v in tables.items()
        }
        self.dim = next(iter(self.state.values())).shape[1]

    def state_numpy(self) -> Dict[str, np.ndarray]:
        """The tables as float32 numpy arrays (the inverse of
        ``load_state_numpy``); row-sharded ones gathered, on every rank."""
        return {k: full_table(v).detach().cpu().numpy()
                for k, v in self.state.items()}

    def save_weights(self, path: str, table: str = "vertex") -> None:
        """Write ``table`` as an embedding file; with a process group, rank
        0 writes (a row-sharded table is gathered first, by every rank)."""
        t = full_table(self.state[table]).detach().cpu().numpy()
        if not dist.is_initialized() or dist.get_rank() == 0:
            save_embeddings(path, self.graph.names, t)

    def _drive(self, step: StepFn, ctx, samples_per_step: int, alpha: float,
               total_samples: int, steps_per_call: int, verbose: bool,
               micro_steps: int = 1, state: Optional[State] = None,
               mesh=None, sharding: str = "dp") -> State:
        """Train ``state`` (default: the model's tables) with ``step`` for
        ``total_samples`` samples on the training stream of the model's
        seed (each rank's own under "dp" and "hogwild" on ``mesh``),
        ``steps_per_call`` micro-steps a call, with the checkpoint
        settings. Returns the trained tables (updated in place, or
        row-sharded DTensors under "rows"); the TrainDriver stays as
        ``last_driver``."""
        self.last_driver = driver = TrainDriver(
            step,
            ctx=ctx,
            samples_per_step=samples_per_step,
            alpha=alpha,
            total_samples=total_samples,
            steps_per_call=max(1, steps_per_call // micro_steps),
            micro_steps=micro_steps,
            mesh=mesh,
            sharding=sharding,
            device=self.device,
            capture=self.capture,
            **self._ckpt_kw(),
        )
        rank = None
        if mesh is not None and sharding != "rows":
            rank = dist.get_rank(mesh.get_group())
        gen = seeded_generator(self.seed, TRAIN_STREAM, self.device, rank)
        return driver.train(self.state if state is None else state, gen,
                            verbose=verbose)
