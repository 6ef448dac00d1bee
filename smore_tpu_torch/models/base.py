"""Shared model scaffolding: embedding tables and the training driver.

Port of ``smore_tpu/models/base.py`` (``hoisted_scan_step``,
``clamp_batch``, ``init_embedding``, ``zeros_embedding``, ``TrainDriver`` on
one device, ``PairModelBase``). The JAX driver ran ``steps_per_call`` steps
in one jitted ``lax.scan``; here the same steps run in a Python loop, each
step launching its kernels on the current stream, and the host reads
nothing back unless it prints progress. The update is hand-derived SGD, so
no autograd is involved.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from smore_tpu_torch.graph.graph import Graph
from smore_tpu_torch.io.embeddings import save_embeddings
from smore_tpu_torch.sampling.tables import SamplerTables

State = Dict[str, torch.Tensor]
# step_fn(state, ctx, gen, alpha) -> (state, loss); ``ctx`` holds the
# read-only sampler tensors, ``gen`` is the torch.Generator the step draws
# from, alpha is a () tensor, or (micro_steps,) when micro_steps > 1.
StepFn = Callable[[State, object, torch.Generator, torch.Tensor],
                  Tuple[State, torch.Tensor]]

ALPHA_MIN_FRAC = 1e-4  # reference: alpha_min = alpha * 0.0001


def hoisted_scan_step(draw_fn, update_fn, hoist: int) -> StepFn:
    """The StepFn of every mega-draw path: ``draw_fn(ctx, gen)`` returns a
    tuple of tensors with a leading (hoist,) axis (the draws of ``hoist``
    inner batches in one shot; they do not depend on the state, so hoisting
    them keeps the sampling law), and ``update_fn(state, x, alpha) ->
    (state, loss)`` applies one inner batch. The step takes the (hoist,)
    alpha vector of TrainDriver(micro_steps=hoist) and returns the mean
    loss of its inner batches."""

    def step(state, ctx, gen, alphas):
        xs = draw_fn(ctx, gen)
        losses = []
        for i in range(hoist):
            state, loss = update_fn(state, tuple(x[i] for x in xs),
                                    alphas[i])
            losses.append(loss)
        return state, torch.stack(losses).mean()

    return step


def clamp_batch(n_rows: int, batch: int, group: int = 1) -> int:
    """Cap the batch at the table's row count (a batched step applies each
    row's summed in-batch gradient against one stale snapshot, so a batch
    far above the row count overshoots), keeping it a multiple of the
    source draw group."""
    b = max(min(batch, n_rows), group)
    return max(b - b % group, group)


def init_embedding(gen: torch.Generator, rows: int, dim: int,
                   device: torch.device | str = "cuda") -> torch.Tensor:
    """Reference init: uniform(-0.5, 0.5) / dim."""
    u = torch.rand(rows, dim, generator=gen, dtype=torch.float32,
                   device=device)
    return (u - 0.5) / dim


def zeros_embedding(rows: int, dim: int,
                    device: torch.device | str = "cuda") -> torch.Tensor:
    return torch.zeros(rows, dim, dtype=torch.float32, device=device)


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


class TrainDriver:
    """Runs a StepFn for a total number of samples with linear alpha decay.

    samples_per_step counts every sample a step consumes (batch *
    micro_steps on the multiblock path); it sets the alpha schedule and the
    throughput report. ``device`` (default the CUDA card) holds the alpha
    schedule and the loss. One device only: ``mesh`` and
    ``checkpoint_path`` raise, as their ports are still ahead (ROADMAP
    Queue 1 items 12 and 5).
    """

    def __init__(
        self,
        step_fn: StepFn,
        ctx,
        samples_per_step: int,
        alpha: float,
        total_samples: int,
        steps_per_call: int = 256,
        micro_steps: int = 1,
        device: torch.device | str = "cuda",
        mesh=None,
        checkpoint_path: Optional[str] = None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "multi-device training (mesh=) is not ported yet "
                "(ROADMAP Queue 1 item 12)")
        if checkpoint_path is not None:
            raise NotImplementedError(
                "checkpoint/resume (checkpoint_path=) is not ported yet: "
                "torch.save checkpoints are ROADMAP Queue 1 item 5")
        self.step_fn = step_fn
        self.ctx = ctx
        self.samples_per_step = int(samples_per_step)
        self.alpha = float(alpha)
        self.total_samples = int(total_samples)
        self.steps_per_call = int(steps_per_call)
        self.micro_steps = max(1, int(micro_steps))
        self.device = torch.device(device)
        self.executed_samples = 0

    def train(self, state: State, gen: torch.Generator,
              verbose: bool = True) -> State:
        steps_total = max(1, -(-self.total_samples // self.samples_per_step))
        inv_total = float(self.samples_per_step) / float(
            max(self.total_samples, 1))
        S, M = self.steps_per_call, self.micro_steps
        done = 0
        loss = None
        t0 = time.time()
        while done < steps_total:
            # one host->device copy of the rates per call of S steps
            alphas = torch.from_numpy(alpha_schedule(
                done, S, M, self.alpha, inv_total)).to(self.device)
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            for i in range(S):
                state, step_loss = self.step_fn(state, self.ctx, gen,
                                                alphas[i])
                loss += step_loss
            loss /= S
            done += S
            if verbose:
                last = float(loss)
                el = time.time() - t0
                print(f"\tloss: {last:.5f}\tprogress: "
                      f"{min(100.0, 100.0 * done / steps_total):.1f}%\t"
                      f"samples/sec: {done * self.samples_per_step / max(el, 1e-9):,.0f}",
                      end="\r", flush=True)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        # the loop rounds the budget up to whole calls: rates divide this,
        # not the request
        self.executed_samples = done * self.samples_per_step
        if verbose:
            el = time.time() - t0
            print(f"\n\tdone: {self.executed_samples:,} samples in {el:.2f}s "
                  f"({self.executed_samples / max(el, 1e-9):,.0f} samples/sec)")
        return state


class PairModelBase:
    """Base for sampled-pair embedding models (the LINE family).

    ``device`` is where the tables and every draw live: the CUDA card
    unless the caller asks for another (``device="cpu"``); without a card
    the first allocation raises, there is no fallback. ``seed`` seeds the
    model's torch.Generators (init and training draws)."""

    vertex_method = "out_degrees"
    negative_method = "degrees"

    def __init__(self, graph: Graph, seed: int = 0,
                 device: torch.device | str = "cuda"):
        self.graph = graph
        self.seed = seed
        self.device = torch.device(device)
        self.tables: Optional[SamplerTables] = None
        self.state: State = {}
        self.dim: int = 0

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
        """A generator on the model's device, seeded from (model seed,
        stream): the counterpart of the JAX package's keys split from
        ``PRNGKey(seed)``, so init and training draw independent streams and
        every ``train()`` call replays the same draws."""
        seed = np.random.SeedSequence([self.seed, stream]).generate_state(
            1, np.uint64)[0]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        return gen

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
        ``load_state_numpy``)."""
        return {k: v.detach().cpu().numpy() for k, v in self.state.items()}

    def save_weights(self, path: str, table: str = "vertex") -> None:
        save_embeddings(path, self.graph.names,
                        self.state[table].detach().cpu().numpy())
