"""CTDNE: continuous-time dynamic network embeddings.

Port of ``smore_tpu/models/ctdne.py``. Per walk: a uniform start, a
random start time in the node's active range, a time-increasing
TemporalRandomWalk, skip-gram pairs of its live positions, and the masked
shared-negative SGNS update with negatives drawn by node ACTIVITY^0.75
(the plain step, not kernel K1, as in the JAX package). At truncated
budgets the freshness policy shrinks the batch and takes four inner passes
at twice the rate. The walks of ``walk_base.draw_hoist`` batches are
drawn at once.
"""

from __future__ import annotations

import numpy as np
import torch

from smore_tpu_torch.graph.temporal import TemporalGraph, TemporalTables
from smore_tpu_torch.models.base import (
    INIT_STREAM,
    freshness_policy,
    init_embedding,
    zeros_embedding,
)
from smore_tpu_torch.models.walk_base import WalkSGNSBase, draw_hoist
from smore_tpu_torch.sampling.mappers import skipgram_pairs
from smore_tpu_torch.sampling.tables import VertexLaw


class CTDNE(WalkSGNSBase):
    def __init__(self, tg: TemporalGraph, seed: int = 0,
                 time_window: float = None,
                 device: torch.device | str = "cuda"):
        super().__init__(tg, seed, device)
        self.tg = tg
        span = tg.max_time - tg.min_time
        self.time_window = time_window if time_window else max(span * 0.1,
                                                               1.0)
        self.walk_steps = 40
        self.window_size = 5

    @classmethod
    def load_edge_list(cls, path: str, **kw):
        return cls(TemporalGraph.load_edge_list(path), **kw)

    def init(self, dim: int) -> None:
        self.dim = dim
        n = self.tg.n_vertices
        self.state = {
            "vertex": init_embedding(self._generator(INIT_STREAM), n, dim,
                                     device=self.device),
            "context": zeros_embedding(n, dim, self.device),
        }

    def _make_ctx(self):
        """(temporal tables, the activity^0.75 negative law)."""
        tg = self.tg
        # activity = in + out degree
        deg = np.zeros(tg.n_vertices)
        np.add.at(deg, np.repeat(np.arange(tg.n_vertices),
                                 np.diff(tg.indptr)), 1.0)
        np.add.at(deg, tg.edge_dst, 1.0)
        deg[deg == 0] = 1.0
        return (TemporalTables.build(tg, self.device),
                VertexLaw.from_weights(deg, power=0.75, device=self.device))

    def _tables_of(self, ctx):
        return ctx[1]

    def _emit_pairs(self, ctx, gen, starts):
        tables = ctx[0]
        tw = self.time_window
        amin = tables.active_min[starts]
        amax = tables.active_max[starts]
        span = torch.where(amax > amin, amax - amin, tw)
        t0 = amin + torch.rand(tuple(starts.shape), generator=gen,
                               device=starts.device) * span
        walk, valid = tables.temporal_walk(gen, starts, t0, self.walk_steps,
                                           tw)
        return skipgram_pairs(walk, gen, self.window_size, valid=valid)

    def train(
        self,
        walk_times: int = 10,
        walk_steps: int = 40,
        window_size: int = 5,
        negative_samples: int = 5,
        alpha: float = 0.025,
        batch_walks: int = 128,
        steps_per_call: int = 32,
        shared_negatives: int = 256,
        collision: str = "sum",
        verbose: bool = True,
        checkpoint: str = None,
        checkpoint_every: int = 1,
        resume: bool = True,
    ) -> None:
        self.walk_steps = walk_steps
        self.window_size = window_size
        total = walk_times * self.tg.n_vertices
        bw2, _ = freshness_policy(total, batch_walks, 1)
        if bw2 != batch_walks:
            # truncated budget: a smaller batch, four inner passes at twice
            # the rate (the walk family's policy)
            batch_walks = bw2
            if getattr(self, "inner_passes", 0) in (0, 1):
                self.inner_passes = 4
                alpha = alpha * 2.0
        hoist = draw_hoist(batch_walks)
        self.set_checkpoint(checkpoint, checkpoint_every, resume)
        self.state = self._drive(
            self._make_step(batch_walks, negative_samples, shared_negatives,
                            collision, hoist),
            self._make_ctx(), batch_walks * hoist, alpha, total,
            steps_per_call, verbose, micro_steps=hoist)

    def compute_temporal_coherence(self, samples: int = 1000,
                                   seed: int = 0) -> float:
        """Mean cosine similarity over sampled temporally connected pairs
        (numpy ``default_rng(seed)``)."""
        tg = self.tg
        if tg.n_edges == 0:
            return 0.0
        rng = np.random.default_rng(seed)
        idx = rng.integers(0, tg.n_edges, min(samples, tg.n_edges))
        src = np.repeat(np.arange(tg.n_vertices), np.diff(tg.indptr))[idx]
        dst = tg.edge_dst[idx]
        emb = self.state["vertex"].cpu().numpy()
        nemb = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-12)
        sims = np.sum(nemb[src] * nemb[dst], axis=1)
        sims = sims[np.isfinite(sims)]
        return float(sims.mean()) if len(sims) else 0.0
