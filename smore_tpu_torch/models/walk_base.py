"""Shared scaffolding of the walk models (the DeepWalk family).

Port of ``smore_tpu/models/walk_base.py``. The reference shuffles all
vertices every epoch and, per vertex, walks, maps the walk to pairs and
updates them, with alpha decayed linearly over walk_times * N walks. Here
one step draws a batch of start vertices, walks them all at once, maps the
walks to masked pairs and applies one masked shared-negative SGNS update
(``ops.update.sgns_shared_negs_step``, the plain path: the mask keeps the
walks off kernel K1, as in the JAX package); the alpha schedule counts
walks. ``_run`` keeps the JAX package's policy: the truncated-budget
re-batching with four inner passes, and epoch-exact starts (one hoisted
block of draws is one epoch, a permutation of all vertices) on graphs of
at most 131,072 vertices; on a "dp" mesh neither, and one batch a step.
"""

from __future__ import annotations

import torch

from smore_tpu_torch.models.base import (
    INIT_STREAM,
    PairModelBase,
    freshness_policy,
    hoisted_scan_step,
    init_embedding,
    trunc_mass_multiplier,
    zeros_embedding,
)
from smore_tpu_torch.ops.update import sgns_shared_negs_step
from smore_tpu_torch.utils import profiling


# the epoch hoist: graphs up to this many vertices, at most this many
# batches in one block of draws
EPOCH_MAX_VERTICES = 131_072
EPOCH_MAX_BATCHES = 1024
# the typed and temporal walk models' hoist: the walks of this many starts
# in one draw (their walks are many small ops a step), at most 64 batches
DRAW_HOIST_WALKS = 2048


def draw_hoist(batch_walks: int) -> int:
    """Batches of walks drawn at once by Metapath2Vec and CTDNE: the walks
    do not depend on the tables, so drawing several batches' walks in one
    pass keeps the law and divides the walk's host ops by the hoist."""
    return max(1, min(64, DRAW_HOIST_WALKS // max(1, batch_walks)))


class WalkSGNSBase(PairModelBase):
    """Base of the models whose step is walks -> positive pairs -> SGNS."""

    def init(self, dim: int) -> None:
        self.dim = dim
        n = self.graph.n_vertices
        self.state = {
            "vertex": init_embedding(self._generator(INIT_STREAM), n, dim,
                                     device=self.device),
            "context": zeros_embedding(n, dim, self.device),
        }
        self.build_sampler()

    def _emit_pairs(self, ctx, gen: torch.Generator, starts: torch.Tensor):
        """(src, pos, mask) flat pair tensors of the walks from ``starts``,
        in start order."""
        raise NotImplementedError

    def _make_ctx(self):
        """What the step reads besides the tables (the sampler here)."""
        return self.build_sampler()

    def _tables_of(self, ctx):
        return ctx

    def _make_step(self, batch_walks: int, negatives: int,
                   shared_negatives: int, collision: str, hoist: int = 1,
                   epoch_starts: bool = False):
        def draw(ctx, gen, n_walks, n_negs):
            tables = self._tables_of(ctx)
            n = tables.n_vertices
            dev = tables.device
            with profiling.segment("walk.starts"):
                if epoch_starts:
                    # the reference's start law: per epoch a shuffle of all
                    # vertices, each starting one walk; slack past n is
                    # filled by uniform draws
                    starts = torch.randperm(n, generator=gen, device=dev,
                                            dtype=torch.int32)
                    if n_walks > n:
                        fill = torch.randint(0, n, (n_walks - n,),
                                             generator=gen, device=dev,
                                             dtype=torch.int32)
                        starts = torch.cat([starts, fill])
                    else:
                        starts = starts[:n_walks]
                else:
                    starts = torch.randint(0, n, (n_walks,), generator=gen,
                                           device=dev, dtype=torch.int32)
            src, pos, mask = self._emit_pairs(ctx, gen, starts)
            with profiling.segment("walk.negatives"):
                negs = tables.negative_sample(gen, (n_negs,))
            return src, pos, mask, negs

        passes = int(getattr(self, "inner_passes", 1))

        def update(state, x, alpha):
            src, pos, mask, negs = x
            wv, wc = state["vertex"], state["context"]
            # passes > 1: the gradients are evaluated again at the updated
            # tables on the same samples, alpha split across the passes,
            # which brings a batched step nearer the reference's sequential
            # per-pair updates (with a zero context table one batched pass
            # gives every pair cp = 0 at once)
            for _ in range(passes):
                wv, wc, loss = sgns_shared_negs_step(
                    wv, wc, src, pos, negs, alpha / passes,
                    k_equiv=negatives, mask=mask, collision=collision)
            return {"vertex": wv, "context": wc}, loss

        if hoist > 1:
            # the walks of ``hoist`` batches in one draw (they do not depend
            # on the tables, so the law is kept); the mapper's pairs are
            # per-walk blocks in start order, so the reshape is exact
            def hdraw(ctx, gen):
                with profiling.segment("walk.draw"):
                    src, pos, mask, negs = draw(ctx, gen, hoist * batch_walks,
                                                hoist * shared_negatives)
                return (src.reshape(hoist, -1), pos.reshape(hoist, -1),
                        mask.reshape(hoist, -1),
                        negs.reshape(hoist, shared_negatives))

            return hoisted_scan_step(hdraw, update, hoist,
                                     update_segment="walk.update")

        def step(state, ctx, gen, alpha):
            with profiling.segment("walk.draw"):
                x = draw(ctx, gen, batch_walks, shared_negatives)
            with profiling.segment("walk.update"):
                return update(state, x, alpha)

        return step

    def _run(self, total_walks: int, batch_walks: int, negatives: int,
             alpha: float, steps_per_call: int, shared_negatives: int,
             collision: str, verbose: bool, mesh=None, sharding: str = "dp",
             hoist: int = 1) -> None:
        n = self.graph.n_vertices
        epoch_starts = False
        if mesh is not None and sharding == "dp":
            hoist = 1  # dp merges the ranks' deltas every step
        else:
            # truncated budgets: shrink the batch (base.freshness_policy)
            # and compensate with four inner passes and a larger step mass
            bw2, hoist = freshness_policy(total_walks, batch_walks, hoist)
            if (bw2 != batch_walks
                    and getattr(self, "inner_passes", 0) in (0, 1)):
                self.inner_passes = 4
                alpha = alpha * trunc_mass_multiplier(bw2)
            batch_walks = bw2
            # epoch-exact starts: one hoisted block is one epoch, where the
            # block fits in memory
            steps_per_epoch = -(-n // batch_walks)
            if (n <= EPOCH_MAX_VERTICES
                    and steps_per_epoch <= EPOCH_MAX_BATCHES):
                epoch_starts = True
                hoist = steps_per_epoch
        # the schedule counts walks
        self.state = self._drive(
            self._make_step(batch_walks, negatives, shared_negatives,
                            collision, hoist, epoch_starts),
            self._make_ctx(), batch_walks * hoist, alpha, total_walks,
            steps_per_call, verbose, micro_steps=hoist, mesh=mesh,
            sharding=sharding)
