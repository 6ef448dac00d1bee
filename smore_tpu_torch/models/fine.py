"""FINE and msFINE: the field-projected community embedding.

Port of ``smore_tpu/models/fine.py`` (reference FINE.cpp, msFINE.cpp with
UpdateFieldCommunity / UpdateMSFieldCommunity). The reference keeps one
shadow row per (vertex, field); here both shadow tables have n_vertices *
n_fields rows, row vid * F + fid (``ops/community.field_project``), both
initialised uniform.

A step: v1 = SourceSample, v2 = TargetSample(v1), and the update runs over
a context walk of walk_steps + 1 positions starting AT v2, without restarts;
a position is alive while every earlier one has out-edges. Negatives match
the field of their context position: one Kp-row pool per field with the
shared pool (``shared_negatives``, default 128), else K per position.
``save_weights`` writes each vertex's field-0 and field-1 vertex rows side
by side (2 * dim columns with two fields). A step's draw takes its uniforms
in the JAX draws' shapes (``draw``'s ``u``), and its update is a separate
callable. Plain torch ops: no kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from smore_tpu_torch.io.embeddings import save_embeddings
from smore_tpu_torch.models.base import (
    INIT_STREAM,
    PairModelBase,
    clamp_batch,
    draw_update_step,
    init_embedding,
    tiny_graph_pool,
)
from smore_tpu_torch.ops.community import (
    field_community_step,
    field_community_step_shared_negs,
)
from smore_tpu_torch.sampling.fields import FieldTables
from smore_tpu_torch.sampling.walks import random_walk


class FINE(PairModelBase):
    ms_variant = False

    def __init__(self, graph, seed: int = 0,
                 device: torch.device | str = "cuda"):
        super().__init__(graph, seed, device)
        self.walk_steps = 5

    @property
    def n_fields(self) -> int:
        return max(1, self.graph.n_fields)

    def init(self, dim: int) -> None:
        self.dim = dim
        rows = self.graph.n_vertices * self.n_fields
        gen = self._generator(INIT_STREAM)
        self.state = {
            "vertex": init_embedding(gen, rows, dim, device=self.device),
            "context": init_embedding(gen, rows, dim, device=self.device),
        }
        self.build_sampler()

    def load_field_meta(self, path: str) -> None:
        self.graph.load_field_meta(path)

    def _make_ctx(self):
        """(sampler, degree^0.75 field tables for the negatives)."""
        return (self.build_sampler(),
                FieldTables.build(self.graph, device=self.device))

    def _uniform_shapes(self, batch, negatives, shared_negatives):
        """The JAX draws' uniform shapes: v1, v2, the walk (none when
        walk_steps is 0) and the negatives."""
        S = self.walk_steps + 1
        walk = [(S - 1, batch, 2)] if S > 1 else []
        negs = ((self.n_fields, shared_negatives, 2) if shared_negatives
                else (batch, S, negatives, 2))
        return [(batch, 2), (batch, 2)] + walk + [negs]

    def _make_draw(self, batch: int, negatives: int, shared_negatives: int):
        """draw(ctx, gen, u=None) -> (v1 (B,), walk (B, S), alive (B, S),
        negatives (F, Kp) or (B, S, K), the field of each vertex (N,))."""
        S = self.walk_steps + 1
        nf = self.n_fields
        shapes = self._uniform_shapes(batch, negatives, shared_negatives)

        def draw(ctx, gen, u: Optional[tuple] = None):
            tables, neg_t = ctx
            if u is None:
                u = tuple(tables._uniform(gen, s) for s in shapes)
            v1 = tables.source_sample(None, (batch,), u2=u[0])
            v2 = tables.target_sample(None, v1, u2=u[1])
            if S > 1:
                walk, _ = random_walk(tables, None, v2, S - 1,
                                      restart_on_deadend=False, u=u[2])
            else:
                walk = v2[:, None]
            live = (tables.vert_meta[walk][..., 1] > 0).to(torch.float32)
            alive = torch.cumprod(torch.cat(
                [torch.ones(batch, 1, device=live.device), live[:, :-1]],
                1), 1)
            if shared_negatives:
                fids = torch.arange(nf, dtype=torch.int32,
                                    device=tables.device)[:, None].expand(
                                        nf, shared_negatives)
            else:
                fids = neg_t.field_of_v(walk)[:, :, None].expand(
                    batch, S, negatives)
            negs = neg_t.negative_field_sample(None, fids, u2=u[-1])
            return v1, walk, alive, negs, neg_t.field_of

        return draw

    def _make_update(self, negatives: int, collision: str,
                     shared_negatives: int):
        nf = self.n_fields
        ms = self.ms_variant
        step = (field_community_step_shared_negs if shared_negatives
                else field_community_step)
        kw = dict(k_equiv=negatives) if shared_negatives else {}

        def update(state, x, alpha):
            v1, walk, alive, negs, field_of = x
            wv, wc, loss = step(state["vertex"], state["context"], v1, walk,
                                alive, negs, field_of, nf, alpha,
                                ms_variant=ms, collision=collision, **kw)
            return {"vertex": wv, "context": wc}, loss

        return update

    def _make_step(self, batch, negatives, collision, shared_negatives=0):
        return draw_update_step(
            self._make_draw(batch, negatives, shared_negatives),
            self._make_update(negatives, collision, shared_negatives))

    def train(
        self,
        sample_times: float = 10,
        walk_steps: int = 5,
        negative_samples: int = 5,
        alpha: float = 0.025,
        batch: int = 2048,
        steps_per_call: int = 64,
        collision: str = "sum",
        shared_negatives: int = 128,
        verbose: bool = True,
    ) -> None:
        self.walk_steps = walk_steps
        n = self.graph.n_vertices
        batch = clamp_batch(n, batch)
        shared_negatives = min(tiny_graph_pool(n, shared_negatives), batch)
        self.state = self._drive(
            self._make_step(batch, negative_samples, collision,
                            shared_negatives), self._make_ctx(), batch, alpha,
            int(sample_times * 1_000_000), steps_per_call, verbose)

    def save_weights(self, path: str, table: str = "vertex") -> None:
        """Each vertex's field-0 and field-1 vertex rows side by side (the
        first min(2, F) fields, as the reference writes them)."""
        g = self.graph
        nf = self.n_fields
        wv = self.state["vertex"].detach().cpu().numpy().reshape(
            g.n_vertices, nf, -1)
        k = min(2, nf)
        save_embeddings(path, g.names,
                        wv[:, :k, :].reshape(g.n_vertices, -1))


class MSFINE(FINE):
    """msFINE: the vertex side projected, the context side plain, reg 0.025
    (UpdateMSFieldCommunity)."""

    ms_variant = True
