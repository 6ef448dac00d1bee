"""HOP-REC: high-order proximity chains with decayed ranking updates.

Port of ``smore_tpu/models/hoprec.py`` (the reference's HBPR):

- sources are field-0 vertices (users), drawn by out-degree from a
  ``FieldTables`` (the reference resamples until the field matches);
- the hop chain: cid_1 is one hop from the source, cid_w two more hops from
  cid_{w-1}, so every level stays on the item side of a bipartite graph;
- one negative per level, matched to the level's field, uniform over the
  vertices with in-edges;
- one margin-filtered BPR update (``ops.update.fbpr_step``) for all
  levels, level w at alpha / w and margin / w, on ONE table.

A step's draws take their uniforms in the JAX draws' shapes (``draw``'s
``u``), so the tests feed the JAX package's own. Plain torch ops: the model
reaches no kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from smore_tpu_torch.models.base import (
    INIT_STREAM,
    PairModelBase,
    clamp_batch,
    init_embedding,
)
from smore_tpu_torch.ops.update import fbpr_step
from smore_tpu_torch.sampling.fields import FieldTables
from smore_tpu_torch.sampling.tables import SamplerTables


def hop_chain(tables: SamplerTables, vid: torch.Tensor, walk_steps: int,
              u: torch.Tensor) -> torch.Tensor:
    """(B, walk_steps) contexts: one hop from ``vid``, then two more hops
    per level, from the uniforms ``u`` (B, 2 * walk_steps - 1, 2)."""
    cur = tables.target_sample(None, vid, u2=u[:, 0])
    cids = [cur]
    for h in range(1, walk_steps):
        cur = tables.target_sample(None, cur, u2=u[:, 2 * h - 1])
        cur = tables.target_sample(None, cur, u2=u[:, 2 * h])
        cids.append(cur)
    return torch.stack(cids, dim=1)


class HOPREC(PairModelBase):
    negative_method = "no_degrees"

    def __init__(self, graph, seed: int = 0,
                 device: torch.device | str = "cuda"):
        super().__init__(graph, seed, device)
        self.walk_steps = 5
        self.margin = 1.0

    def init(self, dim: int) -> None:
        self.dim = dim
        self.state = {"vertex": init_embedding(
            self._generator(INIT_STREAM), self.graph.n_vertices, dim,
            device=self.device)}
        self.build_sampler()

    def _make_ctx(self):
        """(sampler, field-0 source tables by out-degree, field-matched
        negative tables uniform over the vertices with in-edges)."""
        g = self.graph
        src_t = FieldTables.build(g, weights=g.out_degree, device=self.device)
        neg_t = FieldTables.build(
            g, weights=(g.in_degree > 0).astype(np.float64),
            device=self.device)
        return (self.build_sampler(), src_t, neg_t)

    def _make_draw(self, batch: int):
        """draw(ctx, gen, u=None) -> (vid (B,), cid (B, W), nid (B, W));
        ``u`` = (sources (B, 2), chain (B, 2W - 1, 2), negatives (B * W,
        2)) uniforms, drawn from ``gen`` when None."""
        W = self.walk_steps

        def draw(ctx, gen, u: Optional[tuple] = None):
            tables, src_t, neg_t = ctx
            if u is None:
                u = tuple(tables._uniform(gen, s) for s in (
                    (batch, 2), (batch, 2 * W - 1, 2), (batch * W, 2)))
            zeros = torch.zeros(batch, dtype=torch.int32,
                                device=tables.device)
            vid = src_t.negative_field_sample(None, zeros, u2=u[0])
            cid = hop_chain(tables, vid, W, u[1])
            nid = neg_t.negative_field_sample(
                None, neg_t.field_of_v(cid.reshape(-1)), u2=u[2])
            return vid, cid, nid.reshape(batch, W)

        return draw

    def _make_update(self, batch: int, collision: str):
        """update(state, (vid, cid, nid), alpha): one fbpr_step over every
        level, level w at alpha / w and margin / w."""
        W = self.walk_steps
        w_lvl = torch.arange(1, W + 1, dtype=torch.float32,
                             device=self.device)
        margin_b = (self.margin / w_lvl).repeat(batch)

        def update(state, x, alpha):
            vid, cid, nid = x
            w, _, loss = fbpr_step(
                state["vertex"], state["vertex"],
                vid[:, None].expand(batch, W).reshape(-1), cid.reshape(-1),
                nid.reshape(-1, 1), (alpha / w_lvl).repeat(batch), margin_b,
                shared_table=True, collision=collision)
            return {"vertex": w}, loss

        return update

    def _make_step(self, batch: int, collision: str):
        draw = self._make_draw(batch)
        update = self._make_update(batch, collision)

        def step(state, ctx, gen, alpha):
            return update(state, draw(ctx, gen), alpha)

        return step

    def train(
        self,
        sample_times: float = 10,
        walk_steps: int = 5,
        margin: float = 1.0,
        alpha: float = 0.025,
        batch: int = 4096,
        steps_per_call: int = 64,
        collision: str = "sum",
        verbose: bool = True,
    ) -> None:
        self.walk_steps = walk_steps
        self.margin = margin
        batch = clamp_batch(self.graph.n_vertices, batch)
        self.state = self._drive(
            self._make_step(batch, collision), self._make_ctx(), batch, alpha,
            int(sample_times * 1_000_000), steps_per_call, verbose)
