"""ECO: the softmax-choice embedding.

Port of ``smore_tpu/models/eco.py`` (reference ECO.cpp, live branch):
field-0 sources v1; per sample R = 5 rounds of UpdateDChoice with c1 =
TargetSample(v1) and c2 two further hops, a softmax over {c1 (weight 2),
c2, K negatives}; ONE table, initialised uniform(-0.5, 0.5) WITHOUT the
/dim scale. The rounds are folded into the batch (``tile``).

The reference's commented-out alternates are selectable heads:

- ``head="dchoice"``: the live branch (default);
- ``head="hop_choice"``: UpdateHOPChoice(v1, v2) then UpdateHOPChoice(v1,
  v3) at alpha * 0.5, v2 = TargetSample(v1), v3 two further hops, negatives
  from the global degree^0.75 table; the second update sees the first's
  writes;
- ``head="recall_rank"``: UpdateRecallRank(v1), R rounds with pos =
  TargetSample(v1) and negatives drawn by degree^0.75 WITHIN the
  positive's field; it always takes per-sample negatives.

The shared pool (``shared_negatives``, default 128) makes the softmax's
negative mass a k_equiv / Kp-scaled estimate from one pool. A step's draw
takes its uniforms in the JAX draws' shapes (``draw``'s ``u``), and its
update is a separate callable. Plain torch ops: no kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from smore_tpu_torch.models.base import (
    INIT_STREAM,
    PairModelBase,
    clamp_batch,
    draw_update_step,
    init_embedding,
    tiny_graph_pool,
)
from smore_tpu_torch.ops.community import (
    choice_softmax_step,
    choice_softmax_step_shared_negs,
    dchoice_step,
    dchoice_step_shared_negs,
)
from smore_tpu_torch.sampling.fields import FieldTables

HEADS = ("dchoice", "hop_choice", "recall_rank")


class ECO(PairModelBase):
    def __init__(self, graph, seed: int = 0, reg: float = 0.01,
                 head: str = "dchoice",
                 device: torch.device | str = "cuda"):
        super().__init__(graph, seed, device)
        if head not in HEADS:
            raise ValueError(f"unknown ECO head {head!r}")
        self.head = head
        self.reg = reg
        self.rounds = 5

    def init(self, dim: int) -> None:
        self.dim = dim
        self.state = {"vertex": init_embedding(
            self._generator(INIT_STREAM), self.graph.n_vertices, dim,
            device=self.device, scale=1.0)}  # no /dim scale (ECO.cpp:55)
        self.build_sampler()

    def load_field_meta(self, path: str) -> None:
        self.graph.load_field_meta(path)

    def _make_ctx(self):
        """(sampler, field tables by out-degree for the sources, the
        degree^0.75 field tables of recall_rank's negatives)."""
        g = self.graph
        src_t = FieldTables.build(g, weights=g.out_degree, device=self.device)
        return (self.build_sampler(), src_t,
                FieldTables.build(g, device=self.device))

    def _uniform_shapes(self, batch, negatives, shared_negatives):
        """The JAX draws' uniform shapes: the sources, the hops, the
        negatives."""
        BR = batch * self.rounds
        Kp = shared_negatives
        if self.head == "hop_choice":
            return [(batch, 2), (batch, 3, 2),
                    (2, Kp, 2) if Kp else (batch, 2, negatives, 2)]
        if self.head == "recall_rank":
            return [(batch, 2), (BR, 2), (BR, negatives, 2)]
        return [(batch, 2), (BR, 3, 2),
                (Kp, 2) if Kp else (BR, negatives, 2)]

    def _make_draw(self, batch: int, negatives: int, shared_negatives: int):
        """draw(ctx, gen, u=None): hop_choice (v1, v2, v3, negatives (2,
        Kp) or (B, 2, K)); recall_rank (tiled v1, pos, negatives (B R, K));
        dchoice (tiled v1, c1, c2, negatives (Kp,) or (B R, K))."""
        R = self.rounds
        head = self.head
        shapes = self._uniform_shapes(batch, negatives, shared_negatives)

        def draw(ctx, gen, u: Optional[tuple] = None):
            tables, src_t, neg_t = ctx
            if u is None:
                u = tuple(tables._uniform(gen, s) for s in shapes)
            v1 = src_t.negative_field_sample(
                None, torch.zeros(batch, dtype=torch.int32,
                                  device=tables.device), u2=u[0])
            negs_shape = shapes[2][:-1]
            if head == "recall_rank":
                vB = v1.repeat(R)
                pos = tables.target_sample(None, vB, u2=u[1])
                fids = neg_t.field_of_v(pos)
                negs = neg_t.negative_field_sample(
                    None, fids[:, None].expand(negs_shape), u2=u[2])
                return vB, pos, negs
            src = v1 if head == "hop_choice" else v1.repeat(R)
            c1 = tables.target_sample(None, src, u2=u[1][:, 0])
            c2 = tables.target_sample(None, c1, u2=u[1][:, 1])
            c2 = tables.target_sample(None, c2, u2=u[1][:, 2])
            negs = tables.negative_sample(None, negs_shape, u2=u[2])
            return src, c1, c2, negs

        return draw

    def _make_update(self, negatives: int, collision: str,
                     shared_negatives: int):
        reg = self.reg
        head = self.head
        kw = dict(reg=reg, collision=collision)
        pool = dict(kw, k_equiv=negatives)

        def update(state, x, alpha):
            w = state["vertex"]
            if head == "recall_rank":
                vB, pos, negs = x
                w, loss = choice_softmax_step(w, vB, pos, negs, alpha, **kw)
            elif head == "hop_choice":
                v1, v2, v3, negs = x
                if shared_negatives:
                    w, l1 = choice_softmax_step_shared_negs(
                        w, v1, v2, negs[0], alpha, **pool)
                    w, l2 = choice_softmax_step_shared_negs(
                        w, v1, v3, negs[1], alpha * 0.5, **pool)
                else:
                    w, l1 = choice_softmax_step(w, v1, v2, negs[:, 0], alpha,
                                                **kw)
                    w, l2 = choice_softmax_step(w, v1, v3, negs[:, 1],
                                                alpha * 0.5, **kw)
                loss = l1 + l2
            elif shared_negatives:
                w, loss = dchoice_step_shared_negs(w, *x, alpha, **pool)
            else:
                w, loss = dchoice_step(w, *x, alpha, **kw)
            return {"vertex": w}, loss

        return update

    def _make_step(self, batch, negatives, collision, shared_negatives=0):
        return draw_update_step(
            self._make_draw(batch, negatives, shared_negatives),
            self._make_update(negatives, collision, shared_negatives))

    def train(
        self,
        sample_times: float = 10,
        negative_samples: int = 5,
        reg: float = 0.01,
        alpha: float = 0.025,
        batch: int = 2048,
        steps_per_call: int = 64,
        collision: str = "sum",
        shared_negatives: int = 128,
        verbose: bool = True,
    ) -> None:
        self.reg = reg
        batch = clamp_batch(self.graph.n_vertices, batch)
        # recall_rank keeps per-sample field-matched negatives; the pool is
        # not capped at the batch here
        shared_negatives = (0 if self.head == "recall_rank" else
                            tiny_graph_pool(self.graph.n_vertices,
                                            shared_negatives))
        self.state = self._drive(
            self._make_step(batch, negative_samples, collision,
                            shared_negatives), self._make_ctx(), batch, alpha,
            int(sample_times * 1_000_000), steps_per_call, verbose)
