"""CSE, collaborative similarity embedding: NEMF and NERANK.

Port of ``smore_tpu/models/cse.py``. Both keep FOUR tables: ``vertexU`` /
``contextU`` for users and ``vertexI`` / ``contextI`` for items (vertex
rows uniform-init, context rows zero). Per sampled field-0 user vid with
item neighbour cid, one step runs

  1. the item community: vertexI[cid] against a walk from vid (the masked
     shared-negative SGNS update at alpha * 0.05),
  2. the user community: vertexU[vid] against a walk from cid, the same,
  3. the head on (vertexU, vertexI): NEMF ``mf_step`` with 5 per-sample
     negatives, NERANK ``warp_step`` against 16 field-matched uniform
     negatives, both with L2 0.025.

``save_weights`` writes field-0 rows from U and the other rows from I. A
step's draws take their uniforms in the JAX draws' shapes (``draw``'s
``u``), so the tests feed the JAX package's own. Plain torch ops: the
family reaches no kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from smore_tpu_torch.io.embeddings import save_embeddings
from smore_tpu_torch.models.base import (
    INIT_STREAM,
    PairModelBase,
    clamp_batch,
    init_embedding,
    zeros_embedding,
)
from smore_tpu_torch.models.hpe import community_walk_pairs
from smore_tpu_torch.ops.update import mf_step, sgns_shared_negs_step, warp_step
from smore_tpu_torch.sampling.fields import FieldTables

RANK_NEGATIVES = 16  # NERANK's field-matched candidates per sample
HEAD_REG = 0.025
COMMUNITY_RATE = 0.05  # the community updates' share of alpha


class _CSEBase(PairModelBase):
    head = "mf"  # or "rank"

    def __init__(self, graph, seed: int = 0,
                 device: torch.device | str = "cuda"):
        super().__init__(graph, seed, device)
        self.walk_steps = 5

    def init(self, dim: int) -> None:
        self.dim = dim
        n = self.graph.n_vertices
        gen = self._generator(INIT_STREAM)
        self.state = {
            "vertexU": init_embedding(gen, n, dim, device=self.device),
            "vertexI": init_embedding(gen, n, dim, device=self.device),
            "contextU": zeros_embedding(n, dim, self.device),
            "contextI": zeros_embedding(n, dim, self.device),
        }
        self.build_sampler()

    def load_field_meta(self, path: str) -> None:
        self.graph.load_field_meta(path)

    def _make_ctx(self):
        """(sampler, field-0 source tables by out-degree, uniform field
        tables for the ranking head's negatives)."""
        g = self.graph
        src_t = FieldTables.build(g, weights=g.out_degree, device=self.device)
        uni_t = FieldTables.build(g, weights=np.ones(g.n_vertices),
                                  device=self.device)
        return (self.build_sampler(), src_t, uni_t)

    def _uniform_shapes(self, batch, negatives, shared_negatives):
        """The JAX draws' uniform shapes: vid, cid, the pool, the two
        community walks (none when walk_steps <= 1) and the head's
        negatives."""
        S = self.walk_steps
        walk = [(S - 1, batch, 2)] * 2 if S > 1 else []
        head = ((batch, negatives, 2) if self.head == "mf"
                else (batch, RANK_NEGATIVES, 2))
        return [(batch, 2), (batch, 2), (shared_negatives, 2)] + walk + [head]

    def _make_draw(self, batch: int, negatives: int, shared_negatives: int):
        """draw(ctx, gen, u=None) -> (vid, cid, negs, (cv, cc, cm), (uv, uc,
        um), hneg): the user and item, the shared pool, the two community
        pair sets and the head's negatives. ``u``: uniforms of
        ``_uniform_shapes``, drawn from ``gen`` when None."""
        S = self.walk_steps
        shapes = self._uniform_shapes(batch, negatives, shared_negatives)

        def draw(ctx, gen, u: Optional[tuple] = None):
            tables, src_t, uni_t = ctx
            if u is None:
                u = tuple(tables._uniform(gen, s) for s in shapes)
            u_walk = u[3:5] if S > 1 else (None, None)
            zeros = torch.zeros(batch, dtype=torch.int32,
                                device=tables.device)
            vid = src_t.negative_field_sample(None, zeros, u2=u[0])
            cid = tables.target_sample(None, vid, u2=u[1])
            negs = tables.negative_sample(None, (shared_negatives,), u2=u[2])
            item = community_walk_pairs(tables, None, cid, vid, S,
                                        u=u_walk[0])
            user = community_walk_pairs(tables, None, vid, cid, S,
                                        u=u_walk[1])
            if self.head == "mf":
                hneg = tables.negative_sample(None, (batch, negatives),
                                              u2=u[-1])
            else:
                fid = uni_t.field_of_v(cid)
                hneg = uni_t.negative_field_sample(
                    None, fid[:, None].expand(batch, RANK_NEGATIVES),
                    u2=u[-1])
            return vid, cid, negs, item, user, hneg

        return draw

    def _make_update(self, negatives: int, collision: str):
        """update(state, draws, alpha): the two community updates, then the
        head."""
        head = self.head

        def update(state, x, alpha):
            vid, cid, negs, (cv, cc, cm), (uv, uc, um), hneg = x
            a_comm = alpha * COMMUNITY_RATE
            wvI, wcI, l1 = sgns_shared_negs_step(
                state["vertexI"], state["contextI"], cv, cc, negs, a_comm,
                k_equiv=negatives, mask=cm, collision=collision)
            wvU, wcU, l2 = sgns_shared_negs_step(
                state["vertexU"], state["contextU"], uv, uc, negs, a_comm,
                k_equiv=negatives, mask=um, collision=collision)
            head_step = mf_step if head == "mf" else warp_step
            wvU, wvI, l3 = head_step(wvU, wvI, vid, cid, hneg, alpha,
                                     reg=HEAD_REG, collision=collision)
            return ({"vertexU": wvU, "vertexI": wvI, "contextU": wcU,
                     "contextI": wcI}, l1 + l2 + l3)

        return update

    def _make_step(self, batch, negatives, shared_negatives, collision):
        draw = self._make_draw(batch, negatives, shared_negatives)
        update = self._make_update(negatives, collision)

        def step(state, ctx, gen, alpha):
            return update(state, draw(ctx, gen), alpha)

        return step

    def train(
        self,
        sample_times: float = 10,
        walk_steps: int = 5,
        negative_samples: int = 5,
        alpha: float = 0.025,
        batch: int = 2048,
        steps_per_call: int = 64,
        shared_negatives: int = 256,
        collision: str = "sum",
        verbose: bool = True,
    ) -> None:
        self.walk_steps = walk_steps
        batch = clamp_batch(self.graph.n_vertices, batch)
        self.state = self._drive(
            self._make_step(batch, negative_samples, shared_negatives,
                            collision), self._make_ctx(), batch, alpha,
            int(sample_times * 1_000_000), steps_per_call, verbose)

    def save_weights(self, path: str, table: str = "vertex") -> None:
        """Field-0 rows from vertexU, the others from vertexI."""
        g = self.graph
        fields = (g.fields if g.fields is not None
                  else np.zeros(g.n_vertices, int))
        wU = self.state["vertexU"].detach().cpu().numpy()
        wI = self.state["vertexI"].detach().cpu().numpy()
        save_embeddings(path, g.names, np.where((fields == 0)[:, None], wU,
                                                wI))


class NEMF(_CSEBase):
    head = "mf"


class NERANK(_CSEBase):
    head = "rank"
