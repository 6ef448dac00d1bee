"""HPE (heterogeneous preference embedding) and PE (proximity embedding).

Port of ``smore_tpu/models/hpe.py``:

- HPE: per sampled edge (v1, v2), the reference's UpdateCommunity walks
  ``walk_steps`` contexts starting AT v2 (each context an SGNS pair with L2
  against v1, masked past the walk's first dead end), plus one reversed
  plain pair (v2, v1). The walk extensions come from a bank drawn once per
  run (``build_walk_bank``, 16 walks per start vertex by default), and the
  draws of 8 inner batches run as one mega-draw.
- PE: the reversed pair (v2, v1) alone; with ``load_walk_meta`` each
  sampled pair also gets walk extensions of v2, masked at v1's per-vertex
  step count.

Both updates are the masked plain ``ops.update.sgns_shared_negs_step``, as
in the JAX package, so the models reach no kernel. Every walk function
takes its uniforms (``u``, the bank column ``r``) in the JAX draws' shapes;
given the JAX package's own, the pairs are its pairs bit for bit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from smore_tpu_torch.models.base import (
    INIT_STREAM,
    PairModelBase,
    clamp_batch,
    hoisted_scan_step,
    init_embedding,
    zeros_embedding,
)
from smore_tpu_torch.ops.update import sgns_shared_negs_step
from smore_tpu_torch.sampling.tables import SamplerTables
from smore_tpu_torch.sampling.walks import random_walk

# the walk bank's generator stream of a model seed; it stands for the JAX
# package's fold_in(key, 77)
_BANK = 77
_INVALID = 1 << 30  # the bank's flag bit: vids must stay below 2^30


def community_walk_pairs(tables: SamplerTables,
                         gen: Optional[torch.Generator], src: torch.Tensor,
                         pos: torch.Tensor, walk_steps: int,
                         u: Optional[torch.Tensor] = None):
    """UpdateCommunity's context set: ``pos`` itself and walk_steps - 1
    walk extensions of it, masked past the first dead end. Returns flat
    (vertex (M,), context (M,), mask (M,)), M = B * walk_steps, vertex in
    repeat layout. ``u`` (walk_steps - 1, B, 2) the walk's uniforms."""
    B = src.shape[0]
    if walk_steps <= 1:
        return src, pos, torch.ones(B, dtype=torch.float32,
                                    device=src.device)
    walk, _ = random_walk(tables, gen, pos, walk_steps - 1,
                          restart_on_deadend=False, u=u)  # (B, walk_steps)
    deg = tables.vert_meta[walk.long()][..., 1]
    # position t is valid iff every earlier position has out-edges
    alive = torch.cumprod(torch.cat(
        [torch.ones(B, 1, dtype=torch.float32, device=src.device),
         (deg[:, :-1] > 0).to(torch.float32)], dim=1), dim=1)
    vtx = src[:, None].expand(walk.shape)
    return vtx.reshape(-1), walk.reshape(-1), alive.reshape(-1)


def build_walk_bank(tables: SamplerTables, gen: Optional[torch.Generator],
                    n_vertices: int, k: int, walk_steps: int,
                    u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``k`` community-walk extensions per START vertex, drawn once: (N, k,
    walk_steps - 1) int32, bit 30 set on the positions past the first dead
    end. Each entry is an iid draw of the walk's law from its start; a
    training sample fetches one row with a gather instead of walk_steps - 1
    dependent draws. ``u`` (walk_steps - 1, N * k, 2) the walks'
    uniforms."""
    S = walk_steps - 1
    starts = torch.arange(n_vertices, dtype=torch.int32,
                          device=tables.device).repeat_interleave(k)
    walk, _ = random_walk(tables, gen, starts, S, restart_on_deadend=False,
                          u=u)  # (N * k, S + 1), the start column included
    deg = tables.vert_meta[walk.long()][..., 1]
    valid = torch.cumprod((deg[:, :-1] > 0).to(torch.int32), dim=1,
                          dtype=torch.int32)
    entries = walk[:, 1:] | ((1 - valid) << 30)
    return entries.reshape(n_vertices, k, S)


def community_walk_pairs_bank(bank: torch.Tensor,
                              gen: Optional[torch.Generator],
                              src: torch.Tensor, pos: torch.Tensor,
                              walk_steps: int,
                              r: Optional[torch.Tensor] = None):
    """``community_walk_pairs`` with the walk extension read from the bank
    (``build_walk_bank``): row ``r`` (B,) of pos's k walks, drawn uniformly
    from ``gen`` when None."""
    B = src.shape[0]
    if walk_steps <= 1:
        return src, pos, torch.ones(B, dtype=torch.float32,
                                    device=src.device)
    if r is None:
        r = torch.randint(0, bank.shape[1], (B,), generator=gen,
                          device=bank.device)
    rows = bank[pos.long(), r.long()]  # (B, walk_steps - 1)
    walk = torch.cat([pos[:, None], rows & (_INVALID - 1)], dim=1)
    alive = torch.cat(
        [torch.ones(B, 1, dtype=torch.float32, device=src.device),
         (1 - (rows >> 30)).to(torch.float32)], dim=1)
    vtx = src[:, None].expand(walk.shape)
    return vtx.reshape(-1), walk.reshape(-1), alive.reshape(-1)


class _TwoTableModel(PairModelBase):
    """A uniform-init vertex table and a zero context table."""

    def init(self, dim: int) -> None:
        self.dim = dim
        n = self.graph.n_vertices
        self.state = {
            "vertex": init_embedding(self._generator(INIT_STREAM), n, dim,
                                     device=self.device),
            "context": zeros_embedding(n, dim, self.device),
        }
        self.build_sampler()

    def _edge_draw(self, tables: SamplerTables, gen, n: int):
        """(src, pos) of ``n`` sampled edges."""
        if tables.has_edge_table:
            return tables.edge_sample(gen, (n,))
        src = tables.source_sample(gen, (n,))
        return src, tables.target_sample(gen, src)


class HPE(_TwoTableModel):
    def __init__(self, graph, seed: int = 0,
                 device: torch.device | str = "cuda"):
        super().__init__(graph, seed, device)
        self.walk_steps = 5
        self.reg = 0.01

    def _make_draw(self, batch: int, shared_negatives: int,
                   use_bank: bool = False):
        """draw(ctx, gen, m) -> the draws of ``m`` inner batches, each with
        a leading (m,) axis: (src, pos, negs (m, Ks), cv, cc, cmask)."""
        S = self.walk_steps

        def draw(ctx, gen, m):
            tables, bank = ctx  # bank: build_walk_bank's, or None
            n = m * batch
            src, pos = self._edge_draw(tables, gen, n)
            negs = tables.negative_sample(gen, (m * shared_negatives,))
            if use_bank:
                cv, cc, cmask = community_walk_pairs_bank(bank, gen, src,
                                                          pos, S)
            else:
                cv, cc, cmask = community_walk_pairs(tables, gen, src, pos, S)
            # the pairs are per-sample blocks in draw order: the (m, -1)
            # reshape is exact
            return (src.reshape(m, batch), pos.reshape(m, batch),
                    negs.reshape(m, shared_negatives), cv.reshape(m, -1),
                    cc.reshape(m, -1), cmask.reshape(m, -1))

        return draw

    def _make_update(self, negatives: int, collision: str):
        """update(state, (src, pos, negs, cv, cc, cmask), alpha): the
        community pairs (v1 against v2's walk, L2 ``reg``; cv is in repeat
        layout, so the source rows are gathered once per sample), then the
        reversed plain pair (v2, v1)."""
        S, reg = self.walk_steps, self.reg

        def update(state, x, alpha):
            src, pos, negs, cv, cc, cmask = x
            wv, wc, l1 = sgns_shared_negs_step(
                state["vertex"], state["context"], cv, cc, negs, alpha,
                k_equiv=negatives, mask=cmask, reg=reg, collision=collision,
                src_group=S if S > 1 else 1)
            wv, wc, l2 = sgns_shared_negs_step(
                wv, wc, pos, src, negs, alpha, k_equiv=negatives,
                collision=collision)
            return {"vertex": wv, "context": wc}, l1 + l2

        return update

    def _make_step(self, batch, negatives, shared_negatives, collision,
                   hoist=1, use_bank=False):
        draw = self._make_draw(batch, shared_negatives, use_bank)
        update = self._make_update(negatives, collision)
        if hoist > 1:
            return hoisted_scan_step(lambda ctx, gen: draw(ctx, gen, hoist),
                                     update, hoist)

        def step(state, ctx, gen, alpha):
            return update(state, tuple(a[0] for a in draw(ctx, gen, 1)),
                          alpha)

        return step

    def train(
        self,
        sample_times: float = 10,
        walk_steps: int = 5,
        negative_samples: int = 5,
        reg: float = 0.01,
        alpha: float = 0.025,
        batch: int = 8192,
        steps_per_call: int = 64,
        shared_negatives: int = 256,
        collision: str = "sum",
        hoist: int = 0,  # inner batches per mega-draw; 0 = 8
        walk_bank: int = 16,  # walk extensions drawn once per start vertex
        # and reused; 0 = fresh walks every step
        verbose: bool = True,
    ) -> None:
        self.walk_steps = walk_steps
        self.reg = reg
        if hoist == 0:
            hoist = 8
        batch = clamp_batch(self.graph.n_vertices, batch)
        tables = self.build_sampler()
        bank = None
        if walk_bank > 0 and walk_steps > 1:
            bank = build_walk_bank(tables, self._generator(_BANK),
                                   self.graph.n_vertices, walk_bank,
                                   walk_steps)
        self.state = self._drive(
            self._make_step(batch, negative_samples, shared_negatives,
                            collision, hoist, use_bank=bank is not None),
            (tables, bank), batch * hoist, alpha,
            int(sample_times * 1_000_000), steps_per_call, verbose,
            micro_steps=hoist)


class PE(_TwoTableModel):
    """Proximity embedding: the reversed-pair SGNS update (v2, v1). With
    ``load_walk_meta`` each sampled (v1, v2) also contributes walk
    extensions of v2, masked at v1's per-vertex step count; with every
    vertex at 1 step this is the plain branch exactly."""

    def load_walk_meta(self, path: str) -> None:
        """``vertex steps`` file, default 3 steps (reference
        PE::LoadWalkMeta)."""
        self.graph.load_walk_meta(path)

    def _walk_buffer(self) -> int:
        """The static walk length of the dynamic-steps branch: the largest
        per-vertex step count, clamped to [1, 32]."""
        return int(max(1, min(int(np.max(self.graph.walk_steps)), 32)))

    def _make_draw(self, batch: int, shared_negatives: int):
        """draw(ctx, gen, u=None) -> (src, pos, negs) and, with walk meta,
        the community pairs (cv, cc) and their mask: context position t (0
        = v2 itself) counts while the walk is alive and t < steps[v1].
        ``u`` = (sources (B, 2), contexts (B, 2), negatives (Ks, 2)[, walk
        (S - 1, B, 2)]) uniforms, drawn from ``gen`` when None."""
        dyn = self.graph.walk_steps is not None
        S = self._walk_buffer() if dyn else 1
        dev = self.device
        t = torch.arange(S, dtype=torch.int32, device=dev)[None, :].expand(
            batch, S).reshape(-1)

        def draw(ctx, gen, u: Optional[tuple] = None):
            tables, dyn_steps = ctx
            if u is None:
                shapes = [(batch, 2), (batch, 2), (shared_negatives, 2)]
                if S > 1:
                    shapes.append((S - 1, batch, 2))
                u = tuple(tables._uniform(gen, s) for s in shapes)
            src = tables.source_sample(None, (batch,), u2=u[0])
            pos = tables.target_sample(None, src, u2=u[1])
            negs = tables.negative_sample(None, (shared_negatives,), u2=u[2])
            if not dyn:
                return src, pos, negs
            cv, cc, alive = community_walk_pairs(
                tables, None, src, pos, S, u=u[3] if S > 1 else None)
            mask = alive * (t < dyn_steps[cv.long()]).to(torch.float32)
            return src, pos, negs, cv, cc, mask

        return draw

    def _make_update(self, negatives: int, collision: str):
        """update(state, draws, alpha): the reversed pairs, (v2, v1) or,
        with walk meta, the masked (walk context, v1) pairs."""

        def update(state, x, alpha):
            if len(x) == 3:
                src, pos, negs = x
                vtx, ctx, mask = pos, src, None
            else:
                _, _, negs, cv, cc, mask = x
                vtx, ctx = cc, cv
            wv, wc, loss = sgns_shared_negs_step(
                state["vertex"], state["context"], vtx, ctx, negs, alpha,
                k_equiv=negatives, mask=mask, collision=collision)
            return {"vertex": wv, "context": wc}, loss

        return update

    def _make_step(self, batch, negatives, shared_negatives, collision):
        draw = self._make_draw(batch, shared_negatives)
        update = self._make_update(negatives, collision)

        def step(state, ctx, gen, alpha):
            return update(state, draw(ctx, gen), alpha)

        return step

    def train(
        self,
        sample_times: float = 10,
        negative_samples: int = 5,
        alpha: float = 0.025,
        batch: int = 8192,
        steps_per_call: int = 128,
        shared_negatives: int = 128,
        collision: str = "sum",
        verbose: bool = True,
    ) -> None:
        batch = clamp_batch(self.graph.n_vertices, batch)
        dyn = self.graph.walk_steps
        dyn_steps = (torch.zeros(0, dtype=torch.int32, device=self.device)
                     if dyn is None else torch.from_numpy(
                         np.asarray(dyn, np.int32)).to(self.device))
        self.state = self._drive(
            self._make_step(batch, negative_samples, shared_negatives,
                            collision), (self.build_sampler(), dyn_steps),
            batch, alpha, int(sample_times * 1_000_000), steps_per_call,
            verbose)
