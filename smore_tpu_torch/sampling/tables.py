"""Sampling laws, the negative alias table and the device sampler.

Port of ``smore_tpu/sampling/tables.py``: the vertex and negative
distributions, ``build_negative_table`` (the banded path's negative law)
and ``SamplerTables``, the unbanded path's device sampler. A draw is

    i ~ U{0..n-1};  u ~ U[0,1);  out = where(u < prob[i], value[i], alias[i])

two gathers and a select, vectorised over the batch. ``SamplerTables.build``
is host numpy, bit-equal to the JAX package's packed arrays; the draws run
on the tables' device from a ``torch.Generator``. Its numbers differ from
JAX's threefry, so the draws are held to their laws, not to the bits. The
JAX package's unpacked twins of the packed arrays (``vertex_prob``,
``ctx_vid``, ...) are read by no draw and are not kept.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from smore_tpu_torch.graph.graph import Graph
from smore_tpu_torch.sampling.alias import build_alias, build_alias_segmented


def _vertex_distribution(g: Graph, method: str) -> np.ndarray:
    if method == "out_degrees":
        return g.out_degree
    if method == "no_degrees":
        return (g.out_degree > 0).astype(np.float64)
    if method == "degrees":
        return g.out_degree + g.in_degree
    raise ValueError(f"unknown vertex_method {method!r}")


def _negative_distribution(g: Graph, method: str) -> np.ndarray:
    if method == "degrees":
        return g.out_degree + g.in_degree
    if method == "in_degrees":
        return g.in_degree
    if method == "no_degrees":
        return (g.in_degree > 0).astype(np.float64)
    raise ValueError(f"unknown negative_method {method!r}")


def _negative_pa(g: Graph, negative_method: str, power: float) -> np.ndarray:
    """(N, 2) f32 [prob, alias] of the negative law; alias -1 slots point
    at themselves so device gathers stay in bounds."""
    prob, alias = build_alias(
        _negative_distribution(g, negative_method), power=power)
    idx = np.arange(g.n_vertices, dtype=np.int64)
    alias = np.where(alias < 0, idx, alias)
    return np.stack([prob, alias], axis=1).astype(np.float32)


def build_negative_table(
    g: Graph,
    negative_method: str = "degrees",
    power: float = 0.75,
    device: torch.device | str = "cuda",
) -> torch.Tensor:
    """The (N, 2) f32 [prob, alias] negative alias table (deg^0.75 law)."""
    return torch.from_numpy(_negative_pa(g, negative_method, power)).to(
        device)


def _alias_pick(u2: torch.Tensor, pa: torch.Tensor) -> torch.Tensor:
    """One alias draw per leading element of ``u2`` (..., 2) from the
    (n, 2) [prob, alias] table ``pa``: i32 ids."""
    n = pa.shape[0]
    i = torch.clamp((u2[..., 0] * n).to(torch.int32), max=n - 1)
    row = pa[i]
    return torch.where(u2[..., 1] < row[..., 0], i,
                       row[..., 1].to(torch.int32))


@dataclass
class SamplerTables:
    """Device alias tables for a weighted graph (the JAX package's packed
    layouts; vids stored as float32, exact below 2^24).

      vertex_pa (N, 2) f32 [prob, alias]: source-vertex table
      neg_pa    (N, 2) f32 [prob, alias]: negative table (deg^0.75)
      vert_meta (N, 2) i32 [indptr, degree]
      ctx_pa    (E, 4) f32 [prob, vid, alias_vid, 0]: per-vertex context
                sub-tables over out-edge weights, flat
      edge_pa   (E, 8) f32 [prob, src, dst, alias_src, alias_dst, 0, 0, 0]:
                the joint edge table, one draw gives a (src, pos) pair with
                law P(src) P(pos | src); a (1, 8) dummy when the graph has
                2^24 edges or vertices or more (``has_edge_table``)
    """

    vertex_pa: torch.Tensor
    neg_pa: torch.Tensor
    vert_meta: torch.Tensor
    ctx_pa: torch.Tensor
    edge_pa: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.vertex_pa.device

    @property
    def n_vertices(self) -> int:
        return self.vertex_pa.shape[0]

    @property
    def n_edges(self) -> int:
        return self.ctx_pa.shape[0]

    @property
    def has_edge_table(self) -> bool:
        return self.edge_pa.shape[0] > 1

    @staticmethod
    def build(
        g: Graph,
        vertex_method: str = "out_degrees",
        negative_method: str = "degrees",
        power: float = 0.75,
        device: torch.device | str = "cuda",
    ) -> "SamplerTables":
        n = g.n_vertices
        vp, va = build_alias(_vertex_distribution(g, vertex_method),
                             power=power)
        # per-vertex context sub-tables; local alias slots remapped to vids
        # (-1 slots, prob 1, map to their own vid)
        cp, ca_local = build_alias_segmented(g.weights, g.indptr, power=power)
        seg_id = np.repeat(np.arange(n, dtype=np.int64), np.diff(g.indptr))
        slot = np.arange(g.n_edges, dtype=np.int64)
        alias_slot = np.where(ca_local >= 0, g.indptr[seg_id] + ca_local,
                              slot)
        ctx_alias_vid = g.indices[alias_slot]
        idx = np.arange(n, dtype=np.int64)
        va = np.where(va < 0, idx, va)
        deg = np.diff(g.indptr)

        # the joint edge table is exact only while vids fit a float32
        # mantissa and u * E stays unquantised (u has 2^24 values)
        if 0 < g.n_edges < (1 << 24) and n < (1 << 24):
            vmass = _vertex_distribution(g, vertex_method).astype(np.float64)
            vmass = np.where(vmass > 0, vmass**power, 0.0)
            w_pow = np.asarray(g.weights, dtype=np.float64)
            w_pow = np.where(w_pow > 0, w_pow**power, 0.0)
            z = np.bincount(seg_id, weights=w_pow, minlength=n)
            joint = (vmass[seg_id] / max(vmass.sum(), 1e-300)) * (
                w_pow / np.maximum(z[seg_id], 1e-300))
            eprob, ealias = build_alias(joint, power=1.0)
            ea = np.where(ealias < 0, slot, ealias)
            edge_pa = np.zeros((g.n_edges, 8), dtype=np.float32)
            edge_pa[:, 0] = eprob
            edge_pa[:, 1] = seg_id
            edge_pa[:, 2] = g.indices
            edge_pa[:, 3] = seg_id[ea]
            edge_pa[:, 4] = g.indices[ea]
        else:
            edge_pa = np.zeros((1, 8), dtype=np.float32)

        def dev(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=device, dtype=dtype)

        return SamplerTables(
            vertex_pa=dev(np.stack([vp, va], 1).astype(np.float32),
                          torch.float32),
            neg_pa=dev(_negative_pa(g, negative_method, power),
                       torch.float32),
            vert_meta=dev(np.stack([g.indptr[:-1], deg], 1).astype(np.int32),
                          torch.int32),
            ctx_pa=dev(np.stack([cp, g.indices, ctx_alias_vid,
                                 np.zeros(g.n_edges)], 1).astype(np.float32),
                       torch.float32),
            edge_pa=dev(edge_pa, torch.float32),
        )

    # ------------------------------------------------------------------ #
    # Device draws. ``u2`` (..., 2) takes uniforms drawn by the caller, so
    # one torch.rand call can serve a whole step.
    # ------------------------------------------------------------------ #
    def _uniform(self, gen: torch.Generator, shape) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=gen, device=self.device)

    def source_sample(self, gen: torch.Generator, shape,
                      u2: torch.Tensor | None = None) -> torch.Tensor:
        """Source vertices by the vertex law (reference SourceSample)."""
        if u2 is None:
            u2 = self._uniform(gen, tuple(shape) + (2,))
        return _alias_pick(u2, self.vertex_pa)

    def negative_sample(self, gen: torch.Generator, shape,
                        u2: torch.Tensor | None = None) -> torch.Tensor:
        """Negatives by the deg^0.75 law (reference NegativeSample)."""
        if u2 is None:
            u2 = self._uniform(gen, tuple(shape) + (2,))
        return _alias_pick(u2, self.neg_pa)

    def _context_of(self, vids: torch.Tensor, meta: torch.Tensor,
                    u2: torch.Tensor) -> torch.Tensor:
        """One out-neighbour per vid by edge weight^0.75, given the vids'
        [indptr, degree] rows; zero-degree vids return themselves."""
        off, deg = meta[..., 0], meta[..., 1]
        r = (u2[..., 0] * deg).to(torch.int32)  # in [0, deg)
        slot = off + torch.minimum(r, torch.clamp(deg - 1, min=0))
        row = self.ctx_pa[slot]
        out = torch.where(u2[..., 1] < row[..., 0], row[..., 1], row[..., 2])
        return torch.where(deg > 0, out.to(torch.int32), vids)

    def target_sample(self, gen: torch.Generator, vids: torch.Tensor,
                      u2: torch.Tensor | None = None) -> torch.Tensor:
        """One context per vid (reference TargetSample(vid))."""
        if u2 is None:
            u2 = self._uniform(gen, tuple(vids.shape) + (2,))
        return self._context_of(vids, self.vert_meta[vids], u2)

    def target_sample_global(self, gen: torch.Generator, shape,
                             u2: torch.Tensor | None = None) -> torch.Tensor:
        """Uniform over edge slots, corrected by the per-vertex sub-table
        (reference TargetSample())."""
        if u2 is None:
            u2 = self._uniform(gen, tuple(shape) + (2,))
        e = self.ctx_pa.shape[0]
        slot = torch.clamp((u2[..., 0] * e).to(torch.int32), max=e - 1)
        row = self.ctx_pa[slot]
        out = torch.where(u2[..., 1] < row[..., 0], row[..., 1], row[..., 2])
        return out.to(torch.int32)

    def edge_sample(self, gen: torch.Generator, shape,
                    u2: torch.Tensor | None = None):
        """(src, pos) pairs from the joint edge table, the law of
        source_sample followed by target_sample. Needs the edge table."""
        if u2 is None:
            u2 = self._uniform(gen, tuple(shape) + (2,))
        e = self.edge_pa.shape[0]
        i = torch.clamp((u2[..., 0] * e).to(torch.int32), max=e - 1)
        row = self.edge_pa[i]
        take = u2[..., 1] < row[..., 0]
        src = torch.where(take, row[..., 1], row[..., 3])
        dst = torch.where(take, row[..., 2], row[..., 4])
        return src.to(torch.int32), dst.to(torch.int32)

    def draw_edge_batch(self, gen: torch.Generator, batch: int, n_negs: int):
        """(src (batch,), pos (batch,), negs (n_negs,)) for one step from
        one uniform draw: (src, pos) from the edge table when it is built,
        else src by the vertex law and pos by src's sub-table. n_negs <=
        batch."""
        if self.has_edge_table:
            u = self._uniform(gen, (batch, 4))
            src, pos = self.edge_sample(gen, (batch,), u2=u[:, 0:2])
            negs = self.negative_sample(gen, (n_negs,), u2=u[:n_negs, 2:4])
            return src, pos, negs
        u = self._uniform(gen, (batch, 6))
        src = self.source_sample(gen, (batch,), u2=u[:, 0:2])
        pos = self.target_sample(gen, src, u2=u[:, 2:4])
        negs = self.negative_sample(gen, (n_negs,), u2=u[:n_negs, 4:6])
        return src, pos, negs

    def draw_edge_batches_hoisted(self, gen: torch.Generator, batch: int,
                                  group: int, n_negs: int, steps: int):
        """The draws of ``steps`` grouped edge batches in one shot, the law
        of ``steps`` draw_edge_batch_grouped calls. Returns (src, pos, negs)
        shaped (steps, batch), (steps, batch), (steps, n_negs); groups of
        ``group`` consecutive elements share a source, the first pos of a
        group comes from the edge table. Needs the edge table and batch %
        group == 0."""
        total = batch * steps
        bg = total // group
        u = self._uniform(gen, (total, 4))
        src_small, pos0 = self.edge_sample(gen, (bg,), u2=u[:bg, 0:2])
        src = torch.repeat_interleave(src_small, group)
        # the [indptr, degree] rows are a function of src: gather them at
        # the source count and repeat, as the JAX package does
        meta = torch.repeat_interleave(self.vert_meta[src_small], group,
                                       dim=0)
        pos = self._context_of(src, meta, u[:, 2:4])
        pos[::group] = pos0
        nt = n_negs * steps
        if bg + nt <= total:
            u_neg = u[bg:bg + nt, 0:2]  # rows bg.. of cols 0:2 are unused
        else:
            u_neg = self._uniform(gen, (nt, 2))
        negs = self.negative_sample(gen, (nt,), u2=u_neg)
        return (src.reshape(steps, batch), pos.reshape(steps, batch),
                negs.reshape(steps, n_negs))

    def draw_edge_batch_grouped(self, gen: torch.Generator, batch: int,
                                group: int, n_negs: int):
        """batch // group (src, pos_0) pairs from the edge table, then
        group - 1 more contexts per source by its sub-table; src in repeat
        layout (what sgns_shared_negs_step's ``src_group`` expects). Needs
        the edge table."""
        bg = batch // group
        u = self._uniform(gen, (batch, 4))
        src_small, pos0 = self.edge_sample(gen, (bg,), u2=u[:bg, 0:2])
        src = torch.repeat_interleave(src_small, group)
        pos = self.target_sample(gen, src, u2=u[:, 2:4])
        pos[::group] = pos0
        if bg + n_negs <= batch:
            u_neg = u[bg:bg + n_negs, 0:2]
        else:
            u_neg = self._uniform(gen, (n_negs, 2))
        negs = self.negative_sample(gen, (n_negs,), u2=u_neg)
        return src, pos, negs
