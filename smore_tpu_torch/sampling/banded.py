"""Band-stratified edge sampling: the large-table path.

Port of ``smore_tpu/sampling/banded.py``. The vertex rows are cut into
BANDS of ``band_size`` rows; every micro-step draws one STRATUM (a source
band and a context band, ``two_d``) by its share of the edge-sample mass,
then its whole batch of (src, pos) pairs conditioned on that stratum, so a
step's updates touch one band of each table. ``P(stratum) * P(pair |
stratum)`` telescopes to the reference's joint edge law, so the per-sample
law is exact; only which samples share a step changes.

``BandedTables.build``, ``build_stream`` and ``build_neg_bands`` are host
numpy, bit-equal to the JAX package's; their arrays then live on ``device``
as tensors. The draws (``draw_banded_stream``, ``draw_banded_batches_hoisted``,
``draw_banded_batch``, ``draw_banded_block``, ``draw_neg_banded``) run on the
device from a ``torch.Generator``: its numbers differ from JAX's threefry,
so they are held to the law, not to the bits.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from smore_tpu_torch.graph.graph import Graph
from smore_tpu_torch.sampling.alias import build_alias, build_alias_segmented
from smore_tpu_torch.sampling.tables import (
    _negative_distribution,
    _vertex_distribution,
    build_negative_table,
)

# edge_pa columns (slot edge | alias edge): 0 prob | 1 src 2 dst | 3 asrc
# 4 adst | 5..7 zero pad, as in the JAX package
_EDGE_COLS = 8

# The JAX package's band sizes (small powers of two times odd factors),
# kept so both packages cut the same strata. MULTI_BAND_SIZE, the
# multiblock path's band, is the one the quality gate was measured at
# (batch 2048 per stratum visit at band 16400); FUSED_BAND_SIZE is the
# fused route's (batch 4096 per visit).
DEFAULT_BAND_SIZE = 32776
FUSED_BAND_SIZE = 16392
MULTI_BAND_SIZE = 16400


@dataclass
class BandedTables:
    """Band-stratified edge sampler; every tensor lives on ``device``.

    band_pa   (n_strata, 2) f32 [prob, alias]: stratum mass alias table
    band_meta (n_strata, 2) i32 [slot offset, slot count]
    edge_pa   (E, 8) f32: banded slot layout (see ``_EDGE_COLS``)
    edge_seg  (E, 4) f32 [seg_off, seg_deg, aseg_off, aseg_deg]: the
              (src, stratum) segments, read by grouped draws
    ctx_pa    (E, 4) f32 [prob, dst, alias_dst, 0]: within-segment context
              alias table
    neg_pa    (N, 2) f32: the global (unbanded) negative alias table
    stream / stream_meta: optional pre-sampled per-stratum edge stream
              (``build_stream``), entries packed (src_l << 16) | pos_l
    neg_band_pa / neg_local_pa / nb2: optional banded negative law
              (``build_neg_bands``): (Np / nb2, 2) f32 [prob, alias] over
              nb2-row WINDOWS by their deg^0.75 mass, and (Np, 2) f32
              [prob, window-local alias] per window (padded rows carry no
              mass)
    """

    band_pa: torch.Tensor
    band_meta: torch.Tensor
    edge_pa: torch.Tensor
    edge_seg: torch.Tensor
    ctx_pa: torch.Tensor
    neg_pa: torch.Tensor
    band_size: int
    n_rows_padded: int
    n_bands: int
    two_d: bool
    stream: torch.Tensor | None = None
    stream_meta: torch.Tensor | None = None
    neg_band_pa: torch.Tensor | None = None
    neg_local_pa: torch.Tensor | None = None
    nb2: int = 0

    @property
    def device(self) -> torch.device:
        return self.band_pa.device

    @staticmethod
    def build(
        g: Graph,
        band_size: int = DEFAULT_BAND_SIZE,
        vertex_method: str = "out_degrees",
        power: float = 0.75,
        two_d: bool = True,
        device: torch.device | str = "cuda",
    ) -> "BandedTables":
        n, e = g.n_vertices, g.n_edges
        if e == 0 or e >= (1 << 24) or n >= (1 << 24):
            raise ValueError(
                "banded tables need 0 < edges < 2^24 and vertices < 2^24 "
                "(float32-exact vids)"
            )
        n_bands = -(-n // band_size)
        n_pad = n_bands * band_size

        src = np.repeat(np.arange(n, dtype=np.int64), np.diff(g.indptr))
        dst = np.asarray(g.indices, dtype=np.int64)
        w = np.asarray(g.weights, dtype=np.float64)
        if two_d:
            strat_of = (src // band_size) * n_bands + dst // band_size
            n_strata = n_bands * n_bands
        else:
            strat_of = dst // band_size
            n_strata = n_bands

        # slots sorted by (stratum, src): strata contiguous, (src, stratum)
        # segments contiguous within each stratum
        order = np.lexsort((src, strat_of))
        bsrc, bdst, bw = src[order], dst[order], w[order]
        bstrat = strat_of[order]

        # joint edge-sample mass per slot: P_v(src) * w^0.75 / Z_src
        vmass = _vertex_distribution(g, vertex_method).astype(np.float64)
        vmass = np.where(vmass > 0, vmass**power, 0.0)
        w_pow = np.where(bw > 0, bw**power, 0.0)
        z = np.zeros(n, dtype=np.float64)
        np.add.at(z, bsrc, w_pow)
        jw = (vmass[bsrc] / max(vmass.sum(), 1e-300)) * (
            w_pow / np.maximum(z[bsrc], 1e-300)
        )

        strat_off = np.searchsorted(bstrat, np.arange(n_strata))
        strat_cnt = np.diff(np.append(strat_off, e)).astype(np.int64)

        mass = np.zeros(n_strata, dtype=np.float64)
        np.add.at(mass, bstrat, jw)
        bp, ba = build_alias(mass, power=1.0)
        ba = np.where(ba < 0, np.arange(n_strata), ba)

        # per-stratum edge alias tables (local alias -> global slot)
        strat_indptr = np.append(strat_off, e).astype(np.int64)
        ep, ea_local = build_alias_segmented(jw, strat_indptr, power=1.0)
        slot = np.arange(e, dtype=np.int64)
        ea = np.where(ea_local >= 0, strat_off[bstrat] + ea_local, slot)

        # (src, stratum) segments: runs of equal src within a stratum
        change = np.empty(e, dtype=bool)
        change[0] = True
        change[1:] = (bsrc[1:] != bsrc[:-1]) | (bstrat[1:] != bstrat[:-1])
        seg_start_idx = np.flatnonzero(change)
        seg_id_of_slot = np.cumsum(change) - 1
        seg_off = seg_start_idx[seg_id_of_slot]
        seg_indptr = np.append(seg_start_idx, e).astype(np.int64)
        seg_deg = np.diff(seg_indptr)[seg_id_of_slot]

        cp, ca_local = build_alias_segmented(bw, seg_indptr, power=power)
        ca = np.where(ca_local >= 0, seg_off + ca_local, slot)

        edge_pa = np.zeros((e, _EDGE_COLS), dtype=np.float32)
        edge_pa[:, 0] = ep
        edge_pa[:, 1] = bsrc
        edge_pa[:, 2] = bdst
        edge_pa[:, 3] = bsrc[ea]
        edge_pa[:, 4] = bdst[ea]
        edge_seg = np.zeros((e, 4), dtype=np.float32)
        edge_seg[:, 0] = seg_off
        edge_seg[:, 1] = seg_deg
        edge_seg[:, 2] = seg_off[ea]
        edge_seg[:, 3] = seg_deg[ea]
        ctx_pa = np.zeros((e, 4), dtype=np.float32)
        ctx_pa[:, 0] = cp
        ctx_pa[:, 1] = bdst
        ctx_pa[:, 2] = bdst[ca]

        def dev(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=device, dtype=dtype)

        return BandedTables(
            band_pa=dev(np.stack([bp, ba], 1), torch.float32),
            band_meta=dev(np.stack([strat_off, strat_cnt], 1), torch.int32),
            edge_pa=dev(edge_pa, torch.float32),
            edge_seg=dev(edge_seg, torch.float32),
            ctx_pa=dev(ctx_pa, torch.float32),
            neg_pa=build_negative_table(g, device=device),
            band_size=band_size,
            n_rows_padded=n_pad,
            n_bands=n_bands,
            two_d=two_d,
        )

    def build_stream(self, mult: int = 4, min_len: int = 4096,
                     seed: int = 0) -> "BandedTables":
        """Pre-sample per-stratum edge STREAMS on the host (numpy, seeded,
        bit-equal to the JAX package): for each stratum max(mult * cnt,
        min_len) iid draws from its exact alias law, so a micro-step reads
        one contiguous window instead of gathering a random edge row per
        sample. Entries are packed band-local as (src_l << 16) | pos_l,
        which needs band_size < 32768."""
        if self.band_size >= (1 << 15):
            raise ValueError("edge stream needs band_size < 32768")
        rng = np.random.default_rng(seed)
        meta = self.band_meta.cpu().numpy().astype(np.int64)
        off, cnt = meta[:, 0], meta[:, 1]
        ns = len(cnt)
        ep = self.edge_pa.cpu().numpy().astype(np.float64)
        prob, esrc, edst = ep[:, 0], ep[:, 1], ep[:, 2]
        asrc, adst = ep[:, 3], ep[:, 4]

        L = np.where(cnt > 0, np.maximum(mult * cnt, min_len), 0)
        soff = np.concatenate([[0], np.cumsum(L)])[:-1]
        total = int(L.sum())
        sid = np.repeat(np.arange(ns), L)
        u1 = rng.random(total)
        u2 = rng.random(total)
        r = (u1 * cnt[sid]).astype(np.int64)
        slot = off[sid] + np.minimum(r, np.maximum(cnt[sid] - 1, 0))
        take = u2 < prob[slot]
        src = np.where(take, esrc[slot], asrc[slot]).astype(np.int64)
        pos = np.where(take, edst[slot], adst[slot]).astype(np.int64)
        if self.two_d:
            sb = (sid // self.n_bands) * self.band_size
            db = (sid % self.n_bands) * self.band_size
        else:
            sb = np.zeros(total, np.int64)
            db = sid * self.band_size
        packed = ((src - sb) << 16) | (pos - db)
        self.stream = torch.from_numpy(packed.astype(np.int32)).to(self.device)
        self.stream_meta = torch.from_numpy(
            np.stack([soff, L], 1).astype(np.int32)).to(self.device)
        return self

    def build_neg_bands(self, g: Graph, negative_method: str = "degrees",
                        power: float = 0.75,
                        nb2: int = 400) -> "BandedTables":
        """Stratify the global negative law by nb2-row WINDOWS (host numpy,
        bit-equal to the JAX package): P(neg = v) = deg(v)^0.75 / Z is
        P(window) * P(v | window), P(window) the window's share of the
        mass, so a micro-step that draws all its negatives from one window
        keeps the exact per-sample law (only which negatives share a step
        changes). nb2 divides band_size, so a window lies inside one
        context band, and is a multiple of 16, as the TPU kernel needed."""
        if self.band_size % nb2 or nb2 % 16:
            raise ValueError(f"nb2 {nb2} must divide band_size "
                             f"{self.band_size} and be a multiple of 16")
        mass = _negative_distribution(g, negative_method).astype(np.float64)
        mass = np.where(mass > 0, mass**power, 0.0)
        pad = np.zeros(self.n_rows_padded, dtype=np.float64)
        pad[: len(mass)] = mass
        n_win = self.n_rows_padded // nb2
        win_mass = pad.reshape(n_win, nb2).sum(1)
        bp, ba = build_alias(win_mass, power=1.0)
        ba = np.where(ba < 0, np.arange(n_win), ba)
        indptr = np.arange(n_win + 1, dtype=np.int64) * nb2
        lp, la = build_alias_segmented(pad, indptr, power=1.0)
        slot_local = np.arange(self.n_rows_padded, dtype=np.int64) % nb2
        la = np.where(la >= 0, la, slot_local)  # window-local alias ids
        self.neg_band_pa = torch.from_numpy(
            np.stack([bp, ba], 1).astype(np.float32)).to(self.device)
        self.neg_local_pa = torch.from_numpy(
            np.stack([lp, la], 1).astype(np.float32)).to(self.device)
        self.nb2 = nb2
        return self

    # ------------------------------------------------------------------ #
    def draw_neg_banded(self, gen: torch.Generator, n_negs: int,
                        steps: int):
        """Per micro-step one negative WINDOW by its mass share, then n_negs
        iid window-local draws from its conditional law
        (``build_neg_bands``). Returns (nb (steps,) window indices, negs_l
        (steps, n_negs) window-LOCAL rows), both i32."""
        ub = torch.rand(steps, 2, generator=gen, device=self.device)
        nw = self.neg_band_pa.shape[0]
        i = torch.clamp((ub[:, 0] * nw).to(torch.int32), max=nw - 1)
        brow = self.neg_band_pa[i]
        nb = torch.where(ub[:, 1] < brow[:, 0], i, brow[:, 1].to(torch.int32))
        ul = torch.rand(steps, n_negs, 2, generator=gen, device=self.device)
        r = torch.clamp((ul[..., 0] * self.nb2).to(torch.int32),
                        max=self.nb2 - 1)
        rows = self.neg_local_pa[nb[:, None] * self.nb2 + r]
        negs_l = torch.where(ul[..., 1] < rows[..., 0], r,
                             rows[..., 1].to(torch.int32))
        return nb, negs_l

    def _draw_strata(self, gen: torch.Generator, steps: int):
        """One stratum alias draw per micro-step -> (stratum, sb, db), the
        band START rows of the source and context sides."""
        ub = torch.rand(steps, 2, generator=gen, device=self.device)
        ns = self.band_pa.shape[0]
        i = torch.clamp((ub[:, 0] * ns).to(torch.int32), max=ns - 1)
        brow = self.band_pa[i]
        s = torch.where(ub[:, 1] < brow[:, 0], i, brow[:, 1].to(torch.int32))
        if self.two_d:
            sb = (s // self.n_bands) * self.band_size
            db = (s % self.n_bands) * self.band_size
        else:
            sb = torch.zeros_like(s)
            db = s * self.band_size
        return s, sb, db

    def _draw_negatives(self, gen: torch.Generator, steps: int,
                        n_negs: int) -> torch.Tensor:
        """(steps, n_negs) i32 shared negatives from the global deg^0.75
        law (not banded)."""
        un = torch.rand(steps, n_negs, 2, generator=gen, device=self.device)
        n = self.neg_pa.shape[0]
        j = torch.clamp((un[..., 0] * n).to(torch.int32), max=n - 1)
        nrow = self.neg_pa[j]
        return torch.where(un[..., 1] < nrow[..., 0], j,
                           nrow[..., 1].to(torch.int32))

    def draw_banded_stream(self, gen: torch.Generator, batch: int,
                           n_negs: int, steps: int, with_negs: bool = True):
        """Stream-backed draw: per micro-step one stratum alias draw and one
        contiguous window of its pre-sampled stream. Returns (sb, db,
        src_l, pos_l, negs) shaped (steps,), (steps,), (steps, batch),
        (steps, batch), (steps, n_negs), all i32; src_l and pos_l are
        BAND-LOCAL rows. with_negs=False draws no global negatives and
        returns negs=None (the banded-negative route draws its own with
        ``draw_neg_banded``)."""
        s, sb, db = self._draw_strata(gen, steps)
        meta = self.stream_meta[s]
        soff, slen = meta[:, 0], meta[:, 1]
        uo = torch.rand(steps, generator=gen, device=self.device)
        start = soff + (
            uo * torch.clamp(slen - batch + 1, min=1).to(torch.float32)
        ).to(torch.int32)
        # a window that would run past the stream's end is moved back, as
        # the JAX package's dynamic_slice clamps it
        start = torch.clamp(start, 0, self.stream.shape[0] - batch)
        win = start[:, None] + torch.arange(
            batch, dtype=torch.int32, device=self.device)
        packed = self.stream[win]
        src_l = packed >> 16
        pos_l = packed & 0xFFFF
        if not with_negs:
            return sb, db, src_l, pos_l, None
        return sb, db, src_l, pos_l, self._draw_negatives(gen, steps, n_negs)

    def _draw_pairs(self, gen: torch.Generator, s: torch.Tensor,
                    batch: int, group: int, steps: int):
        """(src, pos) (steps, batch) i32 GLOBAL vids drawn inside stratum
        ``s`` ((steps,), or (1,) for one stratum shared by every
        micro-step): per source one within-stratum alias draw over the edge
        slots; group > 1 as in ``draw_banded_batches_hoisted``."""
        bg = batch // group
        meta = self.band_meta[s]
        off, cnt = meta[:, 0], meta[:, 1]
        u = torch.rand(steps, batch, 2 if group == 1 else 4, generator=gen,
                       device=self.device)
        r = (u[:, :bg, 0] * cnt[:, None].to(torch.float32)).to(torch.int32)
        slot = off[:, None] + torch.minimum(
            r, torch.clamp(cnt[:, None] - 1, min=0))
        row = self.edge_pa[slot]
        take = (u[:, :bg, 1] < row[..., 0])[..., None]
        picked = torch.where(take, row[..., 1:3], row[..., 3:5]).to(
            torch.int32)
        src, pos0 = picked[..., 0], picked[..., 1]
        if group == 1:
            return src, pos0
        seg = self.edge_seg[slot]
        segp = torch.where(take, seg[..., 0:2], seg[..., 2:4]).to(
            torch.int32).repeat_interleave(group, dim=1)
        so, sd = segp[..., 0], segp[..., 1]
        src = src.repeat_interleave(group, dim=1)
        rr = (u[..., 2] * sd.to(torch.float32)).to(torch.int32)
        crow = self.ctx_pa[so + torch.minimum(rr, torch.clamp(sd - 1, min=0))]
        pos = torch.where(u[..., 3] < crow[..., 0], crow[..., 1],
                          crow[..., 2]).to(torch.int32)
        pos[:, ::group] = pos0
        return src, pos

    def draw_banded_batches_hoisted(self, gen: torch.Generator, batch: int,
                                    group: int, n_negs: int, steps: int):
        """``steps`` stratified draws in one shot, without a stream: per
        micro-step one stratum, then per source one within-stratum alias
        draw over the edge slots. Returns (sb, db, src, pos, negs) shaped
        (steps,), (steps,), (steps, batch), (steps, batch), (steps,
        n_negs), all i32, with src and pos GLOBAL vids; sb is 0 on 1D
        tables (sources unconstrained).

        group > 1: the slot draw runs on ``batch // group`` sources, src is
        their repeat layout (``group`` consecutive samples per source), the
        first context of each group is the slot's own and the other
        ``group - 1`` are drawn from the source's (src, stratum) segment by
        its within-segment context law."""
        s, sb, db = self._draw_strata(gen, steps)
        src, pos = self._draw_pairs(gen, s, batch, group, steps)
        return sb, db, src, pos, self._draw_negatives(gen, steps, n_negs)

    def draw_banded_block(self, gen: torch.Generator, batch: int, group: int,
                          n_negs: int, steps: int):
        """Band-PERSISTENT block draw: ONE stratum for ``steps`` consecutive
        micro-batches (the held route). Each sample's marginal is still the
        exact joint edge law; only more samples share a stratum. Returns
        (sb, db, src, pos, negs) shaped (), (), (steps, batch), (steps,
        batch), (steps, n_negs), all i32: the band starts stay device
        tensors, shared by every micro-batch; row i is micro-step i's
        draw, laid out as ``draw_banded_batches_hoisted``'s."""
        s, sb, db = self._draw_strata(gen, 1)
        src, pos = self._draw_pairs(gen, s, batch, group, steps)
        return (sb[0], db[0], src, pos,
                self._draw_negatives(gen, steps, n_negs))

    def draw_banded_batch(self, gen: torch.Generator, batch: int, group: int,
                          n_negs: int):
        """One stratified step draw (the per-step route, hoist 1): returns
        (src_band_start (), dst_band_start (), src (batch,), pos (batch,),
        negs (n_negs,)), one micro-step of ``draw_banded_batches_hoisted``
        and the same law."""
        return tuple(x[0] for x in self.draw_banded_batches_hoisted(
            gen, batch, group, n_negs, 1))
