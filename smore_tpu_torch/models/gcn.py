"""GCN, TEXTGCN and TEXTGCNdev: sampled neighbour-sum CBOW models.

Port of ``smore_tpu/models/gcn.py``:

- GCN (reference GCN.cpp): field-0 sources v1, UpdateCBOW(v1, v1): both
  sides sum S independent one-hop draws from v1 (not a walk).
- TEXTGCN (TEXTGCN.cpp): fields 0 = doc, 1 = filtered, 2 = word; v1 a
  field-0 doc, v2 = TargetSample(v1), UpdateCBOW(v2, v1). ``save_weights``
  writes a doc as the SUM of its neighbours' vertex rows, a word as its own
  row, and skips field-1 vertices.
- TEXTGCNdev (TEXTGCNdev.cpp, kernel UpdateCBOWdev): per field-0 user,
  num_events x num_words word draws (user -> event -> word) whose context
  rows sum to w_avg; the LAST event is paired num_events times (a
  reference quirk kept) with w_avg and with the user row; field-1 events
  are the negatives against both. ``save_weights`` writes users from
  ``vertex`` and words from ``context`` and skips events.

The negative sets are uniform over field-1 vertices (over all vertices on a
graph without fields). The shared pool (``shared_negatives``, default 128)
scores one pool against the whole batch. A step's draw takes its uniforms
in the JAX draws' shapes (``draw``'s ``u``), so the tests feed the JAX
package's own, and its update is a separate callable. Plain torch ops: the
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
    draw_update_step,
    init_embedding,
    tiny_graph_pool,
    zeros_embedding,
)
from smore_tpu_torch.ops.community import cbow_step, cbow_step_shared_negs
from smore_tpu_torch.ops.update import scatter_apply
from smore_tpu_torch.sampling.fields import FieldTables

_EPS = 1e-7


class GCN(PairModelBase):
    src_field = 0
    neg_field = 1

    def __init__(self, graph, seed: int = 0,
                 device: torch.device | str = "cuda"):
        super().__init__(graph, seed, device)
        self.walk_steps = 5
        self.reg = 0.01

    def init(self, dim: int) -> None:
        self.dim = dim
        n = self.graph.n_vertices
        self.state = {
            "vertex": init_embedding(self._generator(INIT_STREAM), n, dim,
                                     device=self.device),
            "context": zeros_embedding(n, dim, self.device),
        }
        self.build_sampler()

    def load_field_meta(self, path: str) -> None:
        self.graph.load_field_meta(path)

    def _make_ctx(self):
        """(sampler, field tables by out-degree for the sources, uniform
        field tables for the negatives)."""
        g = self.graph
        src_t = FieldTables.build(g, weights=g.out_degree, device=self.device)
        neg_t = FieldTables.build(g, weights=np.ones(g.n_vertices),
                                  device=self.device)
        return (self.build_sampler(), src_t, neg_t)

    def _neg_fid(self) -> int:
        return self.neg_field if self.graph.n_fields > 1 else 0

    # the anchors of the two CBOW sides: GCN draws one field-0 source for
    # both, TEXTGCN a doc and one of its neighbours
    def _vc_shapes(self, batch: int):
        return [(batch, 2)]

    def _sample_vc(self, tables, src_t, batch: int, u):
        fids = torch.full((batch,), self.src_field, dtype=torch.int32,
                          device=tables.device)
        v1 = src_t.negative_field_sample(None, fids, u2=u[0])
        return v1, v1

    def _uniform_shapes(self, batch, negatives, shared_negatives):
        """The JAX draws' uniform shapes: the anchors, the 2S one-hop draws
        and the negative sets (one pool, or per sample)."""
        S = self.walk_steps
        negs = ((shared_negatives, S, 2) if shared_negatives
                else (batch, negatives, S, 2))
        return self._vc_shapes(batch) + [(batch, 2 * S, 2), negs]

    def _make_draw(self, batch: int, negatives: int, shared_negatives: int):
        """draw(ctx, gen, u=None) -> (vctx (B, S), cctx (B, S), mask (B,),
        negative sets (Kp, S) or (B, K, S)). ``u``: uniforms of
        ``_uniform_shapes``, drawn from ``gen`` when None."""
        S = self.walk_steps
        shapes = self._uniform_shapes(batch, negatives, shared_negatives)
        n_vc = len(self._vc_shapes(batch))
        nf = self._neg_fid()

        def draw(ctx, gen, u: Optional[tuple] = None):
            tables, src_t, neg_t = ctx
            if u is None:
                u = tuple(tables._uniform(gen, s) for s in shapes)
            vert, cont = self._sample_vc(tables, src_t, batch, u[:n_vc])
            # S independent one-hop draws per side, all in one call (the
            # draw is elementwise, so this is the JAX package's S calls)
            both = torch.cat([vert[:, None].expand(batch, S),
                              cont[:, None].expand(batch, S)], 1)
            nbrs = tables.target_sample(None, both, u2=u[n_vc])
            meta = tables.vert_meta
            mask = ((meta[vert][:, 1] > 0).to(torch.float32)
                    * (meta[cont][:, 1] > 0).to(torch.float32))
            fids = torch.full(shapes[-1][:-1], nf, dtype=torch.int32,
                              device=tables.device)
            negs = neg_t.negative_field_sample(None, fids, u2=u[-1])
            return nbrs[:, :S], nbrs[:, S:], mask, negs

        return draw

    def _make_update(self, negatives: int, collision: str,
                     shared_negatives: int):
        reg = self.reg

        def update(state, x, alpha):
            vctx, cctx, mask, negs = x
            if shared_negatives:
                w, loss = cbow_step_shared_negs(
                    state["vertex"], vctx, cctx, negs, alpha,
                    k_equiv=negatives, reg=reg, mask=mask,
                    collision=collision)
            else:
                w, loss = cbow_step(state["vertex"], vctx, cctx, negs, alpha,
                                    reg=reg, mask=mask, collision=collision)
            return {"vertex": w, "context": state["context"]}, loss

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
        reg: float = 0.01,
        alpha: float = 0.025,
        batch: int = 2048,
        steps_per_call: int = 64,
        collision: str = "sum",
        shared_negatives: int = 128,
        verbose: bool = True,
    ) -> None:
        self.walk_steps = walk_steps
        self.reg = reg
        n = self.graph.n_vertices
        # CBOW sums 2S neighbour rows a sample, so the stale-snapshot
        # overshoot starts near batch n / (2S) rather than n
        batch = clamp_batch(max(1, n // (2 * walk_steps)), batch)
        if n <= 4 * walk_steps:
            # a graph smaller than one sample's neighbour bag: "sum"
            # diverges even at batch 1
            collision = "mean"
        shared_negatives = min(tiny_graph_pool(n, shared_negatives), batch)
        self.state = self._drive(
            self._make_step(batch, negative_samples, collision,
                            shared_negatives), self._make_ctx(), batch, alpha,
            int(sample_times * 1_000_000), steps_per_call, verbose)

    def _fields(self) -> np.ndarray:
        g = self.graph
        return (g.fields if g.fields is not None
                else np.zeros(g.n_vertices, int))


class TEXTGCN(GCN):
    """Doc-word CBOW: the vertex side is TargetSample(doc), the context side
    the doc."""

    def _vc_shapes(self, batch: int):
        return [(batch, 2), (batch, 2)]

    def _sample_vc(self, tables, src_t, batch: int, u):
        v1, _ = super()._sample_vc(tables, src_t, batch, u)
        return tables.target_sample(None, v1, u2=u[1]), v1

    def save_weights(self, path: str, table: str = "vertex") -> None:
        """Docs (field 0): the sum of their neighbours' rows; words: their
        own rows; field-1 vertices skipped."""
        g = self.graph
        wv = self.state["vertex"].detach().cpu().numpy()
        fields = self._fields()
        names, rows = [], []
        for vid, nm in enumerate(g.names):
            f = int(fields[vid])
            if f == 1:
                continue
            names.append(nm)
            if f == 0:
                nbrs = g.neighbors(vid)
                rows.append(wv[nbrs].sum(axis=0) if len(nbrs)
                            else np.zeros(self.dim, np.float32))
            else:
                rows.append(wv[vid])
        save_embeddings(path, names, np.asarray(rows, dtype=np.float32))


class TEXTGCNdev(GCN):
    """The user-event-word CBOW variant (fields 0 = user, 1 = event, 2 =
    word): events update in ``vertex``, the w_avg-side error lands on every
    bag word in ``context``, the user row takes the user-side error. Both
    the pool and the per-sample negatives are scored against w_avg and
    against the user row."""

    def __init__(self, graph, seed: int = 0,
                 device: torch.device | str = "cuda"):
        super().__init__(graph, seed, device)
        self.num_events = 5
        self.num_words = 5

    def _uniform_shapes(self, batch, negatives, shared_negatives):
        """The user, the E (1 + Wn) event and word hops, the negatives (one
        pool, or two per sample and negative)."""
        E, Wn = self.num_events, self.num_words
        negs = ((shared_negatives, 2) if shared_negatives
                else (batch, negatives, 2, 2))
        return [(batch, 2), (batch, E * (1 + Wn), 2), negs]

    def _make_draw(self, batch: int, negatives: int, shared_negatives: int):
        """draw(ctx, gen, u=None) -> (user (B,), last event (B,), bags (B,
        E * Wn), negatives (Kp,) or (B, K, 2))."""
        E, Wn = self.num_events, self.num_words
        shapes = self._uniform_shapes(batch, negatives, shared_negatives)
        nf = 1 if self.graph.n_fields > 1 else 0

        def draw(ctx, gen, u: Optional[tuple] = None):
            tables, src_t, neg_t = ctx
            if u is None:
                u = tuple(tables._uniform(gen, s) for s in shapes)
            dev = tables.device
            user = src_t.negative_field_sample(
                None, torch.zeros(batch, dtype=torch.int32, device=dev),
                u2=u[0])
            # hop e*(1+Wn) is event e, the next Wn its words: one call per
            # hop level (the draw is elementwise)
            uh = u[1].reshape(batch, E, 1 + Wn, 2)
            events = tables.target_sample(
                None, user[:, None].expand(batch, E), u2=uh[:, :, 0])
            words = tables.target_sample(
                None, events[:, :, None].expand(batch, E, Wn),
                u2=uh[:, :, 1:])
            fids = torch.full(shapes[2][:-1], nf, dtype=torch.int32,
                              device=dev)
            negs = neg_t.negative_field_sample(None, fids, u2=u[2])
            return user, events[:, -1], words.reshape(batch, E * Wn), negs

        return draw

    def _make_update(self, negatives: int, collision: str,
                     shared_negatives: int):
        E = self.num_events
        reg = self.reg
        K = negatives

        def update(state, x, alpha):
            user, last_ev, bags, negs = x
            wv, wc = state["vertex"], state["context"]
            B, S = bags.shape
            w_avg = wc[bags].sum(1)  # (B, D)
            ev_row = wv[last_ev]
            u_row = wv[user]
            D = w_avg.shape[1]
            f1 = (ev_row * w_avg).sum(-1)
            # (event, w_avg) and (event, user) of label 1, E times
            g1 = 1.0 - torch.sigmoid(f1)
            g2 = 1.0 - torch.sigmoid((ev_row * u_row).sum(-1))
            aE = alpha * E
            d_ev = aE * (g1[:, None] * w_avg + g2[:, None] * u_row
                         - 2 * reg * ev_row)
            back_err = aE * (g1[:, None] * ev_row - reg * w_avg)
            user_err = aE * (g2[:, None] * ev_row - reg * u_row)
            if shared_negatives:
                scale = K / shared_negatives
                nvp = wv[negs]  # (Kp, D)
                gn1 = -torch.sigmoid(w_avg @ nvp.T) * scale  # (B, Kp)
                gn2 = -torch.sigmoid(u_row @ nvp.T) * scale
                back_err = back_err + aE * (gn1 @ nvp)
                user_err = user_err + aE * (gn2 @ nvp)
                d_pool = aE * (gn1.T @ w_avg + gn2.T @ u_row
                               - reg * 2 * B * scale * nvp)
                entries = [(last_ev, d_ev), (user, user_err),
                           (negs, d_pool)]
            else:
                nv = wv[negs]  # (B, K, 2, D)
                n1, n2 = nv[:, :, 0], nv[:, :, 1]
                gn1 = -torch.sigmoid(torch.einsum("bkd,bd->bk", n1, w_avg))
                gn2 = -torch.sigmoid(torch.einsum("bkd,bd->bk", n2, u_row))
                d_n1 = aE * (gn1[..., None] * w_avg[:, None] - reg * n1)
                d_n2 = aE * (gn2[..., None] * u_row[:, None] - reg * n2)
                back_err = back_err + aE * torch.einsum("bk,bkd->bd", gn1, n1)
                user_err = user_err + aE * torch.einsum("bk,bkd->bd", gn2, n2)
                entries = [(last_ev, d_ev), (user, user_err),
                           (negs[:, :, 0].reshape(-1), d_n1.reshape(B * K, D)),
                           (negs[:, :, 1].reshape(-1), d_n2.reshape(B * K, D))]
            loss = -torch.log(torch.sigmoid(f1) + _EPS).mean()
            scatter_apply(wv, entries, collision)
            scatter_apply(wc, [(bags.reshape(-1), back_err[:, None, :].expand(
                B, S, D).reshape(B * S, D))], collision)
            return {"vertex": wv, "context": wc}, loss

        return update

    def train(
        self,
        sample_times: float = 10,
        num_events: int = 5,
        num_words: int = 5,
        negative_samples: int = 5,
        reg: float = 0.01,
        alpha: float = 0.025,
        batch: int = 2048,
        steps_per_call: int = 64,
        collision: str = "sum",
        shared_negatives: int = 128,
        verbose: bool = True,
    ) -> None:
        self.num_events = num_events
        self.num_words = num_words
        self.reg = reg
        n = self.graph.n_vertices
        # the CBOW fan-out lowers the stable batch bound (see GCN.train)
        batch = clamp_batch(max(1, n // (num_events + num_words)), batch)
        if n <= num_events * num_words:
            # a word bag bigger than the graph: "sum" diverges at batch 1
            collision = "mean"
        shared_negatives = min(tiny_graph_pool(n, shared_negatives), batch)
        self.state = self._drive(
            self._make_step(batch, negative_samples, collision,
                            shared_negatives), self._make_ctx(), batch, alpha,
            int(sample_times * 1_000_000), steps_per_call, verbose)

    def save_weights(self, path: str, table: str = "vertex") -> None:
        """Users (field 0) from ``vertex``, words from ``context``, events
        (field 1) skipped; the header counts the rows written."""
        g = self.graph
        wv = self.state["vertex"].detach().cpu().numpy()
        wc = self.state["context"].detach().cpu().numpy()
        fields = self._fields()
        names, rows = [], []
        for vid, nm in enumerate(g.names):
            f = int(fields[vid])
            if f == 1:
                continue
            names.append(nm)
            rows.append(wv[vid] if f == 0 else wc[vid])
        save_embeddings(path, names, np.asarray(rows, dtype=np.float32))
