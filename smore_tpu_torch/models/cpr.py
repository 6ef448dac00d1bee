"""CPR (cross-domain preference ranking) and TPR (text-aware preference
ranking).

Port of ``smore_tpu/models/cpr.py``:

  - CPR: two graphs (target + source domain). User representation = MEAN
    of {user row, the user's target item rows, its source item rows};
    margin-BPR on the TARGET domain only (source items act through the
    aggregation); L2 user_reg / item_reg. Three save files.
  - TPR: user-item graph + item-word graph. Item representation =
    (1-w)*item + w*MEAN(words); BPR over enriched items with lambda L2;
    saves the user / item / word tables.

As in the JAX package, a fixed-size uniform sample of S neighbours (drawn
by the sampler's per-vertex tables) estimates each mean so that shapes
stay static, and the gradient is that of the whole loss: here
``torch.autograd`` on the gathered rows (duplicates sum), every delta
computed before the first in-place write, then ``alpha * grad`` applied
to every table.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from smore_tpu_torch.graph.graph import Graph
from smore_tpu_torch.io.embeddings import save_embeddings
from smore_tpu_torch.models.base import (
    INIT_STREAM,
    PairModelBase,
    clamp_batch,
    draw_update_step,
    init_embedding,
)
from smore_tpu_torch.sampling.tables import SamplerTables


def _sample_neighbors(tables: SamplerTables, vids: torch.Tensor, S: int,
                      gen: Optional[torch.Generator] = None,
                      u: Optional[torch.Tensor] = None):
    """S independent one-hop draws per vid (uniforms ``u`` (..., S, 2), or
    drawn from ``gen``) and a mask, 0 for isolated vids."""
    if u is None:
        u = tables._uniform(gen, tuple(vids.shape) + (S, 2))
    deg = tables.vert_meta[vids][..., 1]
    nbrs = tables.target_sample(
        None, vids[..., None].expand(tuple(vids.shape) + (S,)), u2=u)
    return nbrs, (deg > 0).to(torch.float32)


def _sgd(state, idx_grads, alpha) -> None:
    """table -= alpha * grad, in place, for [(table name, ids, grads of the
    gathered rows), ...]."""
    for name, idx, g in idx_grads:
        state[name].index_add_(0, idx, g * (-alpha))


class CPR(PairModelBase):
    def __init__(self, target: Graph, source: Graph, seed: int = 0,
                 user_reg: float = 0.01, item_reg: float = 0.01,
                 margin: float = 1.0, agg_samples: int = 8,
                 device: torch.device | str = "cuda"):
        super().__init__(target, seed, device)
        self.target = target
        self.source = source
        self.user_reg = user_reg
        self.item_reg = item_reg
        self.margin = margin
        self.agg_samples = agg_samples

    @classmethod
    def load_domains(cls, target_path: str, source_path: str,
                     undirected: bool = True, **kw):
        return cls(Graph.load_edge_list(target_path, undirected=undirected),
                   Graph.load_edge_list(source_path, undirected=undirected),
                   **kw)

    def init(self, dim: int) -> None:
        self.dim = dim
        n_user = max(self.target.n_vertices, self.source.n_vertices)
        gen = self._generator(INIT_STREAM)
        self.state = {
            "user": init_embedding(gen, n_user, dim, device=self.device),
            "target": init_embedding(gen, self.target.n_vertices, dim,
                                     device=self.device),
            "source": init_embedding(gen, self.source.n_vertices, dim,
                                     device=self.device),
        }

    def _make_ctx(self):
        return (SamplerTables.build(self.target, device=self.device),
                SamplerTables.build(self.source, device=self.device))

    def _make_draw(self, batch: int):
        """draw(ctx, gen, u=None) -> (uid, pos, neg, t_nbrs, t_m, s_nbrs,
        s_m); ``u`` the uniforms ((B, 2) x 3, (B, S, 2) x 2) of the JAX
        step's five keys, or None to draw them from ``gen``."""
        S = self.agg_samples

        def draw(ctx, gen, u=None):
            t_tab, s_tab = ctx
            if u is None:
                u = (None,) * 5
            uid = t_tab.source_sample(gen, (batch,), u2=u[0])
            pos = t_tab.target_sample(gen, uid, u2=u[1])
            neg = t_tab.negative_sample(gen, (batch,), u2=u[2])
            t_nbrs, t_m = _sample_neighbors(t_tab, uid, S, gen, u[3])
            # the user's row in the source graph by its target id, as the
            # JAX package draws it (clamped into the source graph)
            s_vid = torch.clamp(uid, max=s_tab.n_vertices - 1)
            s_nbrs, s_m = _sample_neighbors(s_tab, s_vid, S, gen, u[4])
            return uid, pos, neg, t_nbrs, t_m, s_nbrs, s_m

        return draw

    def _make_update(self):
        S = self.agg_samples
        margin = self.margin
        u_reg, i_reg = self.user_reg, self.item_reg

        def update(state, x, alpha):
            uid, pos, neg, t_nbrs, t_m, s_nbrs, s_m = x
            B = uid.shape[0]
            t_ids = torch.cat([t_nbrs.reshape(-1), pos, neg])
            with torch.enable_grad():
                uvec = state["user"][uid].requires_grad_()
                t_all = state["target"][t_ids].requires_grad_()
                s_rows = state["source"][s_nbrs].requires_grad_()
                t_rows = t_all[:B * S].reshape(B, S, -1)
                pi, ni = t_all[B * S:B * S + B], t_all[B * S + B:]
                # mean over {user} + sampled target + sampled source items
                total = 1.0 + t_m * S + s_m * S
                agg = (uvec + t_rows.sum(1) * t_m[:, None]
                       + s_rows.sum(1) * s_m[:, None]) / total[:, None]
                diff = (agg * (pi - ni)).sum(-1)
                # margin BPR: active when diff < margin, softplus grad shape
                active = (diff < margin).to(torch.float32).detach()
                loss = (F.softplus(-(diff - margin)) * active).sum()
                reg = u_reg * (uvec * uvec).sum() + i_reg * (
                    (pi * pi).sum() + (ni * ni).sum())
                g_u, g_t, g_s = torch.autograd.grad(loss + reg,
                                                    [uvec, t_all, s_rows])
            _sgd(state, [("user", uid, g_u), ("target", t_ids, g_t),
                         ("source", s_nbrs.reshape(-1),
                          g_s.reshape(B * S, -1))], alpha)
            return state, torch.zeros((), device=uid.device)

        return update

    def train(self, update_times: float = 10, alpha: float = 0.025,
              batch: int = 4096, steps_per_call: int = 64,
              collision: str = "sum", verbose: bool = True,
              checkpoint: str = None, checkpoint_every: int = 1,
              resume: bool = True) -> None:
        batch = clamp_batch(
            min(self.target.n_vertices, self.source.n_vertices), batch)
        self.set_checkpoint(checkpoint, checkpoint_every, resume)
        self.state = self._drive(
            draw_update_step(self._make_draw(batch), self._make_update()),
            self._make_ctx(), batch, alpha, int(update_times * 1_000_000),
            steps_per_call, verbose)

    def save_weights(self, user_file: str, target_file: str,
                     source_file: str) -> None:
        n_user = self.state["user"].shape[0]
        user_names = [
            self.target.names[i] if i < self.target.n_vertices else f"_u{i}"
            for i in range(n_user)
        ]
        save_embeddings(user_file, user_names,
                        self.state["user"].cpu().numpy())
        save_embeddings(target_file, self.target.names,
                        self.state["target"].cpu().numpy())
        save_embeddings(source_file, self.source.names,
                        self.state["source"].cpu().numpy())


class TPR(PairModelBase):
    def __init__(self, ui: Graph, iw: Graph, seed: int = 0,
                 text_weight: float = 0.3, lam: float = 0.01,
                 agg_samples: int = 8, device: torch.device | str = "cuda"):
        super().__init__(ui, seed, device)
        self.ui = ui
        self.iw = iw
        self.text_weight = text_weight
        self.lam = lam
        self.agg_samples = agg_samples

    @classmethod
    def load_graphs(cls, ui_path: str, iw_path: str,
                    undirected: bool = True, **kw):
        return cls(Graph.load_edge_list(ui_path, undirected=undirected),
                   Graph.load_edge_list(iw_path, undirected=undirected),
                   **kw)

    def init(self, dim: int) -> None:
        self.dim = dim
        gen = self._generator(INIT_STREAM)
        self.state = {
            "user": init_embedding(gen, self.ui.n_vertices, dim,
                                   device=self.device),
            "item": init_embedding(gen, self.ui.n_vertices, dim,
                                   device=self.device),
            "word": init_embedding(gen, self.iw.n_vertices, dim,
                                   device=self.device),
        }

    def _make_ctx(self):
        # ui-item id -> iw-graph id by NAME (-1: no words)
        ui2iw = np.array([self.iw.name2id.get(nm, -1) for nm in self.ui.names],
                         dtype=np.int32)
        return (SamplerTables.build(self.ui, device=self.device),
                SamplerTables.build(self.iw, device=self.device),
                torch.from_numpy(ui2iw).to(self.device))

    def _enrich(self, it, words, w_m):
        """(1-w)*item + w*mean(sampled words); the plain item row where
        the item has no words."""
        tw = self.text_weight
        enriched = (1.0 - tw) * it + tw * words.mean(1)
        return torch.where(w_m[:, None] > 0, enriched, it)

    def _make_draw(self, batch: int):
        """draw(ctx, gen, u=None) -> (uid, pos, neg, pw, pw_m, nw, nw_m);
        ``u`` as in CPR's draw."""
        S = self.agg_samples

        def draw(ctx, gen, u=None):
            ui_tab, iw_tab, ui2iw = ctx
            if u is None:
                u = (None,) * 5
            uid = ui_tab.source_sample(gen, (batch,), u2=u[0])
            pos = ui_tab.target_sample(gen, uid, u2=u[1])
            neg = ui_tab.negative_sample(gen, (batch,), u2=u[2])
            p_iw, n_iw = ui2iw[pos], ui2iw[neg]
            pw, pw_m = _sample_neighbors(iw_tab, torch.clamp(p_iw, min=0), S,
                                         gen, u[3])
            nw, nw_m = _sample_neighbors(iw_tab, torch.clamp(n_iw, min=0), S,
                                         gen, u[4])
            return (uid, pos, neg, pw, pw_m * (p_iw >= 0), nw,
                    nw_m * (n_iw >= 0))

        return draw

    def _make_update(self):
        lam = self.lam

        def update(state, x, alpha):
            uid, pos, neg, pw, pw_m, nw, nw_m = x
            B, S = pw.shape
            items = torch.cat([pos, neg])
            words = torch.cat([pw, nw])
            with torch.enable_grad():
                u = state["user"][uid].requires_grad_()
                it = state["item"][items].requires_grad_()
                wd = state["word"][words].requires_grad_()
                pi = self._enrich(it[:B], wd[:B], pw_m)
                ni = self._enrich(it[B:], wd[B:], nw_m)
                diff = (u * (pi - ni)).sum(-1)
                loss = F.softplus(-diff).sum()
                reg = lam * ((u * u).sum() + (pi * pi).sum()
                             + (ni * ni).sum())
                g_u, g_i, g_w = torch.autograd.grad(loss + reg, [u, it, wd])
            _sgd(state, [("user", uid, g_u), ("item", items, g_i),
                         ("word", words.reshape(-1),
                          g_w.reshape(2 * B * S, -1))], alpha)
            return state, torch.zeros((), device=uid.device)

        return update

    def train(self, sample_times: float = 10, alpha: float = 0.025,
              batch: int = 4096, steps_per_call: int = 64,
              collision: str = "sum", verbose: bool = True,
              checkpoint: str = None, checkpoint_every: int = 1,
              resume: bool = True) -> None:
        batch = clamp_batch(min(self.ui.n_vertices, self.iw.n_vertices),
                            batch)
        self.set_checkpoint(checkpoint, checkpoint_every, resume)
        self.state = self._drive(
            draw_update_step(self._make_draw(batch), self._make_update()),
            self._make_ctx(), batch, alpha, int(sample_times * 1_000_000),
            steps_per_call, verbose)

    def save_weights(self, user_file: str, item_file: str,
                     word_file: str) -> None:
        save_embeddings(user_file, self.ui.names,
                        self.state["user"].cpu().numpy())
        save_embeddings(item_file, self.ui.names,
                        self.state["item"].cpu().numpy())
        save_embeddings(word_file, self.iw.names,
                        self.state["word"].cpu().numpy())
