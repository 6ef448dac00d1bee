"""SNE: signed network embedding.

Port of ``smore_tpu/models/sne.py``. Dual source / target tables; the
reference processes every positive edge, then every negative edge, each
``samples_per_edge`` times per epoch. One step here takes a batch of each:

  positive edges (u, v): the SGNS update (pull, label 1) with K uniform
    random vertices pushed (label 0)
  negative edges (u, v): push (label 0, weight beta) with K uniform random
    vertices PULLED (label 1, weight beta)

The negative-edge half gathers its rows AFTER the positive half has
written, and computes all three of its deltas before either scatter.
``save_weights`` writes [source | target] per vertex.
"""

from __future__ import annotations

import numpy as np
import torch

from smore_tpu_torch.graph.signed import SignedNetwork
from smore_tpu_torch.io.embeddings import save_embeddings
from smore_tpu_torch.models.base import (
    INIT_STREAM,
    PairModelBase,
    clamp_batch,
    draw_update_step,
    init_embedding,
)
from smore_tpu_torch.ops.update import scatter_apply, sgns_step


class SNE(PairModelBase):
    def __init__(self, net: SignedNetwork, seed: int = 0, beta: float = 1.0,
                 negative_samples: int = 5,
                 device: torch.device | str = "cuda"):
        super().__init__(net, seed, device)
        self.net = net
        self.beta = beta
        self.negative_samples = negative_samples

    @classmethod
    def load_edge_list(cls, path: str, undirected: bool = True, **kw):
        return cls(SignedNetwork.load_edge_list(path, undirected), **kw)

    def init(self, dim: int) -> None:
        self.dim = dim
        n = self.net.n_vertices
        gen = self._generator(INIT_STREAM)
        self.state = {
            "source": init_embedding(gen, n, dim, device=self.device),
            "target": init_embedding(gen, n, dim, device=self.device),
        }

    def _edges(self):
        """(pos_src, pos_dst, neg_src, neg_dst) on the device."""
        net = self.net

        def dev(a):
            return torch.from_numpy(np.asarray(a, dtype=np.int32)).to(
                self.device)

        return (dev(net.pos_src), dev(net.pos_dst), dev(net.neg_src),
                dev(net.neg_dst))

    def _make_draw(self, batch: int):
        """draw(ctx, gen) -> (u_p, v_p, negs (B, K), u_n, v_n, rand_v (B,
        K)): positive and negative edges and the uniform random vertices;
        a half with no edges draws nothing (None)."""
        K = self.negative_samples
        n = self.net.n_vertices
        n_pos, n_neg = len(self.net.pos_src), len(self.net.neg_src)

        def draw(ctx, gen):
            ps, pd, ns, nd = ctx
            dev = ps.device
            out = [None] * 6
            if n_pos > 0:
                i = torch.randint(0, n_pos, (batch,), generator=gen,
                                  device=dev)
                out[0:3] = ps[i], pd[i], torch.randint(
                    0, n, (batch, K), generator=gen, device=dev)
            if n_neg > 0:
                j = torch.randint(0, n_neg, (batch,), generator=gen,
                                  device=dev)
                out[3:6] = ns[j], nd[j], torch.randint(
                    0, n, (batch, K), generator=gen, device=dev)
            return tuple(out)

        return draw

    def _make_update(self, collision: str):
        beta = self.beta

        def update(state, x, alpha):
            u_p, v_p, negs, u_n, v_n, rand_v = x
            ws, wt = state["source"], state["target"]
            l1 = l2 = torch.zeros((), device=ws.device)
            if u_p is not None:
                # positive edges: standard SGNS (uniform negatives)
                ws, wt, l1 = sgns_step(ws, wt, u_p, v_p, negs, alpha,
                                       collision=collision)
            if u_n is not None:
                # negative edges: push the endpoints apart (label 0) and
                # pull random vertices (label 1), both scaled by beta
                su, tv, tr = ws[u_n], wt[v_n], wt[rand_v]  # tr (B, K, D)
                ab = alpha * beta
                s_edge = torch.sigmoid((su * tv).sum(-1))
                g_edge = (0.0 - s_edge) * ab
                g_rand = (1.0 - torch.sigmoid(
                    torch.einsum("bd,bkd->bk", su, tr))) * ab
                d_su = g_edge[:, None] * tv + torch.einsum(
                    "bk,bkd->bd", g_rand, tr)
                d_tv = g_edge[:, None] * su
                d_tr = g_rand[:, :, None] * su[:, None, :]
                B, K, D = d_tr.shape
                scatter_apply(wt, [(v_n, d_tv),
                                   (rand_v.reshape(-1),
                                    d_tr.reshape(B * K, D))], collision)
                scatter_apply(ws, [(u_n, d_su)], collision)
                l2 = -torch.log(1.0 - s_edge + 1e-7).mean()
            return {"source": ws, "target": wt}, l1 + l2

        return update

    def _make_step(self, batch: int, collision: str):
        if len(self.net.pos_src) == 0 and len(self.net.neg_src) == 0:
            raise ValueError(
                "signed network has no edges -- accepted sign tokens are "
                "+1/1/pos/positive, -1/neg/negative, or any numeric value")
        return draw_update_step(self._make_draw(batch),
                                self._make_update(collision))

    def train(
        self,
        epochs: int = 10,
        samples_per_edge: int = 1,
        alpha: float = 0.025,
        batch: int = 4096,
        steps_per_call: int = 32,
        collision: str = "sum",
        verbose: bool = True,
        checkpoint: str = None,
        checkpoint_every: int = 1,
        resume: bool = True,
    ) -> None:
        total = (epochs * samples_per_edge
                 * (len(self.net.pos_src) + len(self.net.neg_src)))
        batch = clamp_batch(self.net.n_vertices, batch)
        self.set_checkpoint(checkpoint, checkpoint_every, resume)
        self.state = self._drive(
            self._make_step(batch, collision), self._edges(),
            batch * 2,  # one positive and one negative edge per slot
            alpha, max(total, 1), steps_per_call, verbose)

    def save_weights(self, path: str) -> None:
        out = torch.cat([self.state["source"], self.state["target"]], dim=1)
        save_embeddings(path, self.net.names, out.cpu().numpy())

    def predict_sign(self, u: int, v: int) -> float:
        """Signed-link score dot(source[u], target[v]) (reference
        PredictSign); > 0 predicts a positive edge."""
        return float(self.state["source"][u] @ self.state["target"][v])

    def compute_balance_ratio(self) -> float:
        """Fraction of edges whose predicted sign matches the observed
        sign."""
        ws = self.state["source"].cpu().numpy()
        wt = self.state["target"].cpu().numpy()
        net = self.net
        correct = total = 0
        if len(net.pos_src):
            s = np.sum(ws[net.pos_src] * wt[net.pos_dst], axis=1)
            correct += int((s > 0).sum())
            total += len(s)
        if len(net.neg_src):
            s = np.sum(ws[net.neg_src] * wt[net.neg_dst], axis=1)
            correct += int((s < 0).sum())
            total += len(s)
        return correct / total if total else 0.0
