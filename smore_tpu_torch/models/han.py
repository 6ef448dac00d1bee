"""HAN: heterogeneous attention network (the reference's heuristic
variant).

Port of ``smore_tpu/models/han.py``. Per node:

  - per metapath p: ``walk_times`` MetaPathWalk ENDPOINTS act as the
    typed neighbourhood; node-level attention softmax over
    LeakyReLU(a_p . (W_p h_node + W_p h_nbr)); the transformed
    neighbours aggregated by it
  - semantic attention over the metapath aggregates: softmax of
    q . tanh(z_p)
  - heuristic update h_node += lr * sum_p beta_p z_p, then L2-normalised.
    W_p starts near the identity; the attention parameters are never
    trained (as in the reference).

A step of ``batch`` nodes runs as groups of ``inner`` (32) nodes, group g
reading the rows that groups < g wrote (in place here, so each group's
gathers follow the previous group's writes), which brings the batched step
nearer the reference's node-at-a-time updates. The walks do not depend on
the rows, so a step draws the nodes and walks of all its groups at once.
A node drawn twice in a group (draws with replacement) gets the row of its
LAST occurrence: every duplicate writes that row, so the result does not
depend on the order of the writes (the JAX package leaves it unspecified).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional

import numpy as np
import torch

from smore_tpu_torch.graph.hetero import HeteroGraph, HeteroTables
from smore_tpu_torch.io.embeddings import save_embeddings
from smore_tpu_torch.models.base import (
    INIT_STREAM,
    TRAIN_STREAM,
    OwnLoop,
    epoch_calls,
    seeded_generator,
)
from smore_tpu_torch.models.metapath2vec import meta_path_arrays
from smore_tpu_torch.utils.checkpoint import (
    checkpoint_exists,
    load_checkpoint,
    save_checkpoint,
)


def last_occurrence(nodes: torch.Tensor) -> torch.Tensor:
    """For each position i of ``nodes`` (B,), the last position j with
    nodes[j] == nodes[i] (B x B compares; B is a small group)."""
    pos = torch.arange(nodes.shape[0], device=nodes.device)
    eq = nodes[:, None] == nodes[None, :]
    return torch.where(eq, pos[None, :], -1).amax(1)


class HAN(OwnLoop):
    """``device`` holds the tables and every draw: the CUDA card unless
    the caller asks for another. A call is ``steps_per_call`` steps
    (``OwnLoop``: captured once on the card as a CUDA graph and replayed
    for every later call of the ``train()``)."""

    # the steps of a call (None: an epoch's): one, since a capture costs
    # its call's steps and a step's replay already runs at the card's pace
    # (PERF.md)
    steps_per_call: Optional[int] = 1

    def __init__(self, hg: HeteroGraph, seed: int = 0,
                 device: torch.device | str = "cuda"):
        self.hg = hg
        self.seed = seed
        self.device = torch.device(device)
        self.meta_paths: List[List[str]] = []
        self.state: Dict[str, torch.Tensor] = {}
        self.dim = 0
        self.learning_rate = 0.01

    @classmethod
    def load_edge_list(cls, path: str, undirected: bool = True, **kw):
        return cls(HeteroGraph.load_edge_list(path, undirected), **kw)

    def add_meta_path(self, path: List[str]) -> None:
        for t in path:
            if t not in self.hg.type2id:
                raise ValueError(f"unknown node type in meta-path: {t}")
        self.meta_paths.append(path)

    def init(self, dim: int, learning_rate: float = 0.01) -> None:
        self.dim = dim
        self.learning_rate = learning_rate
        n = self.hg.n_vertices
        P = max(1, len(self.meta_paths))
        gen = seeded_generator(self.seed, INIT_STREAM, self.device)
        dev = self.device
        scale = 1.0 / dim

        def centred(*shape):
            return (torch.rand(shape, generator=gen, device=dev) - 0.5) * scale

        eye = torch.eye(dim, device=dev)
        self.state = {
            "embed": centred(n, dim),
            # near-identity transforms
            "W": eye[None].repeat(P, 1, 1) + centred(P, dim, dim) * (
                1 - eye)[None],
            "attn": centred(P, dim),
            "sem": centred(dim),
        }

    def _make_ctx(self):
        pt, pl = meta_path_arrays(self.hg, self.meta_paths, self.device)
        return HeteroTables.build(self.hg, self.device), pt, pl

    def _make_draw(self, batch: int, walk_times: int, walk_steps: int,
                   inner: int = 32):
        """draw(ctx, gen, nodes=None, u=None) -> (nodes (G, bg), ends (G,
        P, Wt, bg), oks (G, P, Wt, bg)): each group's nodes and, per
        metapath and walk, the walk's end and whether it took a step.
        ``nodes`` and the walk uniforms ``u`` (walk_steps, G*P*Wt*bg), in
        (G, P, Wt, bg) order, are drawn from ``gen`` unless given."""
        P = len(self.meta_paths)
        n = self.hg.n_vertices
        G = max(1, batch // max(1, inner))  # groups of bg nodes
        bg = batch // G

        def draw(ctx, gen, nodes=None, u=None):
            tables, pt, pl = ctx
            dev = tables.device
            if nodes is None:
                nodes = torch.randint(0, n, (G, bg), generator=gen,
                                      device=dev, dtype=torch.int32)
            shape = (G, P, walk_times, bg)
            starts = nodes[:, None, None, :].expand(shape).reshape(-1)
            pidx = torch.arange(P, device=dev, dtype=torch.int32)[
                None, :, None, None].expand(shape).reshape(-1)
            walk, valid = tables.metapath_walk(gen, starts, pt, pl, pidx,
                                               walk_steps, u=u)
            # the frozen cursor, and whether the walk took one step
            return (nodes, walk[:, -1].reshape(shape),
                    valid[:, 1].reshape(shape))

        return draw

    def _update_group(self, state, nodes, ends, oks) -> None:
        """One group's update of ``state["embed"]``, in place: nodes (bg,),
        ends / oks (P, Wt, bg)."""
        lr = self.learning_rate
        emb, W = state["embed"], state["W"]
        attn, sem = state["attn"], state["sem"]
        h_node = emb[nodes]  # (bg, D)
        nbrs = ends.permute(2, 0, 1)  # (bg, P, Wt)
        okm = oks.permute(2, 0, 1)
        h_nb = emb[nbrs]  # (bg, P, Wt, D)
        tn = torch.einsum("bd,ped->bpe", h_node, W)  # W_p h_node
        tb = torch.einsum("bpwd,ped->bpwe", h_nb, W)
        score = torch.einsum("pd,bpwd->bpw", attn, tn[:, :, None] + tb)
        score = torch.where(score < 0, 0.01 * score, score)
        score = torch.where(okm > 0, score, -1e9)
        a = torch.softmax(score, dim=2)
        ok_any = (okm.sum(2) > 0).to(torch.float32)  # (bg, P)
        zs = torch.einsum("bpw,bpwe->bpe", a, tb) * ok_any[:, :, None]
        s_score = torch.einsum("d,bpd->bp", sem, torch.tanh(zs))
        s_score = torch.where(ok_any > 0, s_score, -1e9)
        beta = torch.softmax(s_score, dim=1)
        final = torch.einsum("bp,bpd->bd", beta * ok_any, zs)
        new = h_node + lr * final
        nrm = torch.sqrt((new * new).sum(1, keepdim=True))
        new = new / torch.clamp(nrm, min=1e-12)
        # every duplicate writes its last occurrence's row
        emb[nodes.to(torch.int64)] = new[last_occurrence(nodes)]

    def _make_step(self, batch: int, walk_times: int, walk_steps: int,
                   inner: int = 32):
        """step(state, ctx, gen): one batch, group by group, in place."""
        draw = self._make_draw(batch, walk_times, walk_steps, inner)

        def step(state, ctx, gen):
            nodes, ends, oks = draw(ctx, gen)
            for g in range(nodes.shape[0]):
                self._update_group(state, nodes[g], ends[g], oks[g])
            return state

        return step

    def train(self, walk_times: int = 5, walk_steps: int = 4,
              epochs: int = 5, batch: int = 512,
              verbose: bool = True, checkpoint: str = None,
              checkpoint_every: int = 1, resume: bool = True) -> None:
        """``n // batch + 1`` steps an epoch; checkpoint: a directory, the
        tables, the generator's state and the epoch counter saved every
        ``checkpoint_every`` epochs and after the last, resumed from when
        ``resume``."""
        if not self.meta_paths:
            raise ValueError("no meta-paths defined")
        step = self._make_step(batch, walk_times, walk_steps)
        ctx = self._make_ctx()
        gen = seeded_generator(self.seed, TRAIN_STREAM, self.device)
        n = self.hg.n_vertices
        steps_per_epoch = max(1, n // batch + 1)
        state = self.state
        start_ep = 0
        if checkpoint and resume and checkpoint_exists(checkpoint):
            loaded, done_ep, extra = load_checkpoint(checkpoint)
            for k, v in state.items():
                v.copy_(loaded[k])
            gen.set_state(extra["gen"])
            start_ep = min(int(done_ep), epochs)

        def call(size: int) -> None:
            for _ in range(size):
                step(state, ctx, gen)

        calls = self._new_calls(gen)
        try:
            for ep in range(start_ep, epochs):
                for size in epoch_calls(steps_per_epoch, self.steps_per_call):
                    calls(functools.partial(call, size), size)
                if verbose:
                    print(f"\tepoch {ep + 1}/{epochs}", end="\r", flush=True)
                if checkpoint and ((ep + 1) % max(1, checkpoint_every) == 0
                                   or ep + 1 == epochs):
                    save_checkpoint(checkpoint, state, step=ep + 1,
                                    extra={"gen": gen.get_state()})
        finally:
            calls.close()
        if verbose:
            print()

    def load_state_numpy(self, tables: Dict[str, np.ndarray]) -> None:
        """Take ``{"embed", "W", "attn", "sem"}`` numpy arrays (the JAX
        package's state) as this model's float32 tensors on its device."""
        self.state = {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(
            self.device) for k, v in tables.items()}
        self.dim = self.state["embed"].shape[1]

    def state_numpy(self) -> Dict[str, np.ndarray]:
        return {k: v.detach().cpu().numpy() for k, v in self.state.items()}

    def save_weights(self, path: str) -> None:
        save_embeddings(path, self.hg.names,
                        self.state["embed"].cpu().numpy())
