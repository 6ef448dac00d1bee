"""node2vec: second-order biased walks (p, q) and skip-gram SGNS.

Port of ``smore_tpu/models/node2vec.py``. The reference (Go) scans the
whole neighbour list at each step; here the bias is applied by alias draws
and rejection against a sorted-adjacency index
(``sampling/walks.node2vec_walk``: one launch of the walk kernel
``csrc/node2vec_walk.cu`` a draw on the card, its plain twin on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from smore_tpu_torch.models.walk_base import WalkSGNSBase
from smore_tpu_torch.sampling.mappers import skipgram_pairs
from smore_tpu_torch.sampling.walks import NeighborIndex, node2vec_walk
from smore_tpu_torch.utils import profiling


class Node2Vec(WalkSGNSBase):
    def __init__(self, graph, seed: int = 0, p: float = 1.0, q: float = 1.0,
                 device: torch.device | str = "cuda"):
        super().__init__(graph, seed, device)
        self.p = p
        self.q = q
        self.walk_steps = 40
        self.window_size = 5
        self._nbr = None

    def _make_ctx(self):
        if self._nbr is None:
            self._nbr = NeighborIndex.build(self.graph, self.device)
        return (self.build_sampler(), self._nbr)

    def _tables_of(self, ctx):
        return ctx[0]

    def _emit_pairs(self, ctx, gen, starts):
        tables, nbr = ctx
        with profiling.segment("walk.walk"):
            walk, row_mask = node2vec_walk(tables, nbr, gen, starts,
                                           self.walk_steps, self.p, self.q)
        with profiling.segment("walk.pairs"):
            return skipgram_pairs(walk, gen, self.window_size, row_mask)

    def train(
        self,
        walk_times: int = 10,
        walk_steps: int = 40,
        window_size: int = 5,
        negative_samples: int = 5,
        p: float = 1.0,
        q: float = 1.0,
        alpha: float = 0.025,
        batch_walks: int = 128,  # as DeepWalk's
        steps_per_call: int = 64,
        shared_negatives: int = 256,
        collision: str = "sum",
        mesh=None,
        sharding: str = "dp",
        verbose: bool = True,
    ) -> None:
        self.p, self.q = p, q
        self.walk_steps = walk_steps
        self.window_size = window_size
        self._run(
            total_walks=walk_times * self.graph.n_vertices,
            batch_walks=batch_walks,
            negatives=negative_samples,
            alpha=alpha,
            steps_per_call=steps_per_call,
            shared_negatives=shared_negatives,
            collision=collision,
            verbose=verbose,
            mesh=mesh,
            sharding=sharding,
        )

    def compute_homophily(self, threshold: float = 0.5) -> float:
        """Fraction of edges whose endpoints' vertex embeddings have cosine
        similarity above ``threshold`` (the reference's homophily)."""
        emb = self.state["vertex"].detach().cpu().numpy()
        nemb = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-12)
        g = self.graph
        src = np.repeat(np.arange(g.n_vertices), np.diff(g.indptr))
        sims = np.sum(nemb[src] * nemb[g.indices], axis=1)
        return float(np.mean(sims > threshold)) if len(sims) else 0.0
