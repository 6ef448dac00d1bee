"""metapath2vec: type-constrained walks and skip-gram SGNS.

Port of ``smore_tpu/models/metapath2vec.py``. Per walk: a RANDOM
registered metapath, a MetaPathWalk from a uniform start, skip-gram pairs
of its valid positions, and the masked shared-negative SGNS update with
uniform negatives (the reference's uniform^0.75 table). The masked update
takes the plain step (the walk family's ``update``, not kernel K1), as in
the JAX package; four inner passes at twice the rate always (metapath
walks dead-end fast, so each step carries few pairs). The walks of
``walk_base.draw_hoist`` batches are drawn at once.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from smore_tpu_torch.graph.hetero import HeteroGraph, HeteroTables
from smore_tpu_torch.models.base import (
    INIT_STREAM,
    freshness_policy,
    init_embedding,
    zeros_embedding,
)
from smore_tpu_torch.models.walk_base import WalkSGNSBase, draw_hoist
from smore_tpu_torch.sampling.mappers import skipgram_pairs
from smore_tpu_torch.sampling.tables import VertexLaw


def meta_path_arrays(hg: HeteroGraph, meta_paths: List[List[str]], device):
    """(path_types (P, Lmax) int32 padded, path_lens (P,) int32) on the
    device."""
    lmax = max(len(p) for p in meta_paths)
    pt = np.zeros((len(meta_paths), lmax), dtype=np.int32)
    pl = np.zeros(len(meta_paths), dtype=np.int32)
    for i, p in enumerate(meta_paths):
        pl[i] = len(p)
        for j, t in enumerate(p):
            pt[i, j] = hg.type2id[t]
    return torch.from_numpy(pt).to(device), torch.from_numpy(pl).to(device)


class Metapath2Vec(WalkSGNSBase):
    def __init__(self, hg: HeteroGraph, seed: int = 0,
                 device: torch.device | str = "cuda"):
        super().__init__(hg, seed, device)
        self.hg = hg
        self.meta_paths: List[List[str]] = []
        self.walk_steps = 40
        self.window_size = 5

    @classmethod
    def load_edge_list(cls, path: str, undirected: bool = True, **kw):
        return cls(HeteroGraph.load_edge_list(path, undirected), **kw)

    def add_meta_path(self, path: List[str]) -> None:
        self.hg.validate_meta_path(path)
        self.meta_paths.append(path)

    def init(self, dim: int) -> None:
        self.dim = dim
        n = self.hg.n_vertices
        self.state = {
            "vertex": init_embedding(self._generator(INIT_STREAM), n, dim,
                                     device=self.device),
            "context": zeros_embedding(n, dim, self.device),
        }

    def _make_ctx(self):
        """(tables, path_types, path_lens, the uniform negative law)."""
        pt, pl = meta_path_arrays(self.hg, self.meta_paths, self.device)
        return (HeteroTables.build(self.hg, self.device), pt, pl,
                VertexLaw(self.hg.n_vertices, self.device))

    def _tables_of(self, ctx):
        return ctx[3]

    def _emit_pairs(self, ctx, gen, starts):
        tables, pt, pl, _ = ctx
        pidx = torch.randint(0, len(self.meta_paths), tuple(starts.shape),
                             generator=gen, device=starts.device,
                             dtype=torch.int32)
        walk, valid = tables.metapath_walk(gen, starts, pt, pl, pidx,
                                           self.walk_steps)
        return skipgram_pairs(walk, gen, self.window_size, valid=valid)

    def train(
        self,
        walk_times: int = 10,
        walk_steps: int = 40,
        window_size: int = 5,
        negative_samples: int = 5,
        alpha: float = 0.025,
        batch_walks: int = 128,
        steps_per_call: int = 32,
        shared_negatives: int = 256,
        collision: str = "sum",
        verbose: bool = True,
        checkpoint: str = None,
        checkpoint_every: int = 1,
        resume: bool = True,
    ) -> None:
        if not self.meta_paths:
            raise ValueError(
                "no meta-paths defined; call add_meta_path() first")
        self.walk_steps = walk_steps
        self.window_size = window_size
        total = walk_times * self.hg.n_vertices
        batch_walks, _ = freshness_policy(total, batch_walks, 1)
        if getattr(self, "inner_passes", 0) in (0, 1):
            # metapath walks CYCLE their type pattern and dead-end fast, so
            # the zero-init context bootstrap gap persists at every budget:
            # always four passes at twice the rate (the JAX package's
            # measured policy)
            self.inner_passes = 4
            alpha = alpha * 2.0
        hoist = draw_hoist(batch_walks)
        self.set_checkpoint(checkpoint, checkpoint_every, resume)
        self.state = self._drive(
            self._make_step(batch_walks, negative_samples, shared_negatives,
                            collision, hoist),
            self._make_ctx(), batch_walks * hoist, alpha, total,
            steps_per_call, verbose, micro_steps=hoist)
