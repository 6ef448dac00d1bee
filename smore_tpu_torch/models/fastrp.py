"""FastRP: training-free embeddings by iterated sparse random projection.

Port of ``smore_tpu/models/fastrp.py``:

  1. very sparse random init: per entry +1 w.p. 2.5%, -1 w.p. 2.5%,
     else 0
  2. ``iterations`` rounds of neighbour aggregation: for each vertex,
     sum_j w_ij * x_j * deg_i^(-ns) / sum_j w_ij
  3. blocks [U_0 | U_1 | ... | U_L] concatenated, dim_per_iteration =
     dim // (iterations + 1), zero-padded to ``dim``; rows L2-normalised

Each round is one edge gather and one ``index_add_`` over the edge
sources (a sparse product); no SGD anywhere.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from smore_tpu_torch.graph.graph import Graph
from smore_tpu_torch.io.embeddings import save_embeddings
from smore_tpu_torch.models.base import INIT_STREAM, seeded_generator


class FastRP:
    """``device`` holds the projection and the aggregation: the CUDA card
    unless the caller asks for another."""

    def __init__(
        self,
        graph: Graph,
        seed: int = 42,
        iterations: int = 3,
        normalization_strength: float = 0.0,
        device: torch.device | str = "cuda",
    ):
        self.graph = graph
        self.seed = seed
        self.iterations = iterations
        self.normalization_strength = normalization_strength
        self.device = torch.device(device)
        self.state = {}
        self.dim = 0

    @classmethod
    def load_edge_list(cls, path: str, undirected: bool = True, **kw):
        return cls(Graph.load_edge_list(path, undirected=undirected), **kw)

    def generate(self, dim: int, x: Optional[torch.Tensor] = None) -> None:
        """Embed every vertex in ``dim`` columns. ``x`` (N, dim //
        (iterations + 1)) replaces the random projection (the JAX
        package's, for a comparison)."""
        g = self.graph
        n = g.n_vertices
        dev = self.device
        self.dim = dim
        L = self.iterations
        d_iter = max(1, dim // (L + 1))
        if x is None:
            u = torch.rand(n, d_iter, generator=seeded_generator(
                self.seed, INIT_STREAM, dev), device=dev)
            x = torch.where(u < 0.025, 1.0, torch.where(u < 0.05, -1.0, 0.0))
        else:
            x = x.to(device=dev, dtype=torch.float32)

        deg_np = np.diff(g.indptr)
        src = torch.from_numpy(np.repeat(np.arange(n, dtype=np.int64),
                                         deg_np)).to(dev)
        dst = torch.from_numpy(np.asarray(g.indices, dtype=np.int64)).to(dev)
        w = torch.from_numpy(np.asarray(g.weights, dtype=np.float32)).to(dev)
        deg = torch.from_numpy(deg_np.astype(np.float32)).to(dev)
        tot_w = torch.zeros(n, device=dev).index_add_(0, src, w)
        ns = self.normalization_strength
        norm = torch.where(deg > 0, deg, 1.0) ** (-ns) if ns > 0 else 1.0
        scale = torch.where(tot_w > 0, norm / torch.clamp(tot_w, min=1e-12),
                            0.0)

        blocks = [x]
        for _ in range(L):
            msg = x[dst] * w[:, None]
            x = torch.zeros(n, d_iter, device=dev).index_add_(
                0, src, msg) * scale[:, None]
            blocks.append(x)
        emb = torch.cat(blocks, dim=1)
        if emb.shape[1] < dim:  # pad like the reference's fixed-size rows
            emb = torch.nn.functional.pad(emb, (0, dim - emb.shape[1]))
        nrm = torch.sqrt((emb * emb).sum(1, keepdim=True))
        self.state = {"vertex": emb / torch.clamp(nrm, min=1e-12)}

    def save_weights(self, path: str) -> None:
        save_embeddings(path, self.graph.names,
                        self.state["vertex"].cpu().numpy())
