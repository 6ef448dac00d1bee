"""DeepWalk: truncated random walks and skip-gram with negative sampling.

Port of ``smore_tpu/models/deepwalk.py``; the reference's CLI defaults:
walk_times 10, walk_steps 40, window_size 5, negative_samples 5, alpha
0.025.
"""

from __future__ import annotations

import torch

from smore_tpu_torch.models.walk_base import WalkSGNSBase
from smore_tpu_torch.sampling.mappers import skipgram_pairs
from smore_tpu_torch.sampling.walks import random_walk
from smore_tpu_torch.utils import profiling


class DeepWalk(WalkSGNSBase):
    def __init__(self, graph, seed: int = 0,
                 device: torch.device | str = "cuda"):
        super().__init__(graph, seed, device)
        self.walk_steps = 40
        self.window_size = 5

    def _emit_pairs(self, tables, gen, starts):
        with profiling.segment("walk.walk"):
            walk, row_mask = random_walk(tables, gen, starts, self.walk_steps)
        with profiling.segment("walk.pairs"):
            return skipgram_pairs(walk, gen, self.window_size, row_mask)

    def train(
        self,
        walk_times: int = 10,
        walk_steps: int = 40,
        window_size: int = 5,
        negative_samples: int = 5,
        alpha: float = 0.025,
        # 128 walks of 41 vertices: 52k pair slots a step, few enough that
        # stale-snapshot collisions do not cost quality
        batch_walks: int = 128,
        steps_per_call: int = 64,
        shared_negatives: int = 256,
        collision: str = "sum",
        hoist: int = 1,  # batches of walks per draw, before the policy
        mesh=None,
        sharding: str = "dp",
        verbose: bool = True,
    ) -> None:
        self.walk_steps = walk_steps
        self.window_size = window_size
        self._run(
            hoist=hoist,
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
