"""Walklets: multi-scale skip-gram over a band of walk offsets.

Port of ``smore_tpu/models/walklets.py``: RandomWalk, ScaleSkipGrams over
window_min <= |offset| <= window_max, then the SGNS update (negatives by
degree^0.75). The reference's CLI defaults: window_min 2, window_max 5.
"""

from __future__ import annotations

import torch

from smore_tpu_torch.models.walk_base import WalkSGNSBase
from smore_tpu_torch.sampling.mappers import scale_skipgram_pairs
from smore_tpu_torch.sampling.walks import random_walk


class Walklets(WalkSGNSBase):
    def __init__(self, graph, seed: int = 0,
                 device: torch.device | str = "cuda"):
        super().__init__(graph, seed, device)
        self.walk_steps = 40
        self.window_min = 2
        self.window_max = 5

    def _emit_pairs(self, tables, gen, starts):
        walk, row_mask = random_walk(tables, gen, starts, self.walk_steps)
        return scale_skipgram_pairs(walk, self.window_min, self.window_max,
                                    row_mask)

    def train(
        self,
        walk_times: int = 10,
        walk_steps: int = 40,
        window_min: int = 2,
        window_max: int = 5,
        negative_samples: int = 5,
        alpha: float = 0.025,
        batch_walks: int = 128,  # as DeepWalk's
        steps_per_call: int = 64,
        shared_negatives: int = 256,
        collision: str = "sum",
        mesh=None,
        sharding: str = "dp",
        verbose: bool = True,
    ) -> None:
        self.walk_steps = walk_steps
        self.window_min = window_min
        self.window_max = window_max
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
