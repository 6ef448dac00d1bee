"""APP: graph embedding for asymmetric proximity.

Port of ``smore_tpu/models/app.py``: per vertex ``sample_times`` jumping
random walks, each giving one SGNS pair (its start, its end). The
reference's CLI defaults: jump 0.15, sample_times 20, walk_times 100.
"""

from __future__ import annotations

import torch

from smore_tpu_torch.models.walk_base import WalkSGNSBase
from smore_tpu_torch.sampling.walks import jumping_walk_endpoints


class APP(WalkSGNSBase):
    def __init__(self, graph, seed: int = 0,
                 device: torch.device | str = "cuda"):
        super().__init__(graph, seed, device)
        self.jump = 0.15
        self.max_steps = 64

    def _emit_pairs(self, tables, gen, starts):
        ends, row_mask = jumping_walk_endpoints(tables, gen, starts,
                                                self.jump, self.max_steps)
        return starts, ends, row_mask

    def train(
        self,
        walk_times: int = 100,
        sample_times: int = 20,
        jump: float = 0.15,
        negative_samples: int = 5,
        alpha: float = 0.025,
        batch_walks: int = 8192,
        steps_per_call: int = 64,
        shared_negatives: int = 128,
        collision: str = "sum",
        mesh=None,
        sharding: str = "dp",
        verbose: bool = True,
    ) -> None:
        self.jump = jump
        self._run(
            total_walks=walk_times * sample_times * self.graph.n_vertices,
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
