"""Sampling laws and the negative alias table.

Port of the parts of ``smore_tpu/sampling/tables.py`` that the banded path
uses: the vertex and negative distributions and ``build_negative_table``.
The rest of ``SamplerTables`` (the unbanded path's device sampler) is not
ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from smore_tpu_torch.graph.graph import Graph
from smore_tpu_torch.sampling.alias import build_alias


def _vertex_distribution(g: Graph, method: str) -> np.ndarray:
    if method == "out_degrees":
        return g.out_degree
    if method == "no_degrees":
        return (g.out_degree > 0).astype(np.float64)
    if method == "degrees":
        return g.out_degree + g.in_degree
    raise ValueError(f"unknown vertex_method {method!r}")


def _negative_distribution(g: Graph, method: str) -> np.ndarray:
    if method == "degrees":
        return g.out_degree + g.in_degree
    if method == "in_degrees":
        return g.in_degree
    if method == "no_degrees":
        return (g.in_degree > 0).astype(np.float64)
    raise ValueError(f"unknown negative_method {method!r}")


def build_negative_table(
    g: Graph,
    negative_method: str = "degrees",
    power: float = 0.75,
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """The (N, 2) f32 [prob, alias] negative alias table (deg^0.75 law);
    alias -1 slots point at themselves so device gathers stay in bounds."""
    prob, alias = build_alias(
        _negative_distribution(g, negative_method), power=power)
    idx = np.arange(g.n_vertices, dtype=np.int64)
    alias = np.where(alias < 0, idx, alias)
    return torch.from_numpy(
        np.stack([prob, alias], axis=1).astype(np.float32)).to(device)
