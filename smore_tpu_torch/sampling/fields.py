"""Field-constrained sampling tables.

Port of ``smore_tpu/sampling/fields.py``. The reference tags each vertex
with a field id and draws field-matched vertices by rejection (resample
until the field matches). Here one alias table per field, concatenated
into flat tensors, serves every field with one gather:

    field_indptr (F+1,) i32: slot range of field f
    field_pa     (S, 2) f32: [prob, alias_slot] per slot
    field_vid    (S,)   i32: vid at each slot
    field_of     (N,)   i32: field id per vertex

A field-constrained draw picks a slot uniformly inside the field's range,
follows the alias redirect and reads the vid. ``build`` is host numpy,
bit-equal to the JAX package's arrays; the draw takes its uniforms ``u2``
in the JAX draw's shape and is then bit-equal to it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from smore_tpu_torch.graph.graph import Graph
from smore_tpu_torch.sampling.alias import build_alias


@dataclass
class FieldTables:
    field_indptr: torch.Tensor  # (F+1,) int32
    field_pa: torch.Tensor  # (S, 2) float32 [prob, alias_slot]
    field_vid: torch.Tensor  # (S,) int32
    field_of: torch.Tensor  # (N,) int32

    @property
    def device(self) -> torch.device:
        return self.field_vid.device

    @staticmethod
    def build(graph: Graph, weights: Optional[np.ndarray] = None,
              device: torch.device | str = "cuda") -> "FieldTables":
        """weights: per-vertex sampling mass, taken to the 0.75 power inside
        each field's table (default: in + out degree, the negative law).
        A graph without field metadata is one field."""
        n = graph.n_vertices
        fields = (graph.fields if graph.fields is not None
                  else np.zeros(n, dtype=np.int32))
        n_fields = max(1, int(fields.max()) + 1 if len(fields) else 1)
        if weights is None:
            weights = graph.out_degree + graph.in_degree

        order = np.argsort(fields, kind="stable")
        indptr = np.searchsorted(fields[order],
                                 np.arange(n_fields + 1)).astype(np.int64)
        prob = np.ones(n, dtype=np.float64)
        alias_slot = np.arange(n, dtype=np.int64)
        for f in range(n_fields):
            lo, hi = indptr[f], indptr[f + 1]
            if hi <= lo:
                continue
            p, a = build_alias(weights[order[lo:hi]].astype(np.float64))
            prob[lo:hi] = p
            alias_slot[lo:hi] = lo + np.where(a < 0, np.arange(hi - lo), a)

        def dev(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=device, dtype=dtype)

        return FieldTables(
            field_indptr=dev(indptr.astype(np.int32), torch.int32),
            field_pa=dev(np.stack([prob, alias_slot], 1).astype(np.float32),
                         torch.float32),
            field_vid=dev(order.astype(np.int32), torch.int32),
            field_of=dev(fields.astype(np.int32), torch.int32),
        )

    def negative_field_sample(self, gen: Optional[torch.Generator],
                              fids: torch.Tensor,
                              u2: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
        """One vertex per element of ``fids`` whose field is that element
        (the reference's NegativeFieldSample / rejection loop, exactly).
        ``u2`` (*fids.shape, 2) uniforms; drawn from ``gen`` when None."""
        if u2 is None:
            u2 = torch.rand(tuple(fids.shape) + (2,), generator=gen,
                            device=self.device)
        fids = fids.long()
        lo = self.field_indptr[fids]
        size = torch.clamp(self.field_indptr[fids + 1] - lo, min=1)
        # f32 product, truncated to int32 and clamped, as in the JAX draw
        slot = lo + torch.minimum((u2[..., 0] * size).to(torch.int32),
                                  size - 1)
        row = self.field_pa[slot.long()]
        slot = torch.where(u2[..., 1] < row[..., 0], slot,
                           row[..., 1].to(torch.int32))
        return self.field_vid[slot.long()]

    def field_of_v(self, vids: torch.Tensor) -> torch.Tensor:
        return self.field_of[vids.long()]
