"""Peaks, operation and byte counts, and bounds (no torch).

Frozen copies of ``chip_smoke._bound`` and ``chip_smoke._sgns_flops`` and
of the K4 byte count of ``chip_smoke.phase_banded``, with the published
peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W):
67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of HBM.
perfbench/tests/test_frozen.py holds them to the originals.
"""

from __future__ import annotations

PEAK_F32 = 67e12  # FLOP/s, float32, CUDA cores
PEAK_BYTES = 3.35e12  # bytes/s, HBM3


def bound_ms(flops: float, nbytes: float) -> tuple:
    """(the least time the card could take, in ms, and what bounds it:
    "operations" or "bytes")."""
    t_ops, t_bytes = flops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def sgns_flops(samples: float, ks: int, d: int) -> float:
    """v.cp, v cn^T, g_pos cp + g_neg cn, g_pos v and g_neg^T v per
    sample, as multiply-adds counted twice."""
    return samples * (6 * ks * d + 4 * d)


def k4_bytes(rows: int, s: int, b: int, ks: int, d: int) -> float:
    """One K4 superstep's bytes: ``rows`` distinct table rows (source rows
    of the vertex table plus context rows of the context table) read and
    written once, the (S, Ks, D) negative snapshot read and its deltas
    written, the ids, band indices and rates read."""
    return (2 * rows * d + 2 * s * ks * d) * 4 + s * (2 * b + 3) * 4

