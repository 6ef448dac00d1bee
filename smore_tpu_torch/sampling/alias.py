"""Walker/Vose alias-method table construction (host side).

Port of ``smore_tpu/sampling/alias.py`` (``build_alias``,
``build_alias_segmented``), bit-equal to it: the same sequential Vose
build, in Python for small tables and in the native library above 4096
entries, exactly where the JAX package switches. The reference quirk is
kept: tables default to the 0.75 power.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_NATIVE_MIN = 4096  # tables above this size are built natively


def _native():
    from smore_tpu_torch.native import fastgraph

    return fastgraph if fastgraph.available() else None


def _build_alias_py(norm_prob: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Core Vose build given probabilities already scaled to mean 1."""
    n = len(norm_prob)
    prob = np.ones(n, dtype=np.float64)
    alias = np.full(n, -1, dtype=np.int64)
    p = norm_prob.astype(np.float64).copy()
    small = [i for i in range(n) if p[i] < 1.0]
    large = [i for i in range(n) if p[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()  # noqa: E741
        prob[s] = p[s]
        alias[s] = l
        p[l] = p[l] + p[s] - 1.0
        if p[l] < 1.0:
            small.append(l)
        else:
            large.append(l)
    # leftovers keep prob 1.0 and alias -1 (never selected), as the
    # reference does
    return prob, alias


def build_alias(
    weights: np.ndarray, power: float = 0.75, use_native: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """One alias table over ``weights`` (>= 0): (prob (n,) f64, alias (n,)
    i64). Zero weights get prob 0; all-zero weights give the uniform table
    (prob 1, alias -1)."""
    w = np.asarray(weights, dtype=np.float64)
    n = len(w)
    if n == 0:
        return np.zeros(0), np.zeros(0, dtype=np.int64)
    if power != 1.0:
        w = np.where(w > 0, np.power(w, power, where=w > 0), 0.0)
    total = w.sum()
    if total <= 0:
        return np.ones(n, dtype=np.float64), np.full(n, -1, dtype=np.int64)
    norm_prob = w * (n / total)
    lib = _native() if use_native and n > _NATIVE_MIN else None
    if lib is not None:
        return lib.build_alias(norm_prob)
    return _build_alias_py(norm_prob)


def build_alias_segmented(
    weights: np.ndarray,
    indptr: np.ndarray,
    power: float = 0.75,
    use_native: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """One alias table per CSR segment, concatenated; ``alias`` entries
    are LOCAL slot indices within their segment."""
    weights = np.asarray(weights, dtype=np.float64)
    indptr = np.asarray(indptr, dtype=np.int64)
    n = len(weights)
    lib = _native() if use_native and n > _NATIVE_MIN else None
    if lib is not None:
        return lib.build_alias_segmented(weights, indptr, power)
    prob = np.ones(n, dtype=np.float64)
    alias = np.full(n, -1, dtype=np.int64)
    for v in range(len(indptr) - 1):
        lo, hi = indptr[v], indptr[v + 1]
        if hi <= lo:
            continue
        prob[lo:hi], alias[lo:hi] = build_alias(
            weights[lo:hi], power=power, use_native=False)
    return prob, alias
