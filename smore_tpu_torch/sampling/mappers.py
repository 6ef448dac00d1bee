"""Walk -> training-pair mappers, fixed-shape, on the walk's device.

Port of ``smore_tpu/sampling/mappers.py``. The reference's mappers build
variable-length (vertex, context) lists per walk; here a (B, L) walk maps
to a dense (B, L, C) grid of candidate pairs and a float mask of the valid
slots (a masked slot adds no gradient). Only positive pairs are emitted:
the update draws the negatives, as the reference's model loops do.

The context ids come from ``walk[:, j]`` with an (L, C) index ``j``, so no
(B, L, C) index tensor is built. Given the same walk (and the same
``reduce`` where a window shrinks) every output is the JAX package's bit
for bit.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch


def _offsets(window_min: int, window_max: int) -> np.ndarray:
    """[-wmax..-wmin, wmin..wmax]: the context offsets, 0 excluded."""
    left = -np.arange(window_min, window_max + 1)[::-1]
    right = np.arange(window_min, window_max + 1)
    return np.concatenate([left, right])


def _grid(L: int, offs: np.ndarray, device):
    """(j (L, C) context positions clipped to the walk, in_bounds (L, C),
    |offset| (C,)) for the offsets ``offs``."""
    return _grid_of(L, tuple(int(o) for o in offs), torch.device(device))


@functools.lru_cache(maxsize=None)
def _grid_of(L: int, offs: tuple, device: torch.device):
    """_grid, built once per (L, offsets, device): a step captured in a CUDA
    graph copies nothing from the host (a pageable copy cannot be
    captured)."""
    offs = np.asarray(offs, dtype=np.int64)
    j = np.arange(L)[:, None] + offs[None, :]
    in_bounds = (j >= 0) & (j < L)
    return (torch.from_numpy(np.clip(j, 0, L - 1)).to(device),
            torch.from_numpy(in_bounds).to(device),
            torch.from_numpy(np.abs(offs)).to(device))


def _shrunk(gen, walk: torch.Tensor, window: int,
            reduce: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-center window U{1..window} (B, L): ``reduce`` or a draw."""
    if reduce is None:
        reduce = torch.randint(1, window + 1, tuple(walk.shape),
                               generator=gen, device=walk.device)
    return reduce


def skipgram_pairs(
    walk: torch.Tensor,  # (B, L) int32
    gen: Optional[torch.Generator],
    window: int,
    row_mask: Optional[torch.Tensor] = None,  # (B,) float32
    valid: Optional[torch.Tensor] = None,  # (B, L) per-position validity;
    # a pair needs both ends valid
    reduce: Optional[torch.Tensor] = None,  # (B, L) in 1..window
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SkipGrams: per center a window shrunk to ``reduce`` ~ U{1..window};
    pairs (walk[i], walk[i+o]) for 0 < |o| <= reduce inside the walk.
    Returns flat (src, ctx, mask), each of B * L * 2 * window."""
    B, L = walk.shape
    j, in_bounds, dist = _grid(L, _offsets(1, window), walk.device)
    reduce = _shrunk(gen, walk, window, reduce)
    mask = (in_bounds & (dist <= reduce[:, :, None])).to(torch.float32)
    if row_mask is not None:
        mask = mask * row_mask[:, None, None]
    if valid is not None:
        mask = mask * valid[:, :, None] * valid[:, j]
    ctx = walk[:, j]
    src = walk[:, :, None].expand(ctx.shape)
    return src.reshape(-1), ctx.reshape(-1), mask.reshape(-1)


def scale_skipgram_pairs(
    walk: torch.Tensor,  # (B, L)
    window_min: int,
    window_max: int,
    row_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ScaleSkipGrams: the fixed band window_min <= |o| <= window_max, no
    shrink (Walklets' scale). Offsets past the walk's ends are masked (the
    reference clamps them to the end, repeating boundary pairs)."""
    B, L = walk.shape
    j, in_bounds, _ = _grid(L, _offsets(window_min, window_max), walk.device)
    mask = in_bounds.to(torch.float32).expand(B, L, j.shape[1])
    if row_mask is not None:
        mask = mask * row_mask[:, None, None]
    ctx = walk[:, j]
    src = walk[:, :, None].expand(ctx.shape)
    return src.reshape(-1), ctx.reshape(-1), mask.reshape(-1)


def ordinal_pairs(
    walk: torch.Tensor,  # (B, L)
    row_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """OrdinalSkipGrams (its live branch): (walk[0], walk[i]) for i in
    1..L-1, each ranked against one negative by the caller. Returns flat
    (src, ctx, mask) of B * (L-1)."""
    B, L = walk.shape
    src = walk[:, :1].expand(B, L - 1)
    ctx = walk[:, 1:]
    mask = torch.ones((B, L - 1), dtype=torch.float32, device=walk.device)
    if row_mask is not None:
        mask = mask * row_mask[:, None]
    return src.reshape(-1), ctx.reshape(-1), mask.reshape(-1)


def cbow_groups(
    walk: torch.Tensor,  # (B, L)
    gen: Optional[torch.Generator],
    window: int,
    row_mask: Optional[torch.Tensor] = None,
    reduce: Optional[torch.Tensor] = None,  # (B, L) in 1..window
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """CBOWs, grouped: each center's masked context set, for a CBOW update
    to average. Returns (centers (B*L,), ctx (B*L, 2W), ctx_mask (B*L,
    2W))."""
    B, L = walk.shape
    j, in_bounds, dist = _grid(L, _offsets(1, window), walk.device)
    reduce = _shrunk(gen, walk, window, reduce)
    mask = (in_bounds & (dist <= reduce[:, :, None])).to(torch.float32)
    if row_mask is not None:
        mask = mask * row_mask[:, None, None]
    W2 = j.shape[1]
    return (walk.reshape(-1), walk[:, j].reshape(B * L, W2),
            mask.reshape(B * L, W2))
