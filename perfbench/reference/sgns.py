"""Plain PyTorch reference of the SGNS updates that the benchmark's cells
train with. It imports nothing of the program.

Two updates, each the skip-gram-with-negative-sampling step of LINE
(order 2) and DeepWalk: a source row v, its positive context row c and a
pool of Ks negative context rows n_k shared by the batch,

    g_pos = alpha (1 - sigmoid(v . c))        (times the pair's mask)
    g_k   = -alpha (K / Ks) sigmoid(v . n_k)  (times the pair's mask)
    v    += g_pos c + sum_k g_k n_k
    c    += g_pos v
    n_k  += sum over the batch of g_k v

with K the per-sample negative count that the shared pool stands for, and
the loss -log(sigmoid(v . c)) - (K / Ks) sum_k log(1 - sigmoid(v . n_k)),
each sigmoid offset by 1e-7 inside the log.

- ``shared_negs_step``: every delta taken against the tables as they were
  before the step; duplicate rows sum. The loss is the masked mean over the
  first min(1024, B) pairs.
- ``banded_superstep``: S micro-steps in order, micro-step s on one band of
  source rows and one band of context rows, in tiles of min(1024, B) pairs
  also in order: a tile sees the rows as the earlier tiles left them, its
  duplicates sum. The negatives' rows are read once before the first
  micro-step and their deltas added after the last. The loss is the mean
  over all S * B pairs.

Products that contract over the embedding axis or the pool are matrix
products, so that ``torch.backends.cuda.matmul.allow_tf32`` decides their
precision: the benchmark's control computes them in TF32.
"""

from __future__ import annotations

import numpy as np
import torch

EPS = 1e-7
LOSS_ROWS = 1024


def _dot_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise dot products of (B, D) a and b, as a batched product."""
    return torch.bmm(a[:, None, :], b[:, :, None])[:, 0, 0]


def shared_negs_step(wv: torch.Tensor, wc: torch.Tensor, src: torch.Tensor,
                     pos: torch.Tensor, negs: torch.Tensor, alpha: float,
                     k_equiv: int, mask=None) -> float:
    """One shared-negative step on ``wv`` and ``wc`` in place; returns the
    loss."""
    src, pos, negs = src.long(), pos.long(), negs.long()
    v, cp, cn = wv[src], wc[pos], wc[negs]
    kscale = k_equiv / cn.shape[0]
    s_pos = torch.sigmoid(_dot_rows(v, cp))
    s_neg = torch.sigmoid(v @ cn.T)
    g_pos = (1.0 - s_pos) * alpha
    g_neg = -s_neg * (alpha * kscale)
    if mask is not None:
        g_pos = g_pos * mask
        g_neg = g_neg * mask[:, None]
    d_src = g_pos[:, None] * cp + g_neg @ cn
    d_pos = g_pos[:, None] * v
    d_neg = g_neg.T @ v
    m = min(LOSS_ROWS, src.shape[0])
    ce = -torch.log(s_pos[:m] + EPS) - kscale * torch.log(
        1.0 - s_neg[:m] + EPS).sum(-1)
    if mask is None:
        loss = ce.mean()
    else:
        loss = (ce * mask[:m]).sum() / torch.clamp(mask[:m].sum(), min=1.0)
    wc.index_add_(0, pos, d_pos)
    wc.index_add_(0, negs, d_neg)
    wv.index_add_(0, src, d_src)
    return float(loss)


def banded_superstep(wv: torch.Tensor, wc: torch.Tensor, src: torch.Tensor,
                     pos: torch.Tensor, negs: torch.Tensor,
                     alphas: torch.Tensor, k_equiv: int) -> float:
    """One superstep on ``wv`` and ``wc`` in place. ``src``, ``pos``:
    (S, B) GLOBAL rows, each micro-step's inside one band of its table;
    ``negs``: (S, Ks) global rows; ``alphas``: (S,). Returns the loss."""
    S, B = src.shape
    Ks, D = negs.shape[1], wv.shape[1]
    kscale = k_equiv / Ks
    tile = min(1024, B)
    flat = negs.reshape(-1).long()
    cn = wc[flat].reshape(S, Ks, D)
    d_neg = torch.zeros_like(cn)
    loss = torch.zeros((), dtype=torch.float64, device=wv.device)
    for s in range(S):
        a = float(alphas[s])
        for t0 in range(0, B, tile):
            rv = src[s, t0:t0 + tile].long()
            rc = pos[s, t0:t0 + tile].long()
            v, cp = wv[rv], wc[rc]
            s_pos = torch.sigmoid(_dot_rows(v, cp))
            s_neg = torch.sigmoid(v @ cn[s].T)
            g_pos = (1.0 - s_pos) * a
            g_neg = -s_neg * (a * kscale)
            loss += (-torch.log(s_pos + EPS)).sum() - kscale * torch.log(
                1.0 - s_neg + EPS).sum()
            d_neg[s] += g_neg.T @ v
            wv.index_add_(0, rv, g_pos[:, None] * cp + g_neg @ cn[s])
            wc.index_add_(0, rc, g_pos[:, None] * v)
    wc.index_add_(0, flat, d_neg.reshape(-1, D))
    return float(loss) / (S * B)


def alpha_schedule(alpha: float, step0: int, steps: int, micro_steps: int,
                   samples_per_step: int, total_samples: int):
    """The learning rates of ``steps`` steps from step ``step0`` of a job
    of ``total_samples`` samples, ``samples_per_step`` a step: linear decay
    in the samples done, ``alpha * (1 - done / total)``, never under
    ``alpha * 1e-4``; with ``micro_steps`` > 1 a rate per micro-step, each
    a ``1 / micro_steps`` part of a step further on. (steps,) or (steps,
    micro_steps) float32, worked out in float64."""
    import numpy as np

    inv = samples_per_step / max(total_samples, 1)
    x = step0 + np.arange(steps, dtype=np.float64)
    if micro_steps > 1:
        x = x[:, None] + np.arange(micro_steps) / micro_steps
    rate = alpha * np.maximum(1.0 - x * inv, 1e-4)
    return rate.astype(np.float32)
