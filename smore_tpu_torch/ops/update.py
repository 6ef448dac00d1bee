"""The SGNS update core: gather rows, score, scale, scatter-add.

Port of the SGNS part of ``smore_tpu/ops/update.py`` (``scatter_apply``,
``apply_two_tables``, ``sgns_grads``, ``sgns_step``, ``sgns_step_shared``,
``sgns_shared_negs_step``, and the banded large-table forms
``sgns_shared_negs_step_banded`` / ``_sgns_banded_step_fused`` and the
band-persistent block ``sgns_banded_block``). A batched step applies every
sample against the batch-start snapshot of the tables; duplicate rows in a batch sum
their contributions (collision "sum"), or are divided by their occurrence
count (collision "mean").

The tables are UPDATED IN PLACE with ``index_add_`` (the JAX package
returned new arrays from donated buffers), and each function returns the
tensors it was given. Every delta is computed from rows gathered before
the first scatter, so when both tables are one tensor (LINE order 1) the
update still sees the batch-start snapshot. The update is hand-derived
SGD; no autograd is involved.
"""

from __future__ import annotations

from typing import Optional

import torch

from smore_tpu_torch.ops.scatter import band_scatter_add
from smore_tpu_torch.ops.sgns import sgns_shared_grads
from smore_tpu_torch.ops.sgns_banded import sgns_banded_fused

_EPS = 1e-7
_LOSS_ROWS = 1024  # rows of the shared-negative monitoring loss


def _maybe_mask(g: torch.Tensor, mask: Optional[torch.Tensor]):
    return g if mask is None else g * mask


def scatter_apply(w: torch.Tensor, idx_deltas, collision: str = "sum"):
    """Add row updates ``[(idx (B,), delta (B, D)[, count_w (B,)]), ...]``
    to ``w`` in place and return it.

    "sum": duplicate rows sum their deltas. "mean": each row's deltas are
    divided by the row's occurrence count over ALL the entries (weighted by
    ``count_w`` where given, so that masked slots do not dilute it)."""
    if collision == "sum":
        for entry in idx_deltas:
            w.index_add_(0, entry[0], entry[1])
        return w
    if collision != "mean":
        raise ValueError(f"collision must be 'sum' or 'mean', got "
                         f"{collision!r}")
    cnt = torch.zeros(w.shape[0], dtype=w.dtype, device=w.device)
    for entry in idx_deltas:
        idx = entry[0]
        cw = entry[2] if len(entry) > 2 and entry[2] is not None else None
        if cw is None:
            cw = torch.ones(idx.shape[0], dtype=w.dtype, device=w.device)
        cnt.index_add_(0, idx, cw)
    cnt.clamp_(min=1.0)
    for entry in idx_deltas:
        idx, delta = entry[0], entry[1]
        w.index_add_(0, idx, delta / cnt[idx][:, None])
    return w


def apply_two_tables(w_vertex, w_context, vertex_entries, context_entries,
                     shared_table: bool = False, update_vertex: bool = True,
                     collision: str = "sum"):
    """Scatter vertex-side and context-side updates; with ``shared_table``
    (one table passed as both) every entry lands in one pass, so a "mean"
    count sees them all."""
    if shared_table:
        entries = list(context_entries) + (
            list(vertex_entries) if update_vertex else [])
        w = scatter_apply(w_vertex, entries, collision)
        return w, w
    scatter_apply(w_context, context_entries, collision)
    if update_vertex:
        scatter_apply(w_vertex, vertex_entries, collision)
    return w_vertex, w_context


def sgns_grads(w_vertex, w_context, src, pos, negs, alpha,
               mask: Optional[torch.Tensor] = None, reg: float = 0.0):
    """SGNS deltas with per-sample negatives ``negs`` (B, K): returns
    (d_src (B, D), d_pos (B, D), d_neg (B, K, D), loss ())."""
    v = w_vertex[src]
    cp = w_context[pos]
    cn = w_context[negs]  # (B, K, D)
    s_pos = torch.sigmoid((v * cp).sum(-1))
    s_neg = torch.sigmoid(torch.einsum("bd,bkd->bk", v, cn))
    g_pos = _maybe_mask((1.0 - s_pos) * alpha, mask)
    g_neg = (0.0 - s_neg) * alpha
    if mask is not None:
        g_neg = g_neg * mask[:, None]
    d_src = g_pos[:, None] * cp + torch.einsum("bk,bkd->bd", g_neg, cn)
    d_pos = g_pos[:, None] * v
    d_neg = g_neg[:, :, None] * v[:, None, :]
    if reg:
        m1 = 1.0 if mask is None else mask[:, None]
        d_src = d_src - (alpha * reg) * v * m1
        d_pos = d_pos - (alpha * reg) * cp * m1
    ce = -torch.log(s_pos + _EPS) - torch.log(1.0 - s_neg + _EPS).sum(-1)
    if mask is None:
        loss = ce.mean()
    else:
        loss = (ce * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return d_src, d_pos, d_neg, loss


def sgns_step(w_vertex, w_context, src, pos, negs, alpha,
              mask: Optional[torch.Tensor] = None, reg: float = 0.0,
              update_vertex: bool = True, collision: str = "sum"):
    """One SGNS update with per-sample negatives against distinct vertex
    and context tables (LINE order 2). ``update_vertex=False`` is the
    reference's UpdateFreezePair. Returns (w_vertex, w_context, loss)."""
    d_src, d_pos, d_neg, loss = sgns_grads(w_vertex, w_context, src, pos,
                                           negs, alpha, mask, reg)
    B, K, D = d_neg.shape
    mask_k = None if mask is None else mask.repeat_interleave(K)
    scatter_apply(w_context, [(pos, d_pos, mask),
                              (negs.reshape(-1), d_neg.reshape(B * K, D),
                               mask_k)], collision)
    if update_vertex:
        scatter_apply(w_vertex, [(src, d_src, mask)], collision)
    return w_vertex, w_context, loss


def sgns_step_shared(w, src, pos, negs, alpha,
                     mask: Optional[torch.Tensor] = None, reg: float = 0.0,
                     collision: str = "sum"):
    """SGNS with per-sample negatives on one shared table (LINE order 1).
    Returns (w, loss)."""
    d_src, d_pos, d_neg, loss = sgns_grads(w, w, src, pos, negs, alpha,
                                           mask, reg)
    B, K, D = d_neg.shape
    mask_k = None if mask is None else mask.repeat_interleave(K)
    scatter_apply(w, [(src, d_src, mask), (pos, d_pos, mask),
                      (negs.reshape(-1), d_neg.reshape(B * K, D), mask_k)],
                  collision)
    return w, loss


def _shared_negs_deltas(v, cp, cn, alpha, k_equiv: int,
                        mask: Optional[torch.Tensor] = None,
                        reg: float = 0.0, use_pallas: bool = False):
    """The shared-negative SGNS deltas of gathered rows v, cp (B, D) against
    the pool cn (Ks, D): (d_src, d_pos, d_neg (Ks, D), loss), loss the mean
    cross-entropy over the first min(1024, B) rows. use_pallas: through
    kernel K1 when mask is None, reg is 0 and B % min(1024, B) == 0."""
    B, Ks = v.shape[0], cn.shape[0]
    kscale = k_equiv / Ks
    m = min(_LOSS_ROWS, B)

    if use_pallas and mask is None and not reg and B % m == 0:
        d_src, d_pos, d_neg = sgns_shared_grads(v, cp, cn, alpha,
                                                k_equiv=k_equiv)
        s_pos = torch.sigmoid((v[:m] * cp[:m]).sum(-1))
        s_neg = torch.sigmoid(v[:m] @ cn.T)
    else:
        s_pos_full = torch.sigmoid((v * cp).sum(-1))
        s_neg_full = torch.sigmoid(v @ cn.T)
        g_pos = _maybe_mask((1.0 - s_pos_full) * alpha, mask)
        g_neg = (0.0 - s_neg_full) * (alpha * kscale)
        if mask is not None:
            g_neg = g_neg * mask[:, None]
        d_src = g_pos[:, None] * cp + g_neg @ cn
        d_pos = g_pos[:, None] * v
        d_neg = g_neg.T @ v
        if reg:
            ar = alpha * reg
            m1 = 1.0 if mask is None else mask[:, None]
            d_src = d_src - ar * v * m1
            d_pos = d_pos - ar * cp * m1
            d_neg = d_neg - ar * cn * kscale
        s_pos, s_neg = s_pos_full[:m], s_neg_full[:m]

    ce = -torch.log(s_pos + _EPS) - kscale * torch.log(
        1.0 - s_neg + _EPS).sum(-1)
    if mask is None:
        loss = ce.mean()
    else:
        loss = (ce * mask[:m]).sum() / torch.clamp(mask[:m].sum(), min=1.0)
    return d_src, d_pos, d_neg, loss


def sgns_shared_negs_step(
    w_vertex: torch.Tensor,
    w_context: torch.Tensor,
    src: torch.Tensor,  # (B,)
    pos: torch.Tensor,  # (B,)
    negs: torch.Tensor,  # (Ks,) the step's shared negative pool
    alpha,
    k_equiv: int = 5,  # the per-sample negative count emulated
    mask: Optional[torch.Tensor] = None,
    shared_table: bool = False,  # True: LINE order 1 (one table)
    update_vertex: bool = True,
    reg: float = 0.0,  # L2 shrink (reference Opt_SigmoidRegSGD)
    collision: str = "sum",
    src_group: int = 1,  # src is a repeat layout of groups of this size
    use_pallas: bool = False,  # fused gradient kernel K1
):
    """SGNS with one pool of Ks negatives shared by the whole batch, their
    gradients scaled by k_equiv / Ks so the expected per-sample update
    matches the reference's. Returns (w_vertex, w_context, loss); loss is
    the mean cross-entropy over the first min(1024, B) rows.

    src_group > 1: ``src`` is ``repeat_interleave(src_small, G)``; the
    source rows are gathered once per group and the source delta is summed
    per group before its scatter.

    use_pallas: the gradients go through ``ops.sgns.sgns_shared_grads``
    (the port of K1: the CUDA kernel for CUDA tensors, its plain twin for
    CPU tensors) when mask is None, reg is 0 and B % min(1024, B) == 0, as
    in the JAX package."""
    B = src.shape[0]
    if src_group > 1:
        if B % src_group:
            raise ValueError(f"batch {B} not divisible by src_group "
                             f"{src_group}")
        src_small = src[::src_group]
        v = w_vertex[src_small].repeat_interleave(src_group, dim=0)
    else:
        v = w_vertex[src]
    d_src, d_pos, d_neg, loss = _shared_negs_deltas(
        v, w_context[pos], w_context[negs], alpha, k_equiv, mask, reg,
        use_pallas)

    if src_group > 1:
        d_src = d_src.reshape(B // src_group, src_group, -1).sum(1)
        src_entry = (src_small, d_src)
    else:
        src_entry = (src, d_src, mask)

    if shared_table:
        w = scatter_apply(w_vertex, [src_entry, (pos, d_pos, mask),
                                     (negs, d_neg)], collision)
        return w, w, loss
    scatter_apply(w_context, [(pos, d_pos, mask), (negs, d_neg)], collision)
    if update_vertex:
        scatter_apply(w_vertex, [src_entry], collision)
    return w_vertex, w_context, loss


# --------------------------------------------------------------------- #
# BANDED shared-negatives SGNS: the large-table routes. The draws put every
# positive context of a batch in ONE band of rows (and, with 2D strata,
# every source in one band of the vertex table); the TPU sliced those bands
# out at traced starts to scatter at small-table cost and band-split the
# negatives and order-1 sources. Here every table is indexed at global rows
# (the sums are the same), the band start stays a device tensor, and only
# the kernels K2 (``pallas_scatter``) and K3 (``fused``) take band-local ids.
# --------------------------------------------------------------------- #
def sgns_shared_negs_step_banded(
    w_vertex: torch.Tensor,  # (Np, D); IS w_context when shared_table
    w_context: torch.Tensor,  # (Np, D), Np padded to a band multiple
    band_start: torch.Tensor,  # () int, first row of the contexts' band
    band_size: int,  # kept for the JAX call shape; rows are global here
    src: torch.Tensor,  # (B,) repeat layout when src_group > 1
    pos: torch.Tensor,  # (B,) GLOBAL vids, all inside the band
    negs: torch.Tensor,  # (Ks,) global shared negative pool
    alpha,
    k_equiv: int = 5,
    shared_table: bool = False,  # LINE order 1 (1D band tables)
    src_group: int = 1,
    src_band_start: Optional[torch.Tensor] = None,  # 2D strata: every src
    # lies in [src_band_start, +band_size)
    pallas_scatter: bool = False,  # the two big in-band scatter-adds (B
    # pos rows, B/G src rows on 2D tables) through kernel K2
    fused: bool = False,  # 2D ungrouped only: gather, math and scatter in
    # kernel K3, tile by tile
):
    """Semantics = ``sgns_shared_negs_step(collision="sum")`` on the same
    (src, pos, negs); only the scatter routing differs. Updates the tables
    in place; returns (w_vertex, w_context, loss), loss the mean over the
    first min(1024, B) rows (the fused route: over all rows, as in the JAX
    package)."""
    if fused:
        if src_band_start is None or shared_table:
            raise ValueError("the fused kernel covers the 2D two-table "
                             "banded path")
        if src_group != 1:
            raise ValueError("the fused kernel is for the ungrouped path")
        return _sgns_banded_step_fused(
            w_vertex, w_context, band_start, src, pos, negs, alpha, k_equiv,
            src_band_start)
    if shared_table and src_band_start is not None:
        raise ValueError("2D banding is for two-table mode; order 1 uses 1D "
                         "tables")
    B, G = src.shape[0], src_group
    if B % G:
        raise ValueError(f"batch {B} not divisible by src_group {G}")
    # every gather before the first scatter: order 1 updates one tensor
    src_x = src[::G] if G > 1 else src
    v = w_vertex[src_x]
    if G > 1:
        v = v.repeat_interleave(G, dim=0)
    d_src, d_pos, d_neg, loss = _shared_negs_deltas(
        v, w_context[pos], w_context[negs], alpha, k_equiv)
    if G > 1:
        d_src = d_src.reshape(B // G, G, -1).sum(1)

    if pallas_scatter:
        band_scatter_add(w_context, band_start, pos - band_start, d_pos)
    else:
        w_context.index_add_(0, pos, d_pos)
    w_context.index_add_(0, negs, d_neg)
    if shared_table:
        w_context.index_add_(0, src_x, d_src)
        return w_context, w_context, loss
    if src_band_start is not None and pallas_scatter:
        band_scatter_add(w_vertex, src_band_start, src_x - src_band_start,
                         d_src)
    else:
        w_vertex.index_add_(0, src_x, d_src)
    return w_vertex, w_context, loss


def _sgns_banded_step_fused(w_vertex, w_context, band_start, src, pos, negs,
                            alpha, k_equiv, src_band_start):
    """The fused route's step: snapshot the negatives' context rows, run
    kernel K3 on both bands, then add the negatives' deltas. Returns
    (w_vertex, w_context, loss_sum / B)."""
    cn = w_context[negs]
    alpha = torch.as_tensor(alpha, dtype=torch.float32,
                            device=w_context.device)
    _, _, d_neg, loss_sum = sgns_banded_fused(
        w_vertex, w_context, src_band_start, band_start,
        src - src_band_start, pos - band_start, cn, alpha, k_equiv=k_equiv)
    w_context.index_add_(0, negs, d_neg)
    return w_vertex, w_context, loss_sum / src.shape[0]


# --------------------------------------------------------------------- #
# Band-PERSISTENT block: the held route. S micro-batches share ONE (source
# band, context band) stratum (``BandedTables.draw_banded_block``). The TPU
# sliced both bands once per block, scanned the S updates against the
# carried slices and wrote them back once; its deviation from S independent
# banded steps is part of the function and is kept here:
#   - negatives OUTSIDE the context band read the block-start table and
#     their deltas apply once, at block end;
#   - in-band negatives stay fresh and their deltas apply per micro-step;
#   - in the fused form EVERY negative reads the block-start snapshot and
#     every d_neg applies at block end.
# The port updates the tables in place at global rows, with the band starts
# on the device, so the block-start snapshot is an explicit gather and the
# in-band test ``0 <= negs - band_start < band_size`` a device mask.
# --------------------------------------------------------------------- #
def sgns_banded_block(
    w_vertex: torch.Tensor,  # (Np, D) order-2 vertex table
    w_context: torch.Tensor,  # (Np, D), Np padded to a band multiple
    src_band_start: torch.Tensor,  # () int: every src lies in this band
    band_start: torch.Tensor,  # () int: every pos lies in this band
    band_size: int,
    src: torch.Tensor,  # (S, B) GLOBAL vids, repeat layout if grouped
    pos: torch.Tensor,  # (S, B) GLOBAL vids inside the context band
    negs: torch.Tensor,  # (S, Ks) global shared negative pools
    alphas: torch.Tensor,  # (S,) per-micro-step rates
    k_equiv: int = 5,
    src_group: int = 1,
    pallas_scatter: bool = False,  # the in-band scatters through K2
    fused: bool = False,  # each micro-step through K3 (group 1 only)
):
    """S held micro-steps (see the block comment above). Updates the tables
    in place; returns (w_vertex, w_context, loss): the mean over steps of
    the 1024-row cross-entropy (fused: of loss_sum / B)."""
    S, Ks = negs.shape
    B, G = src.shape[1], src_group
    D = w_context.shape[1]
    negs_rows = negs.reshape(-1)
    if fused:
        if G != 1:
            raise ValueError("the fused block is for the ungrouped path")
        cn = w_context[negs_rows].reshape(S, Ks, D)  # block-start snapshot
        src_l, pos_l = src - src_band_start, pos - band_start
        d_negs, losses = [], []
        for s in range(S):
            _, _, d_neg, loss_sum = sgns_banded_fused(
                w_vertex, w_context, src_band_start, band_start, src_l[s],
                pos_l[s], cn[s], alphas[s], k_equiv=k_equiv)
            d_negs.append(d_neg)
            losses.append(loss_sum / B)
        w_context.index_add_(0, negs_rows, torch.cat(d_negs))
        return w_vertex, w_context, torch.stack(losses).mean()

    if B % G:
        raise ValueError(f"batch {B} not divisible by src_group {G}")
    negs_l = negs - band_start
    in_band = ((negs_l >= 0) & (negs_l < band_size)).to(torch.float32)
    src_x = src[:, ::G] if G > 1 else src  # (S, B / G)
    if pallas_scatter:
        src_xl, pos_l = src_x - src_band_start, pos - band_start
    d_negs, losses = [], []
    for s in range(S):
        v = w_vertex[src_x[s]]
        if G > 1:
            v = v.repeat_interleave(G, dim=0)
        # Out-of-band context rows are written only at block end, so this
        # gather reads them as the block-start snapshot; in-band rows as
        # the earlier micro-steps left them.
        d_src, d_pos, d_neg, loss = _shared_negs_deltas(
            v, w_context[pos[s]], w_context[negs[s]], alphas[s], k_equiv)
        if G > 1:
            d_src = d_src.reshape(B // G, G, -1).sum(1)
        if pallas_scatter:
            band_scatter_add(w_context, band_start, pos_l[s], d_pos)
            band_scatter_add(w_vertex, src_band_start, src_xl[s], d_src)
        else:
            w_context.index_add_(0, pos[s], d_pos)
            w_vertex.index_add_(0, src_x[s], d_src)
        # in-band negative deltas now (out-of-band rows get + 0)
        w_context.index_add_(0, negs[s], d_neg * in_band[s, :, None])
        d_negs.append(d_neg)
        losses.append(loss)
    out_band = (1.0 - in_band).reshape(-1, 1)
    w_context.index_add_(0, negs_rows, torch.cat(d_negs) * out_band)
    return w_vertex, w_context, torch.stack(losses).mean()
