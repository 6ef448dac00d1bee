"""The update core: gather rows, score, scale, scatter-add.

Port of the SGNS part of ``smore_tpu/ops/update.py`` (``scatter_apply``,
``apply_two_tables``, ``sgns_grads``, ``sgns_step``, ``sgns_step_shared``,
``sgns_shared_negs_step``, and the banded large-table forms
``sgns_shared_negs_step_banded`` / ``_sgns_banded_step_fused`` and the
band-persistent block ``sgns_banded_block``) and of its recommendation
updates (``mf_step``, ``bpr_step``, ``warp_step``, ``skewbpr_step``, their
shared-pool forms ``mf_shared_negs_step``, ``bpr_shared_negs_step``,
``warp_shared_pool_step``, ``skewbpr_shared_negs_step``, and HOP-REC's
``fbpr_step``), and of the rest: ``pu_sgd_step``, ``pu_sigmoid_step``,
``pu_bpr_step``, ``cosine_step``, ``length_step`` and ``grouping_step``.
The rec updates are gathers, per-row dot products, (B, Ks)
products against the shared pool, elementwise math and scatter-adds, all
plain torch ops, as they were plain XLA in the JAX package. A batched step applies every
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
import torch.nn.functional as F

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


# --------------------------------------------------------------------- #
# RECOMMENDATION updates (MF, BPR, WARP, Skew-OPT, HOP-REC). Each computes
# every delta from rows gathered before its first scatter, so the one-table
# models (``shared_table=True``: the same tensor passed as both tables) see
# the batch-start snapshot, as in the JAX package. ``mask`` (B,) 0/1 marks
# the valid samples. Each returns (w_vertex, w_context, loss).
# --------------------------------------------------------------------- #
def _alpha_floor(alpha):
    """max(alpha, 1e-12) as a tensor (alpha may be a float)."""
    return torch.clamp(torch.as_tensor(alpha, dtype=torch.float32),
                       min=1e-12)


def mf_step(w_vertex, w_context, src, pos, negs, alpha, reg: float = 0.01,
            mask: Optional[torch.Tensor] = None, shared_table: bool = False,
            collision: str = "sum"):
    """Matrix factorisation with per-sample negatives ``negs`` (B, K)
    (reference UpdateFactorizedPair): g = alpha * (label - v.c), with the
    L2 shrink alpha * reg on every row, (1 + K) times on the source. The
    loss is the mean squared positive error."""
    v = w_vertex[src]
    cp = w_context[pos]
    cn = w_context[negs]  # (B, K, D)
    g_pos = _maybe_mask((1.0 - (v * cp).sum(-1)) * alpha, mask)
    g_neg = (0.0 - torch.einsum("bd,bkd->bk", v, cn)) * alpha
    if mask is not None:
        g_neg = g_neg * mask[:, None]
    B, K, D = cn.shape
    ar = alpha * reg
    d_src = (g_pos[:, None] * cp + torch.einsum("bk,bkd->bd", g_neg, cn)
             - ar * (1 + K) * v)
    d_pos = g_pos[:, None] * v - ar * cp
    d_neg = g_neg[:, :, None] * v[:, None, :] - ar * cn
    mask_k = None if mask is None else mask.repeat_interleave(K)
    w_vertex, w_context = apply_two_tables(
        w_vertex, w_context, [(src, d_src, mask)],
        [(pos, d_pos, mask), (negs.reshape(-1), d_neg.reshape(B * K, D),
                              mask_k)],
        shared_table=shared_table, collision=collision)
    loss = (g_pos ** 2).mean() / _alpha_floor(alpha) ** 2
    return w_vertex, w_context, loss


def bpr_step(w_vertex, w_context, user, pos, negs, alpha,
             reg_ctx: float = 0.0025, reg_vtx: float = 0.025,
             mask: Optional[torch.Tensor] = None, update_vertex: bool = True,
             shared_table: bool = False, collision: str = "sum"):
    """BPR with R rounds of per-sample negatives ``negs`` (B, R)
    (reference UpdateBPRPair), all rounds against the batch snapshot and
    summed: context rows shrink by alpha * reg_ctx per round, the user row
    by alpha * reg_vtx once."""
    v = w_vertex[user]  # (B, D)
    ci = w_context[pos]  # (B, D)
    cj = w_context[negs]  # (B, R, D)
    diff = ci[:, None, :] - cj
    f = torch.einsum("bd,brd->br", v, diff)
    g = torch.sigmoid(-f) * alpha
    m1 = 1.0
    if mask is not None:
        g = g * mask[:, None]
        m1 = mask[:, None]
    B, R, D = cj.shape
    ar_c = alpha * reg_ctx
    d_ci = g.sum(1)[:, None] * v - ar_c * R * ci * m1
    d_cj = -g[:, :, None] * v[:, None, :] - ar_c * cj * (
        1.0 if mask is None else mask[:, None, None])
    d_v = torch.einsum("br,brd->bd", g, diff) - alpha * reg_vtx * v * m1
    mask_r = None if mask is None else mask.repeat_interleave(R)
    w_vertex, w_context = apply_two_tables(
        w_vertex, w_context, [(user, d_v, mask)],
        [(pos, d_ci, mask), (negs.reshape(-1), d_cj.reshape(B * R, D),
                             mask_r)],
        shared_table=shared_table, update_vertex=update_vertex,
        collision=collision)
    return w_vertex, w_context, F.softplus(-f).mean()


def warp_step(w_vertex, w_context, user, pos, negs, alpha,
              reg: float = 0.0025, mask: Optional[torch.Tensor] = None,
              shared_table: bool = False, collision: str = "sum"):
    """WARP / WSABIE over T candidate negatives ``negs`` (B, T) (reference
    UpdateWARPPair): the FIRST candidate with a margin violation
    v.(ci - cj) < 1 gets one BPR update with L2 alpha * reg on the three
    rows; a sample without a violator is not updated."""
    v = w_vertex[user]
    ci = w_context[pos]
    cj = w_context[negs]  # (B, T, D)
    f = torch.einsum("bd,btd->bt", v, ci[:, None, :] - cj)
    violated = f < 1.0
    any_viol = violated.any(1)
    # the first violator (0 when there is none: masked below); argmax
    # returns the first maximal index and takes no bool tensor on the card
    first = torch.argmax(violated.to(torch.float32), dim=1)
    j = negs.gather(1, first[:, None])[:, 0]
    cjf = w_context[j]  # gathered before any scatter
    diff = ci - cjf
    fsel = (v * diff).sum(-1)
    act = any_viol.to(w_vertex.dtype)
    if mask is not None:
        act = act * mask
    g = torch.sigmoid(-fsel) * alpha * act
    ar = alpha * reg
    d_v = g[:, None] * diff - ar * v * act[:, None]
    d_ci = g[:, None] * v - ar * ci * act[:, None]
    d_cj = -g[:, None] * v - ar * cjf * act[:, None]
    w_vertex, w_context = apply_two_tables(
        w_vertex, w_context, [(user, d_v, act)],
        [(pos, d_ci, act), (j, d_cj, act)],
        shared_table=shared_table, collision=collision)
    loss = (F.relu(1.0 - fsel) * act).sum() / torch.clamp(act.sum(), min=1.0)
    return w_vertex, w_context, loss


def _skew_grad(t, eta: int, omega: float, alpha, succ):
    """Skew-OPT's gradient on t = (x - xi) / omega, clamped below at -2:
    sigmoid(-t^eta) t^(eta-1) / omega, times alpha and the success mask.
    ``eta`` is an int: t may be negative."""
    t = torch.clamp(t, min=-2.0)
    chain = torch.ones_like(t) if eta == 1 else t ** (eta - 1)
    return torch.sigmoid(-(t ** eta)) * chain / omega * alpha * succ


def skewbpr_step(w_vertex, w_context, user, pos, negs, alpha,
                 xi: float = 0.0, omega: float = 1.0, eta: int = 1,
                 reg: float = 0.01, mask: Optional[torch.Tensor] = None,
                 shared_table: bool = False, collision: str = "sum"):
    """Skew-OPT over R sequential rounds of per-sample negatives ``negs``
    (B, R) (reference UpdateSBPRPair): a round with t = (x - xi) / omega
    above 2 is skipped; a successful round shrinks ci and cj by alpha * reg
    and applies +/- g v, and ci EVOLVES across the rounds, as the
    reference's in-place updates do. The user delta is the average of
    g (ci - cj) over the successful rounds, shrunk once if any succeeded.
    The loss is the mean per-round softplus(-x)."""
    v = w_vertex[user]
    ci0 = w_context[pos]
    cj = w_context[negs]  # (B, R, D)
    B, R, D = cj.shape
    ar = alpha * reg
    ci = ci0
    ev = torch.zeros_like(ci0)
    n_succ = torch.zeros(B, dtype=w_vertex.dtype, device=w_vertex.device)
    loss = 0.0
    d_cj = []
    for r in range(R):
        cj_r = cj[:, r]
        x = (v * (ci - cj_r)).sum(-1)
        succ = ((x - xi) / omega <= 2.0).to(w_vertex.dtype)
        if mask is not None:
            succ = succ * mask
        g = _skew_grad((x - xi) / omega, eta, omega, alpha, succ)
        d_cj.append((-ar * cj_r - g[:, None] * v) * succ[:, None])
        ev = ev + g[:, None] * (ci - cj_r)
        ci = ci + (-ar * ci + g[:, None] * v) * succ[:, None]
        n_succ = n_succ + succ
        loss = loss + F.softplus(-x).mean()
    any_succ = (n_succ > 0).to(w_vertex.dtype)
    d_v = (ev / torch.clamp(n_succ, min=1.0)[:, None]
           - ar * v * any_succ[:, None])
    mask_r = None if mask is None else mask.repeat_interleave(R)
    w_vertex, w_context = apply_two_tables(
        w_vertex, w_context, [(user, d_v, mask)],
        [(pos, ci - ci0, mask),
         (negs.reshape(-1), torch.stack(d_cj, 1).reshape(B * R, D), mask_r)],
        shared_table=shared_table, collision=collision)
    return w_vertex, w_context, loss / R


# Shared-pool forms: one pool of Ks negatives per step, scored against every
# sample in (B, Ks) products, gradients scaled by k_equiv / Ks so that the
# expected update is the per-sample one.
def bpr_shared_negs_step(w_vertex, w_context, user, pos, negs, alpha,
                         k_equiv: int = 5, reg_ctx: float = 0.0025,
                         reg_vtx: float = 0.025, shared_table: bool = False,
                         collision: str = "sum"):
    """``bpr_step`` against the shared pool ``negs`` (Ks,)."""
    v = w_vertex[user]
    ci = w_context[pos]
    cn = w_context[negs]  # (Ks, D)
    B, Ks = user.shape[0], negs.shape[0]
    f_i = (v * ci).sum(-1)
    f_j = v @ cn.T  # (B, Ks)
    g = torch.sigmoid(f_j - f_i[:, None]) * (alpha * (k_equiv / Ks))
    ar_c = alpha * reg_ctx
    gs = g.sum(1)
    d_ci = gs[:, None] * v - ar_c * k_equiv * ci
    d_cn = -(g.T @ v) - (ar_c * (B * k_equiv / Ks)) * cn
    d_v = gs[:, None] * ci - g @ cn - alpha * reg_vtx * v
    w_vertex, w_context = apply_two_tables(
        w_vertex, w_context, [(user, d_v, None)],
        [(pos, d_ci, None), (negs, d_cn, None)],
        shared_table=shared_table, collision=collision)
    return w_vertex, w_context, F.softplus(f_j - f_i[:, None]).mean()


def mf_shared_negs_step(w_vertex, w_context, src, pos, negs, alpha,
                        k_equiv: int = 5, reg: float = 0.01,
                        shared_table: bool = False, collision: str = "sum"):
    """``mf_step`` against the shared pool ``negs`` (Ks,)."""
    v = w_vertex[src]
    cp = w_context[pos]
    cn = w_context[negs]
    B, Ks = src.shape[0], negs.shape[0]
    g_pos = (1.0 - (v * cp).sum(-1)) * alpha
    g_neg = (0.0 - v @ cn.T) * (alpha * (k_equiv / Ks))
    ar = alpha * reg
    d_src = g_pos[:, None] * cp + g_neg @ cn - ar * (1 + k_equiv) * v
    d_pos = g_pos[:, None] * v - ar * cp
    d_cn = g_neg.T @ v - ar * (B * k_equiv / Ks) * cn
    w_vertex, w_context = apply_two_tables(
        w_vertex, w_context, [(src, d_src, None)],
        [(pos, d_pos, None), (negs, d_cn, None)],
        shared_table=shared_table, collision=collision)
    loss = (g_pos ** 2).mean() / _alpha_floor(alpha) ** 2
    return w_vertex, w_context, loss


def warp_shared_pool_step(w_vertex, w_context, user, pos, negs, u, alpha,
                          trials: int = 32, reg: float = 0.0025,
                          shared_table: bool = False,
                          collision: str = "sum"):
    """``warp_step`` against the shared pool ``negs`` (Ks,) with the trial
    loop marginalised: over iid draws from the pool the first violator is
    a uniformly random member of the violating set, and an update happens
    with probability 1 - (1 - v)^trials, v the violating fraction. ``u``
    (B, Ks + 1) uniforms: [:, :Ks] pick the violator (the argmax of the
    uniforms masked to the violators), [:, Ks] gates the update."""
    v = w_vertex[user]
    ci = w_context[pos]
    cn = w_context[negs]  # (Ks, D)
    Ks = negs.shape[0]
    f_i = (v * ci).sum(-1)
    violated = (f_i[:, None] - v @ cn.T) < 1.0  # (B, Ks)
    vfrac = violated.to(torch.float32).mean(1)
    p_hit = 1.0 - (1.0 - vfrac) ** trials
    act = (u[:, Ks] < p_hit).to(w_vertex.dtype)
    k_sel = torch.argmax(u[:, :Ks].masked_fill(~violated, -1.0), dim=1)
    j = negs[k_sel]  # (B,) vids
    cjf = cn[k_sel]
    diff = ci - cjf
    fsel = (v * diff).sum(-1)
    g = torch.sigmoid(-fsel) * alpha * act
    ar = alpha * reg
    d_v = g[:, None] * diff - ar * v * act[:, None]
    d_ci = g[:, None] * v - ar * ci * act[:, None]
    d_cj = -g[:, None] * v - ar * cjf * act[:, None]
    w_vertex, w_context = apply_two_tables(
        w_vertex, w_context, [(user, d_v, act)],
        [(pos, d_ci, act), (j, d_cj, act)],
        shared_table=shared_table, collision=collision)
    loss = (F.relu(1.0 - fsel) * act).sum() / torch.clamp(act.sum(), min=1.0)
    return w_vertex, w_context, loss


def skewbpr_shared_negs_step(w_vertex, w_context, user, pos, negs, alpha,
                             k_equiv: int = 16, xi: float = 0.0,
                             omega: float = 1.0, eta: int = 1,
                             reg: float = 0.01, shared_table: bool = False,
                             collision: str = "sum"):
    """``skewbpr_step`` against the shared pool ``negs`` (Ks,): each of the
    k_equiv sequential rounds is taken in expectation over the pool
    (weight 1 / Ks), the positive row evolving across the rounds; the
    pool's delta accumulates over them."""
    v = w_vertex[user]
    ci0 = w_context[pos]
    cn = w_context[negs]  # (Ks, D)
    B, Ks = user.shape[0], negs.shape[0]
    ar = alpha * reg
    w_pool = 1.0 / Ks
    f_cn = v @ cn.T  # (B, Ks)
    ci = ci0
    ev = torch.zeros_like(ci0)
    n_succ = torch.zeros(B, dtype=w_vertex.dtype, device=w_vertex.device)
    d_cn = torch.zeros_like(cn)
    loss = 0.0
    for _ in range(k_equiv):
        x = (v * ci).sum(-1)[:, None] - f_cn  # (B, Ks)
        succ = ((x - xi) / omega <= 2.0).to(w_vertex.dtype)
        g = _skew_grad((x - xi) / omega, eta, omega, alpha, succ)
        succ_b = succ.sum(1) * w_pool  # expected success per round
        g_sum = g.sum(1) * w_pool
        d_cn = d_cn - w_pool * (g.T @ v + ar * succ.sum(0)[:, None] * cn)
        ev = ev + g_sum[:, None] * ci - w_pool * (g @ cn)
        ci = ci + (-ar * ci * succ_b[:, None] + g_sum[:, None] * v)
        n_succ = n_succ + succ_b
        loss = loss + F.softplus(-x).mean()
    any_succ = (n_succ > 0).to(w_vertex.dtype)
    d_v = (ev / torch.clamp(n_succ, min=1.0)[:, None]
           - ar * v * any_succ[:, None])
    w_vertex, w_context = apply_two_tables(
        w_vertex, w_context, [(user, d_v, None)],
        [(pos, ci - ci0, None), (negs, d_cn, None)],
        shared_table=shared_table, collision=collision)
    return w_vertex, w_context, loss / k_equiv


def fbpr_step(w_vertex, w_context, user, pos, negs, alpha, margin,
              reg_ctx: float = 0.0025, reg_vtx: float = 0.025,
              mask: Optional[torch.Tensor] = None, shared_table: bool = False,
              collision: str = "sum"):
    """Margin-filtered BPR (HOP-REC; reference UpdateFBPRPair) over R
    rounds of ``negs`` (B, R). ``alpha`` and ``margin`` are scalars or (B,)
    per-pair vectors. A round with f = v.(ci - cj) above the margin is
    skipped, its shrink and update both; the user delta is averaged over
    the active rounds and shrunk once if any was active."""
    v = w_vertex[user]
    ci = w_context[pos]
    cj = w_context[negs]  # (B, R, D)
    B, R, D = cj.shape
    dt, dev = w_vertex.dtype, w_vertex.device
    alpha_b = torch.as_tensor(alpha, dtype=dt, device=dev).expand(B)
    margin_b = torch.as_tensor(margin, dtype=dt, device=dev).expand(B)
    diff = ci[:, None, :] - cj
    f = torch.einsum("bd,brd->br", v, diff)
    active = (f <= margin_b[:, None]).to(dt)
    g = torch.sigmoid(-f) * alpha_b[:, None] * active
    if mask is not None:
        g = g * mask[:, None]
        active = active * mask[:, None]
    n_act = active.sum(-1)
    act_any = (n_act > 0).to(dt)
    ar_c = (alpha_b * reg_ctx)[:, None]
    d_ci = g.sum(1)[:, None] * v - ar_c * n_act[:, None] * ci
    d_cj = (-g[:, :, None] * v[:, None, :]
            - ar_c[:, :, None] * cj * active[:, :, None])
    d_v = (torch.einsum("br,brd->bd", g, diff)
           / torch.clamp(n_act, min=1.0)[:, None]
           - (alpha_b * reg_vtx)[:, None] * v * act_any[:, None])
    mask_r = None if mask is None else mask.repeat_interleave(R)
    w_vertex, w_context = apply_two_tables(
        w_vertex, w_context, [(user, d_v, mask)],
        [(pos, d_ci, mask), (negs.reshape(-1), d_cj.reshape(B * R, D),
                             mask_r)],
        shared_table=shared_table, collision=collision)
    return w_vertex, w_context, F.softplus(-f).mean()


# The rest of the JAX package's updates: the positive-unlabeled forms, the
# cosine and the norm-product updates and the grouping pair. No JAX model
# calls them; they are ported so that ops/update.py is whole.
def pu_sgd_step(w_vertex, w_context, src, ctx, labels, alpha,
                reg: float = 0.01, mask: Optional[torch.Tensor] = None,
                collision: str = "sum"):
    """Positive-unlabeled MF (reference Opt_PUSGD): g = label - v.c; a
    positive (label 1) takes the risk-weighted gradient alpha * g + 1, an
    unlabeled one g; both rows shrink by alpha * reg. The loss is the mean
    of g squared."""
    v = w_vertex[src]
    c = w_context[ctx]
    f = (v * c).sum(-1)
    g = labels - f
    gw = _maybe_mask(torch.where(labels == 1.0, alpha * g + 1.0, g), mask)
    m1 = 1.0 if mask is None else mask[:, None]
    d_v = alpha * (gw[:, None] * c - reg * v * m1)
    d_c = alpha * (gw[:, None] * v - reg * c * m1)
    w_vertex, w_context = apply_two_tables(
        w_vertex, w_context, [(src, d_v, mask)], [(ctx, d_c, mask)],
        collision=collision)
    return w_vertex, w_context, (g * g).mean()


def pu_sigmoid_step(w_vertex, w_context, src, ctx, labels, alpha,
                    reg: float = 0.0025,
                    mask: Optional[torch.Tensor] = None,
                    collision: str = "sum"):
    """Positive-unlabeled sigmoid SGD (reference Opt_PUSigmoidSGD): a
    positive moves v by alpha (sigmoid(-f) + 2 alpha) c and c by
    alpha sigmoid(-f) v, an unlabeled pair both by -alpha sigmoid(f) times
    the other row; every row shrinks by alpha * reg."""
    v = w_vertex[src]
    c = w_context[ctx]
    f = (v * c).sum(-1)
    is_pos = labels == 1.0
    s_neg_f = torch.sigmoid(-f)
    s_pos_f = torch.sigmoid(f)
    m1 = 1.0 if mask is None else mask[:, None]
    gv_pos = alpha * (s_neg_f + 2.0 * alpha)
    gc_pos = alpha * s_neg_f
    d_v = torch.where(is_pos[:, None], gv_pos[:, None] * c - alpha * reg * v,
                      -(alpha * s_pos_f)[:, None] * c - alpha * reg * v) * m1
    d_c = torch.where(is_pos[:, None], gc_pos[:, None] * v - alpha * reg * c,
                      -(alpha * s_pos_f)[:, None] * v - alpha * reg * c) * m1
    w_vertex, w_context = apply_two_tables(
        w_vertex, w_context, [(src, d_v, mask)], [(ctx, d_c, mask)],
        collision=collision)
    ce = torch.where(is_pos, -torch.log(torch.sigmoid(f) + _EPS),
                     -torch.log(1.0 - torch.sigmoid(f) + _EPS))
    if mask is None:
        return w_vertex, w_context, ce.mean()
    return w_vertex, w_context, (ce * mask).sum() / torch.clamp(mask.sum(),
                                                                min=1.0)


def pu_bpr_step(w_vertex, w_context, user, pos, negs, alpha,
                mask: Optional[torch.Tensor] = None,
                shared_table: bool = False, collision: str = "sum"):
    """Positive-unlabeled BPR (reference Opt_PUBPRSGD): its live branch is
    ``bpr_step`` with both L2 weights 0 (the PU reweighting is commented
    out in the reference)."""
    return bpr_step(w_vertex, w_context, user, pos, negs, alpha, reg_ctx=0.0,
                    reg_vtx=0.0, mask=mask, shared_table=shared_table,
                    collision=collision)


def _norms(v, c, eps: float = 1e-8):
    return (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + eps,
            torch.linalg.vector_norm(c, dim=-1, keepdim=True) + eps)


def _two_table_masked(w_vertex, w_context, src, pos, negs, d_v, d_cp, d_cn,
                      mask, collision):
    """Scatter a (src, pos, negs (B, K)) update whose deltas are already
    computed: the masked rows are zeroed, the context table first."""
    if mask is not None:
        d_v = d_v * mask[:, None]
        d_cp = d_cp * mask[:, None]
        d_cn = d_cn * mask[:, None, None]
    B, K, D = d_cn.shape
    mask_k = None if mask is None else mask.repeat_interleave(K)
    scatter_apply(w_context, [(pos, d_cp, mask),
                              (negs.reshape(-1), d_cn.reshape(B * K, D),
                               mask_k)], collision)
    scatter_apply(w_vertex, [(src, d_v, mask)], collision)
    return w_vertex, w_context


def cosine_step(w_vertex, w_context, src, pos, negs, alpha,
                mask: Optional[torch.Tensor] = None, collision: str = "sum"):
    """Cosine-similarity SGD (reference UpdateCosinePair on
    Opt_CosineSGD): the positive pair pulled toward cosine 1, each of the
    K negatives ``negs`` (B, K) toward -1, with the gradient of
    (label - cos(v, c)) on both rows. The loss is the two mean squared
    errors."""

    def cos_deltas(v, c, label):
        vl, cl = _norms(v, c)
        f = (v * c).sum(-1, keepdim=True) / (vl * cl)
        err = (label - f) * alpha
        d_v = err * (c / (vl * cl) - v * f / (vl * vl))
        d_c = err * (v / (vl * cl) - c * f / (cl * cl))
        return d_v, d_c, f

    v = w_vertex[src]
    cp = w_context[pos]
    cn = w_context[negs]  # (B, K, D)
    d_v1, d_cp, f_pos = cos_deltas(v, cp, 1.0)
    d_v2, d_cn, f_neg = cos_deltas(v[:, None, :], cn, -1.0)
    w_vertex, w_context = _two_table_masked(
        w_vertex, w_context, src, pos, negs, d_v1 + d_v2.sum(1), d_cp, d_cn,
        mask, collision)
    loss = ((1.0 - f_pos) ** 2).mean() + ((-1.0 - f_neg) ** 2).mean()
    return w_vertex, w_context, loss


def length_step(w_vertex, w_context, src, pos, negs, alpha,
                mask: Optional[torch.Tensor] = None, collision: str = "sum"):
    """Norm-product SGD (reference UpdateLengthPair on Opt_LengthSGD):
    gradient DESCENT on (|v| |c| - label)^2, label 1 for the positive and 0
    for the K negatives ``negs`` (B, K), so each delta is minus the
    gradient. The loss is the two mean squared errors."""

    def len_deltas(v, c, label):
        vl, cl = _norms(v, c)
        vc = vl * cl
        d_v = -alpha * 2.0 * v * cl * (vc - label) / vl
        d_c = -alpha * 2.0 * c * vl * (vc - label) / cl
        return d_v, d_c, vc

    v = w_vertex[src]
    cp = w_context[pos]
    cn = w_context[negs]
    d_v1, d_cp, vc_pos = len_deltas(v, cp, 1.0)
    d_v2, d_cn, vc_neg = len_deltas(v[:, None, :], cn, 0.0)
    w_vertex, w_context = _two_table_masked(
        w_vertex, w_context, src, pos, negs, d_v1 + d_v2.sum(1), d_cp, d_cn,
        mask, collision)
    loss = ((vc_pos - 1.0) ** 2).mean() + (vc_neg ** 2).mean()
    return w_vertex, w_context, loss


def grouping_step(w_vertex, w_context, vgroup, cgroup, labels, alpha,
                  reg: float = 0.01, mask: Optional[torch.Tensor] = None,
                  shared_table: bool = False, collision: str = "sum"):
    """The grouping pair (reference UpdateGroupingPair): one Opt_SGD step on
    the SUM of a group of vertex rows ``vgroup`` (B, Gv) against the sum of
    context rows ``cgroup`` (B, Gc), g = alpha * (label - f), and the same
    back-error added to every member of each group. The loss is the mean
    squared error."""
    v_sum = w_vertex[vgroup].sum(1)
    c_sum = w_context[cgroup].sum(1)
    f = (v_sum * c_sum).sum(-1)
    g = _maybe_mask((labels - f) * alpha, mask)
    m1 = 1.0 if mask is None else mask[:, None]
    d_v = g[:, None] * c_sum - alpha * reg * v_sum * m1
    d_c = g[:, None] * v_sum - alpha * reg * c_sum * m1
    B, Gv = vgroup.shape
    Gc = cgroup.shape[1]
    D = d_v.shape[-1]
    mask_v = None if mask is None else mask.repeat_interleave(Gv)
    mask_c = None if mask is None else mask.repeat_interleave(Gc)
    w_vertex, w_context = apply_two_tables(
        w_vertex, w_context,
        [(vgroup.reshape(-1), d_v[:, None, :].expand(B, Gv, D).reshape(
            B * Gv, D), mask_v)],
        [(cgroup.reshape(-1), d_c[:, None, :].expand(B, Gc, D).reshape(
            B * Gc, D), mask_c)],
        shared_table=shared_table, collision=collision)
    return w_vertex, w_context, ((labels - f) ** 2).mean()
