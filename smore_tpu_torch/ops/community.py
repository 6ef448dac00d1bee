"""Community, CBOW and choice updates: the kernels that aggregate several
rows per sample.

Port of ``smore_tpu/ops/community.py``:

- ``cbow_step``: the reference's UpdateCBOW, a neighbour-SUM CBOW (GCN,
  TEXTGCN);
- ``dchoice_step``: UpdateDChoice, ECO's softmax choice over {1-hop context
  (weight 2), 3-hop context, negatives};
- ``choice_softmax_step`` (with its aliases ``recall_rank_step`` and
  ``hop_choice_step``), ``raw_choice_step`` and ``choice_step``: the other
  choice updates;
- ``field_community_step`` (alias ``fields_community_step``): FINE's
  field-projected SGNS along a context walk, shadow row vid * F + fid, and
  msFINE's variant;
- the shared-pool forms ``cbow_step_shared_negs``,
  ``dchoice_step_shared_negs``, ``choice_softmax_step_shared_negs`` and
  ``field_community_step_shared_negs``: one pool of Kp negatives scored
  against the whole batch in (B, Kp) products, its mass scaled by
  k_equiv / Kp.

Every function computes all of its deltas, and its loss, from rows gathered
before its first scatter, then adds them IN PLACE with ``scatter_apply``
(the JAX package returned new arrays); so a batch sees the tables as they
were at its start, as in the JAX package, and a function that writes two
tables reads neither after writing one. Gathers, sums over a gathered axis,
per-row dots, (B, Kp) ``matmul`` products, elementwise math and
``index_add_``: plain torch ops, as they were plain XLA there.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as TF

from smore_tpu_torch.ops.update import scatter_apply

_EPS = 1e-7


def _rep(x: torch.Tensor, s: int) -> torch.Tensor:
    """(R, D) -> (R * s, D): each row repeated s times in a row."""
    r, d = x.shape
    return x[:, None, :].expand(r, s, d).reshape(r * s, d)


def _masked_mean(ce: torch.Tensor, mask: Optional[torch.Tensor]):
    if mask is None:
        return ce.mean()
    return (ce * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def cbow_step(w, vctx, cctx, neg_sets, alpha, reg: float = 0.01,
              mask: Optional[torch.Tensor] = None, collision: str = "sum"):
    """UpdateCBOW on one table ``w``: w_avg = SUM of the ``vctx`` (B, S)
    rows, c_avg = SUM of the ``cctx`` (B, S) rows; a sigmoid step of label 1
    on w_avg . c_avg and of label 0 against each of the K negative sets
    ``neg_sets`` (B, K, S) (summed the same way); every member of a set
    receives its set's delta, the vertex side the accumulated error.
    Returns (w, loss)."""
    B, S = vctx.shape
    K = neg_sets.shape[1]
    m1 = 1.0 if mask is None else mask[:, None]
    wa = w[vctx].sum(1)  # (B, D)
    ca = w[cctx].sum(1)
    na = w[neg_sets].sum(2)  # (B, K, D)
    f_pos = (wa * ca).sum(-1)
    g_pos = 1.0 - torch.sigmoid(f_pos)
    f_neg = torch.einsum("bd,bkd->bk", wa, na)
    g_neg = -torch.sigmoid(f_neg)
    if mask is not None:
        g_pos = g_pos * mask
        g_neg = g_neg * mask[:, None]
    d_w = alpha * (g_pos[:, None] * ca + torch.einsum("bk,bkd->bd", g_neg, na)
                   - reg * (1 + K) * wa * m1)
    d_c = alpha * (g_pos[:, None] * wa - reg * ca * m1)
    m2 = 1.0 if mask is None else mask[:, None, None]
    d_n = alpha * (g_neg[:, :, None] * wa[:, None, :] - reg * na * m2)
    loss = -torch.log(torch.sigmoid(f_pos) + _EPS).mean() - torch.log(
        1 - torch.sigmoid(f_neg) + _EPS).sum(-1).mean()
    mask_s = None if mask is None else mask.repeat_interleave(S)
    mask_ks = None if mask is None else mask.repeat_interleave(K * S)
    scatter_apply(w, [
        (vctx.reshape(-1), _rep(d_w, S), mask_s),
        (cctx.reshape(-1), _rep(d_c, S), mask_s),
        (neg_sets.reshape(-1), _rep(d_n.reshape(B * K, -1), S), mask_ks),
    ], collision)
    return w, loss


def _dchoice_deltas(v, w1, w2, e1, e2, z, z_pos, dev, alpha, reg: float):
    """UpdateDChoice's deltas of the vertex and the two contexts."""
    d_v = alpha * ((2.0 * w1 * e1[:, None] + w2 * e2[:, None])
                   / z_pos[:, None] - dev / z[:, None] - reg * v)
    d_c1 = alpha * ((2.0 * v * e1[:, None]) / z_pos[:, None]
                    - (v * e1[:, None]) / z[:, None] - reg * w1)
    d_c2 = alpha * ((v * e2[:, None]) / z_pos[:, None]
                    - (v * e2[:, None]) / z[:, None] - reg * w2)
    return d_v, d_c1, d_c2


def dchoice_step(w, vertex, c1, c2, negs, alpha, reg: float = 0.01,
                 collision: str = "sum"):
    """UpdateDChoice (ECO) on one table: a softmax over {c1 (weight 2), c2,
    the K negatives ``negs`` (B, K)} scored by exp(v . row). Returns (w,
    loss)."""
    v = w[vertex]
    w1 = w[c1]
    w2 = w[c2]
    wn = w[negs]  # (B, K, D)
    e1 = torch.exp((v * w1).sum(-1))
    e2 = torch.exp((v * w2).sum(-1))
    en = torch.exp(torch.einsum("bd,bkd->bk", v, wn))
    z_pos = 2.0 * e1 + e2
    z = e1 + e2 + en.sum(-1)
    dev = (w1 * e1[:, None] + w2 * e2[:, None]
           + torch.einsum("bk,bkd->bd", en, wn))
    d_v, d_c1, d_c2 = _dchoice_deltas(v, w1, w2, e1, e2, z, z_pos, dev, alpha,
                                      reg)
    d_n = -alpha * (v[:, None, :] * en[..., None] / z[:, None, None]
                    + reg * wn)
    B, K, D = d_n.shape
    scatter_apply(w, [(vertex, d_v), (c1, d_c1), (c2, d_c2),
                      (negs.reshape(-1), d_n.reshape(B * K, D))], collision)
    loss = -torch.log(torch.clamp(z_pos / (2.0 * z), min=1e-9)).mean()
    return w, loss


def choice_softmax_step(w, vertex, pos, negs, alpha, reg: float = 0.01,
                        mask: Optional[torch.Tensor] = None,
                        collision: str = "sum"):
    """The single-table sampled-softmax choice update (UpdateHOPChoice, and
    UpdateRecallRank with its rounds folded into the batch by the caller):
    Z = exp(u . pos) + sum exp(u . neg) over ``negs`` (B, K); every row
    shrinks by alpha * reg. Returns (w, loss)."""
    u = w[vertex]
    c = w[pos]
    n = w[negs]  # (B, K, D)
    e_pos = torch.exp((u * c).sum(-1))
    e_neg = torch.exp(torch.einsum("bd,bkd->bk", u, n))
    z = e_pos + e_neg.sum(-1)
    dev = c * e_pos[:, None] + torch.einsum("bk,bkd->bd", e_neg, n)
    m1 = 1.0 if mask is None else mask[:, None]
    d_u = alpha * (c - dev / z[:, None] - reg * u) * m1
    d_c = alpha * (u - u * (e_pos / z)[:, None] - reg * c) * m1
    d_n = -alpha * (u[:, None, :] * (e_neg / z[:, None])[..., None]
                    + reg * n) * (1.0 if mask is None
                                  else mask[:, None, None])
    B, K, D = d_n.shape
    mask_k = None if mask is None else mask.repeat_interleave(K)
    scatter_apply(w, [(vertex, d_u, mask), (pos, d_c, mask),
                      (negs.reshape(-1), d_n.reshape(B * K, D), mask_k)],
                  collision)
    ce = -torch.log(torch.clamp(e_pos / z, min=1e-9))
    return w, _masked_mean(ce, mask)


# UpdateRecallRank is choice_softmax_step with 5 rounds of (pos =
# TargetSample(vertex), field-matched negatives) folded into the batch;
# UpdateHOPChoice is the same formula.
recall_rank_step = choice_softmax_step
hop_choice_step = choice_softmax_step


def raw_choice_step(w_vertex, w_context, vertex, pos, negs, alpha,
                    reg: float = 0.01, mask: Optional[torch.Tensor] = None,
                    collision: str = "sum"):
    """UpdateRAWChoice: choice scores sigmoid(-f) instead of exp(f), with
    the reference's written updates (Z = s_pos + sum s_k):
    d_u = alpha (c s_pos - (c s_pos + sum n_k s_k) - reg u),
    d_pos = alpha (u s_pos - u Z - reg c), d_negk = -alpha (u Z + reg n_k).
    Returns (w_vertex, w_context, loss)."""
    u = w_vertex[vertex]
    c = w_context[pos]
    n = w_context[negs]
    s_pos = torch.sigmoid(-(u * c).sum(-1))
    s_neg = torch.sigmoid(-torch.einsum("bd,bkd->bk", u, n))
    z = s_pos + s_neg.sum(-1)
    dev = c * s_pos[:, None] + torch.einsum("bk,bkd->bd", s_neg, n)
    m1 = 1.0 if mask is None else mask[:, None]
    d_u = alpha * (c * s_pos[:, None] - dev - reg * u) * m1
    d_c = alpha * (u * s_pos[:, None] - u * z[:, None] - reg * c) * m1
    d_n = -alpha * (u[:, None, :] * z[:, None, None] + reg * n) * (
        1.0 if mask is None else mask[:, None, None])
    B, K, D = d_n.shape
    mask_k = None if mask is None else mask.repeat_interleave(K)
    scatter_apply(w_context, [(pos, d_c, mask),
                              (negs.reshape(-1), d_n.reshape(B * K, D),
                               mask_k)], collision)
    scatter_apply(w_vertex, [(vertex, d_u, mask)], collision)
    ce = -torch.log(torch.clamp(s_pos / torch.clamp(z, min=1e-9), min=1e-9))
    return w_vertex, w_context, _masked_mean(ce, mask)


def choice_step(w_vertex, w_ignore, vertex, pos2, negs1, negs2, alpha,
                reg: float = 0.01, collision: str = "sum"):
    """UpdateChoice. Phase 1, R1 rounds: a softmax between the vertex's own
    row in the ``w_ignore`` table (positive) and the K negatives of
    ``negs1`` (B, R1, K) from the vertex table; its vertex-side error is
    not applied there but carried into the final write. Phase 2: a softmax
    with ``pos2`` as positive and {``negs2`` (B, K2), the ignore row} as
    negatives. All against the batch-start snapshot. Returns (w_vertex,
    w_ignore, loss)."""
    u = w_vertex[vertex]  # (B, D)
    ig = w_ignore[vertex]
    B, R1, K = negs1.shape
    D = u.shape[-1]

    # phase 1, the rounds side by side
    n1 = w_vertex[negs1]  # (B, R1, K, D)
    e_pos1 = torch.exp((u * ig).sum(-1))
    e_neg1 = torch.exp(torch.einsum("bd,brkd->brk", u, n1))
    z1 = e_pos1[:, None] + e_neg1.sum(-1)  # (B, R1)
    dev1 = ig[:, None, :] * e_pos1[:, None, None] + torch.einsum(
        "brk,brkd->brd", e_neg1, n1)
    back_v = (alpha * (ig[:, None, :] - dev1 / z1[..., None]
                       - reg * u[:, None, :])).sum(1)
    d_ig = alpha * (u * R1 - u * (e_pos1[:, None] / z1).sum(-1)[:, None]
                    - reg * ig * R1)
    d_n1 = -alpha * (u[:, None, None, :] * (e_neg1 / z1[..., None])[..., None]
                     + reg * n1)

    # phase 2
    c2 = w_vertex[pos2]
    n2 = w_vertex[negs2]  # (B, K2, D)
    e_pos2 = torch.exp((u * c2).sum(-1))
    e_neg2 = torch.exp(torch.einsum("bd,bkd->bk", u, n2))
    e_ig2 = torch.exp((u * ig).sum(-1))
    z2 = e_pos2 + e_neg2.sum(-1) + e_ig2
    dev2 = (c2 * e_pos2[:, None] + torch.einsum("bk,bkd->bd", e_neg2, n2)
            + ig * e_ig2[:, None])
    back_v = back_v + alpha * (c2 - dev2 / z2[:, None] - reg * u)
    d_c2 = alpha * (u - u * (e_pos2 / z2)[:, None] - reg * c2)
    d_n2 = -alpha * (u[:, None, :] * (e_neg2 / z2[:, None])[..., None]
                     + reg * n2)
    d_ig = d_ig - alpha * (u * (e_ig2 / z2)[:, None] + reg * ig)

    K2 = negs2.shape[1]
    scatter_apply(w_vertex, [
        (vertex, back_v), (pos2, d_c2),
        (negs1.reshape(-1), d_n1.reshape(B * R1 * K, D)),
        (negs2.reshape(-1), d_n2.reshape(B * K2, D)),
    ], collision)
    scatter_apply(w_ignore, [(vertex, d_ig)], collision)
    loss = -torch.log(torch.clamp(e_pos2 / z2, min=1e-9)).mean()
    return w_vertex, w_ignore, loss


def field_project(vids: torch.Tensor, fids: torch.Tensor, n_fields: int):
    """The shadow row of (vertex, field): vid * n_fields + fid (the
    reference materialises these rows; here it is index arithmetic)."""
    return vids * n_fields + fids


def _field_rows(vertex, ctx_walk, fields_of, n_fields: int,
                ms_variant: bool):
    """(v_fid (B,), c_fid (B, S), v_rows (B, S), c_rows (B, S)): the vertex
    projected by each context's field; the context projected by the
    vertex's field, or by its own (msFINE)."""
    v_fid = fields_of[vertex]
    c_fid = fields_of[ctx_walk]
    v_rows = field_project(vertex[:, None], c_fid, n_fields)
    c_rows = field_project(ctx_walk, c_fid if ms_variant else v_fid[:, None],
                           n_fields)
    return v_fid, c_fid, v_rows, c_rows


def _walk_loss(v, c, walk_mask):
    denom = torch.clamp(walk_mask.sum(), min=1.0)
    return (-torch.log(torch.sigmoid((v * c).sum(-1)) + _EPS)
            * walk_mask).sum() / denom


def field_community_step(w_vertex, w_context, vertex, ctx_walk, walk_mask,
                         negs, fields_of, n_fields: int, alpha,
                         reg: float = 0.0, ms_variant: bool = False,
                         collision: str = "sum"):
    """UpdateFieldCommunity on the shadow tables (N * F rows): SGNS of the
    vertex (projected by each context's field) against each position of
    the context walk ``ctx_walk`` (B, S) (projected by the vertex's field)
    and its field-matched negatives ``negs`` (B, S, K), positions masked by
    ``walk_mask``. ``ms_variant`` (UpdateMSFieldCommunity): context and
    negative rows projected by their own field, and reg 0.025 whatever the
    caller passed. Returns (w_vertex, w_context, loss)."""
    B, S = ctx_walk.shape
    K = negs.shape[2]
    v_fid, _, v_rows, c_rows = _field_rows(vertex, ctx_walk, fields_of,
                                           n_fields, ms_variant)
    if ms_variant:
        n_rows = field_project(negs, fields_of[negs], n_fields)
        reg = 0.025
    else:
        n_rows = field_project(negs, v_fid[:, None, None], n_fields)
    v = w_vertex[v_rows]  # (B, S, D)
    c = w_context[c_rows]
    n = w_context[n_rows]  # (B, S, K, D)
    g_pos = (1.0 - torch.sigmoid((v * c).sum(-1))) * walk_mask
    g_neg = -torch.sigmoid(torch.einsum("bsd,bskd->bsk", v, n)) * walk_mask[
        ..., None]
    m2 = walk_mask[..., None]
    d_v = alpha * (g_pos[..., None] * c
                   + torch.einsum("bsk,bskd->bsd", g_neg, n)
                   - reg * (1 + K) * v * m2)
    d_c = alpha * (g_pos[..., None] * v - reg * c * m2)
    d_n = alpha * (g_neg[..., None] * v[:, :, None, :]
                   - reg * n * m2[..., None])
    loss = _walk_loss(v, c, walk_mask)
    D = d_v.shape[-1]
    mask_s = walk_mask.reshape(-1)
    scatter_apply(w_context, [
        (c_rows.reshape(-1), d_c.reshape(B * S, D), mask_s),
        (n_rows.reshape(-1), d_n.reshape(B * S * K, D),
         mask_s.repeat_interleave(K)),
    ], collision)
    scatter_apply(w_vertex, [(v_rows.reshape(-1), d_v.reshape(B * S, D),
                              mask_s)], collision)
    return w_vertex, w_context, loss


# UpdateFieldsCommunity iterates the vertex's fields x the context's fields;
# with one field per vertex (what LoadFieldMeta gives) that is exactly one
# combination, field_community_step's non-ms branch.
fields_community_step = field_community_step


# ------------------------------------------------------ shared-pool forms
# One pool of Kp negatives per step, scored against the whole batch. The
# sigmoid updates (cbow, field community) are additive in their negatives,
# so the k_equiv / Kp scale keeps the per-sample expected update; the
# softmax updates (dchoice, choice softmax) estimate the partition's
# negative mass from the pool at the same scale.
def cbow_step_shared_negs(w, vctx, cctx, neg_pool, alpha, k_equiv: int = 5,
                          reg: float = 0.01,
                          mask: Optional[torch.Tensor] = None,
                          collision: str = "sum"):
    """``cbow_step`` against ONE pool of Kp negative sets ``neg_pool``
    (Kp, S) shared by the batch. Returns (w, loss)."""
    B, S = vctx.shape
    Kp = neg_pool.shape[0]
    scale = k_equiv / Kp
    m1 = 1.0 if mask is None else mask[:, None]
    wa = w[vctx].sum(1)
    ca = w[cctx].sum(1)
    na = w[neg_pool].sum(1)  # (Kp, D)
    f_pos = (wa * ca).sum(-1)
    g_pos = 1.0 - torch.sigmoid(f_pos)
    f_neg = wa @ na.T  # (B, Kp)
    g_neg = -torch.sigmoid(f_neg) * scale
    if mask is not None:
        g_pos = g_pos * mask
        g_neg = g_neg * mask[:, None]
    d_w = alpha * (g_pos[:, None] * ca + g_neg @ na
                   - reg * (1 + k_equiv) * wa * m1)
    d_c = alpha * (g_pos[:, None] * wa - reg * ca * m1)
    # per (sample, set) instance alpha (g wa - reg na), summed over the
    # batch at the pool's scale
    n_inst = (float(B) if mask is None else mask.sum()) * scale
    d_n = alpha * (g_neg.T @ wa - reg * n_inst * na)  # (Kp, D)
    loss = -torch.log(torch.sigmoid(f_pos) + _EPS).mean() - scale * torch.log(
        1 - torch.sigmoid(f_neg) + _EPS).sum(-1).mean()
    mask_s = None if mask is None else mask.repeat_interleave(S)
    scatter_apply(w, [
        (vctx.reshape(-1), _rep(d_w, S), mask_s),
        (cctx.reshape(-1), _rep(d_c, S), mask_s),
        (neg_pool.reshape(-1), _rep(d_n, S), None),
    ], collision)
    return w, loss


def dchoice_step_shared_negs(w, vertex, c1, c2, neg_pool, alpha,
                             k_equiv: int = 5, reg: float = 0.01,
                             collision: str = "sum"):
    """``dchoice_step`` against the shared pool ``neg_pool`` (Kp,): Z's
    negative mass is the pool's sum scaled k_equiv / Kp. Returns (w,
    loss)."""
    Kp = neg_pool.shape[0]
    scale = k_equiv / Kp
    v = w[vertex]
    w1 = w[c1]
    w2 = w[c2]
    wn = w[neg_pool]  # (Kp, D)
    e1 = torch.exp((v * w1).sum(-1))
    e2 = torch.exp((v * w2).sum(-1))
    en = torch.exp(v @ wn.T)  # (B, Kp)
    z_pos = 2.0 * e1 + e2
    z = e1 + e2 + scale * en.sum(-1)
    dev = w1 * e1[:, None] + w2 * e2[:, None] + scale * (en @ wn)
    d_v, d_c1, d_c2 = _dchoice_deltas(v, w1, w2, e1, e2, z, z_pos, dev, alpha,
                                      reg)
    B = v.shape[0]
    wz = en / z[:, None]
    d_n = -alpha * scale * (wz.T @ v + reg * B * wn)
    scatter_apply(w, [(vertex, d_v), (c1, d_c1), (c2, d_c2),
                      (neg_pool, d_n)], collision)
    loss = -torch.log(torch.clamp(z_pos / (2.0 * z), min=1e-9)).mean()
    return w, loss


def choice_softmax_step_shared_negs(w, vertex, pos, neg_pool, alpha,
                                    k_equiv: int = 5, reg: float = 0.01,
                                    mask: Optional[torch.Tensor] = None,
                                    collision: str = "sum"):
    """``choice_softmax_step`` against the shared pool ``neg_pool`` (Kp,).
    Returns (w, loss)."""
    Kp = neg_pool.shape[0]
    scale = k_equiv / Kp
    u = w[vertex]
    c = w[pos]
    n = w[neg_pool]  # (Kp, D)
    e_pos = torch.exp((u * c).sum(-1))
    e_neg = torch.exp(u @ n.T)  # (B, Kp)
    z = e_pos + scale * e_neg.sum(-1)
    dev = c * e_pos[:, None] + scale * (e_neg @ n)
    m1 = 1.0 if mask is None else mask[:, None]
    d_u = alpha * (c - dev / z[:, None] - reg * u) * m1
    d_c = alpha * (u - u * (e_pos / z)[:, None] - reg * c) * m1
    wz = e_neg / z[:, None]
    if mask is not None:
        wz = wz * mask[:, None]
    n_inst = float(u.shape[0]) if mask is None else mask.sum()
    d_n = -alpha * scale * (wz.T @ u + reg * n_inst * n)
    scatter_apply(w, [(vertex, d_u, mask), (pos, d_c, mask),
                      (neg_pool, d_n)], collision)
    ce = -torch.log(torch.clamp(e_pos / z, min=1e-9))
    return w, _masked_mean(ce, mask)


def field_community_step_shared_negs(w_vertex, w_context, vertex, ctx_walk,
                                     walk_mask, neg_pool, fields_of,
                                     n_fields: int, alpha, k_equiv: int = 5,
                                     reg: float = 0.0,
                                     ms_variant: bool = False,
                                     collision: str = "sum"):
    """``field_community_step`` with one shared pool per field:
    ``neg_pool`` (F, Kp) holds field f's draws in row f. Each (sample, walk
    position) scores the pool of its context's field, projected by the
    vertex's field (by the pool's own field with ``ms_variant``), so the
    pools are gathered once as (F_draw, F_proj, Kp) shadow rows and each
    position picks its block by one-hot field masks. The instance counts of
    each block's L2 shrink are scaled by k_equiv / Kp. Returns (w_vertex,
    w_context, loss)."""
    B, S = ctx_walk.shape
    nF, Kp = neg_pool.shape
    scale = k_equiv / Kp
    v_fid, c_fid, v_rows, c_rows = _field_rows(vertex, ctx_walk, fields_of,
                                               n_fields, ms_variant)
    fids = torch.arange(nF, dtype=neg_pool.dtype, device=neg_pool.device)
    if ms_variant:
        reg = 0.025
        # projected by the draw field: only the diagonal blocks are read
        pool_rows = field_project(neg_pool[:, None, :], fids[:, None, None],
                                  n_fields).expand(nF, nF, Kp)
    else:
        pool_rows = field_project(neg_pool[:, None, :], fids[None, :, None],
                                  n_fields)  # (F_draw, F_proj, Kp)
    v = w_vertex[v_rows]  # (B, S, D)
    c = w_context[c_rows]
    npool = w_context[pool_rows]  # (F, F, Kp, D)

    g_pos = (1.0 - torch.sigmoid((v * c).sum(-1))) * walk_mask
    # (b, s) uses draw field c_fid[b, s] and projection field v_fid[b]
    # (msFINE: the draw field)
    oh_c = TF.one_hot(c_fid.long(), nF).to(v.dtype)  # (B, S, F)
    oh_v = TF.one_hot((c_fid if ms_variant
                       else v_fid[:, None].expand(B, S)).long(),
                      nF).to(v.dtype)
    sel = torch.einsum("bsf,bsg->bsfg", oh_c, oh_v)  # (B, S, F, F)
    f_neg = torch.einsum("bsd,fgkd->bsfgk", v, npool)
    g_neg = -torch.sigmoid(f_neg) * (
        sel[..., None] * walk_mask[:, :, None, None, None]) * scale
    m2 = walk_mask[..., None]
    d_v = alpha * (g_pos[..., None] * c
                   + torch.einsum("bsfgk,fgkd->bsd", g_neg, npool)
                   - reg * (1 + k_equiv) * v * m2)
    d_c = alpha * (g_pos[..., None] * v - reg * c * m2)
    # each (b, s) shrinks only its own (draw, projection) block
    inst = torch.einsum("bsfg,bs->fg", sel, walk_mask) * scale  # (F, F)
    d_n = alpha * (torch.einsum("bsfgk,bsd->fgkd", g_neg, v)
                   - reg * inst[:, :, None, None] * npool)
    loss = _walk_loss(v, c, walk_mask)
    D = d_v.shape[-1]
    mask_s = walk_mask.reshape(-1)
    scatter_apply(w_context, [
        (c_rows.reshape(-1), d_c.reshape(B * S, D), mask_s),
        (pool_rows.reshape(-1), d_n.reshape(nF * nF * Kp, D)),
    ], collision)
    scatter_apply(w_vertex, [(v_rows.reshape(-1), d_v.reshape(B * S, D),
                              mask_s)], collision)
    return w_vertex, w_context, loss
