"""Banded SGNS kernels: the multiblock superstep (K4, LINE's main path), its
banded-negative form (K5, the ``neg_band`` route) and the fused micro-step
(K3, the fused banded route).

Port of ``smore_tpu/ops/pallas_sgns_banded.py::sgns_banded_multiblock``.
S micro-steps run in order; micro-step s updates source band ``sb[s]`` of
the vertex table and context band ``db[s]`` of the context table with the
shared-negative SGNS step, in tiles of TB = min(1024, B) rows that also
run in order (each tile's gather sees the earlier tiles' writes; duplicates
inside a tile sum). ``cn`` is the caller's snapshot of the Ks shared
negatives per step; ``d_neg`` is returned for the caller to apply after the
superstep.

The tables are plain (Np, D) f32 tensors and are UPDATED IN PLACE (the JAX
package donated them to the call). The TPU's 2-row fold, 128-lane layout
and VMEM slab DMA have no counterpart here.

Port of ``sgns_banded_fused`` from the same file: ONE micro-step on the
band starting at row ``sb`` of the vertex table and the band starting at row
``db`` of the context table, in tiles of TB = min(2048, B) rows run in the
same order, returning ``d_neg`` and the loss SUM over all B rows. Band
starts stay on the device (the TPU sliced the bands at traced starts; here
kernel and twin add them to the local ids), so no step reads them back.

Port of ``sgns_banded_multiblock_nb`` from the same file: K4's superstep
where micro-step s draws its Ks negatives from its own nb2-row WINDOW
``nb[s]`` of the context table. Their rows are gathered from the current
table before the step's first tile and their summed deltas added back after
its last tile, so there is no caller snapshot and no deferred ``d_neg``.
The TPU's third slab stream and its conflict flags (which kept overlapping
VMEM copies of one HBM row from losing writes) have no counterpart: grid
barriers inside one launch give the same update order.

Each wrapper runs its plain PyTorch twin (``*_ref``) for CPU tensors and
launches its CUDA kernel for CUDA tensors, or raises; it never falls back.
K4 (``csrc/sgns_banded_multiblock.cu``) and K5
(``csrc/sgns_banded_multiblock_nb.cu``) are each ONE cooperative launch of
the persistent kernel of ``csrc/sgns_banded_superstep.cuh`` per superstep;
its blocks must all be co-resident on the card. K3
(``csrc/sgns_banded_fused.cu``) is one launch of the same kernel per
micro-step: K4's superstep with S = 1, 2048-row tiles and the band start
rows as band indices of size 1. ``K4``, ``K5`` and ``K3`` are their
libraries (``ops.launches.Kernel``), whose ``launches`` count the
launches. Each launch is recorded when the caller
captures a CUDA graph (the card takes a cooperative launch under stream
capture); a launcher sets the kernel's shared-memory limit and sizes its
grid only at its first launch for a (device, Ks, D), which TrainDriver's
eager first call makes, so nothing but the launch is issued under capture.
"""

from __future__ import annotations

import ctypes

import torch

from smore_tpu_torch.ops.launches import Kernel, check_aligned

_MAX_SMEM = 232_448  # bytes of shared memory one H100 block may use
_EPS = 1e-7


def _tile(B: int) -> int:
    return min(1024, B)


def _fused_tile(B: int) -> int:
    return min(2048, B)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# helpers of the persistent superstep kernel's libraries (K4, K5, K3)
_SUPERSTEP_HELPERS = {"smem_bytes": (ctypes.c_size_t, [_I, _I]),
                      "scratch_floats": (ctypes.c_size_t, [_I] * 5),
                      "grid_size": (_I, [_I] * 3)}
K4 = Kernel("sgns_banded_multiblock",
            [_I] + [_P] * 8 + [_I] * 6 + [_F] + [_P] * 4, _SUPERSTEP_HELPERS)
K5 = Kernel("sgns_banded_multiblock_nb",
            [_I] + [_P] * 9 + [_I] * 7 + [_F] + [_P] * 3, _SUPERSTEP_HELPERS)
K3 = Kernel("sgns_banded_fused",
            [_I] + [_P] * 8 + [_I] * 4 + [_F] + [_P] * 4, _SUPERSTEP_HELPERS)


def _check_smem(smem: int, Ks: int, D: int) -> None:
    if smem > _MAX_SMEM:
        raise ValueError(f"Ks={Ks}, D={D} need {smem} B of shared memory "
                         f"per block (at most {_MAX_SMEM})")


def _superstep_smem(kernel: Kernel, Ks: int, D: int) -> None:
    smem = kernel.call("smem_bytes", Ks, D)
    if smem == 0:
        raise ValueError(f"the superstep kernel takes D a multiple of 4 up "
                         f"to 1024, got Ks={Ks}, D={D}")
    _check_smem(smem, Ks, D)


def _tile_ref(wv, wc, rv, rc, cn, a, kscale):
    """One tile of the plain twins: gather rows ``rv`` of wv and ``rc`` of
    wc from the current tables, scatter their deltas in place. Returns the
    tile's (g_neg^T v (Ks, D), loss sum ())."""
    v, cp = wv[rv], wc[rc]
    s_pos = torch.sigmoid((v * cp).sum(1, keepdim=True))
    g_pos = (1.0 - s_pos) * a
    s_neg = torch.sigmoid(v @ cn.T)
    g_neg = s_neg * (-(a * kscale))
    loss = (-torch.log(s_pos + _EPS)).sum() - kscale * torch.log(
        1.0 - s_neg + _EPS).sum()
    d_neg = g_neg.T @ v
    wv.index_add_(0, rv, g_pos * cp + g_neg @ cn)
    wc.index_add_(0, rc, g_pos * v)
    return d_neg, loss


def _check_tables(wv, wc, D: int) -> None:
    for name, t in (("wv", wv), ("wc", wc)):
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != D:
            raise ValueError(f"{name} must be (rows, {D}) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (updated in place)")


def _check_device(*tensors) -> None:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"all tensors must share one device, got {devs}")


def _check(wv, wc, sb, db, src_l, pos_l, cn, alpha):
    if src_l.dim() != 2 or pos_l.shape != src_l.shape:
        raise ValueError(f"src_l/pos_l must be (S, B), got "
                         f"{tuple(src_l.shape)} / {tuple(pos_l.shape)}")
    S, B = src_l.shape
    if cn.dim() != 3 or cn.shape[0] != S:
        raise ValueError(f"cn must be (S={S}, Ks, D), got {tuple(cn.shape)}")
    D = cn.shape[2]
    _check_tables(wv, wc, D)
    if cn.dtype != torch.float32:
        raise ValueError(f"cn must be float32, got {cn.dtype}")
    for name, t in (("sb", sb), ("db", db), ("alpha", alpha)):
        if tuple(t.shape) != (S,):
            raise ValueError(f"{name} must be ({S},), got {tuple(t.shape)}")
    if B % _tile(B) or _tile(B) % 8:
        raise ValueError(f"batch {B} must tile by min(1024, B), a multiple "
                         "of 8")
    _check_device(wv, wc, sb, db, src_l, pos_l, cn, alpha)


def sgns_banded_multiblock_ref(wv, wc, sb, db, src_l, pos_l, cn, alpha,
                               band_size: int, k_equiv: int = 5):
    """Plain PyTorch twin of the kernel: the same loop over micro-steps and
    tiles, with ``index_add_`` for the scatters. Updates wv, wc in place;
    returns (wv, wc, d_neg (S, Ks, D), loss_sum ())."""
    S, B = src_l.shape
    Ks = cn.shape[1]
    TB = _tile(B)
    alpha = alpha.to(torch.float32)
    d_neg = torch.zeros_like(cn)
    loss = torch.zeros((), dtype=torch.float32, device=wv.device)
    for s in range(S):
        for t0 in range(0, B, TB):
            rv = (sb[s] * band_size + src_l[s, t0:t0 + TB]).long()
            rc = (db[s] * band_size + pos_l[s, t0:t0 + TB]).long()
            dn, ls = _tile_ref(wv, wc, rv, rc, cn[s], alpha[s], k_equiv / Ks)
            d_neg[s] += dn
            loss += ls
    return wv, wc, d_neg, loss


def sgns_banded_multiblock(wv, wc, sb, db, src_l, pos_l, cn, alpha,
                           band_size: int, k_equiv: int = 5):
    """One superstep (see the module docstring).

    wv, wc: (Np, D) f32 contiguous tables, updated in place.
    sb, db: (S,) source / context BAND INDICES.
    src_l, pos_l: (S, B) BAND-LOCAL rows, in [0, band_size).
    cn: (S, Ks, D) f32 negative snapshot; alpha: (S,) f32 rates.
    Returns (wv, wc, d_neg (S, Ks, D), loss_sum ()). Indices are not
    bounds-checked on the card (that would synchronise), as on the TPU.
    """
    _check(wv, wc, sb, db, src_l, pos_l, cn, alpha)
    if wv.device.type == "cpu":
        return sgns_banded_multiblock_ref(wv, wc, sb, db, src_l, pos_l, cn,
                                          alpha, band_size, k_equiv)
    if wv.device.type != "cuda":
        raise ValueError(f"no kernel for device {wv.device}")
    S, B = src_l.shape
    Ks, D = cn.shape[1], cn.shape[2]
    TB = _tile(B)
    _superstep_smem(K4, Ks, D)
    check_aligned(wv, wc)
    # Tensors made here are freed when this returns, while the launch may
    # still run: the caching allocator hands their memory only to later work
    # on the same stream, which runs after it. Nothing here launches a
    # kernel of its own when the indices are int32 and cn, alpha f32 and
    # contiguous: the kernel zeroes d_neg and sums the loss itself.
    i32 = [t.to(torch.int32).contiguous() for t in (sb, db, src_l, pos_l)]
    cn = cn.contiguous()
    alpha = alpha.to(torch.float32).contiguous()
    dev = wv.device
    f32 = dict(dtype=torch.float32, device=dev)
    scratch = torch.empty(K4.call("scratch_floats", S, B, TB, Ks, D), **f32)
    d_neg = torch.empty(S, Ks, D, **f32)
    loss = torch.empty((), **f32)
    K4.launch(dev, wv.data_ptr(), wc.data_ptr(),
              *(t.data_ptr() for t in i32), cn.data_ptr(), alpha.data_ptr(),
              S, B, TB, Ks, D, band_size, k_equiv / Ks,
              scratch.data_ptr(), d_neg.data_ptr(), loss.data_ptr())
    return wv, wc, d_neg, loss


def _check_nb(wv, wc, sb, db, nb, src_l, pos_l, negs_l, alpha):
    if src_l.dim() != 2 or pos_l.shape != src_l.shape:
        raise ValueError(f"src_l/pos_l must be (S, B), got "
                         f"{tuple(src_l.shape)} / {tuple(pos_l.shape)}")
    S, B = src_l.shape
    if negs_l.dim() != 2 or negs_l.shape[0] != S or negs_l.shape[1] < 1:
        raise ValueError(f"negs_l must be (S={S}, Ks), got "
                         f"{tuple(negs_l.shape)}")
    D = wv.shape[-1]
    _check_tables(wv, wc, D)
    for name, t in (("sb", sb), ("db", db), ("nb", nb), ("alpha", alpha)):
        if tuple(t.shape) != (S,):
            raise ValueError(f"{name} must be ({S},), got {tuple(t.shape)}")
    if B % _tile(B) or _tile(B) % 8:
        raise ValueError(f"batch {B} must tile by min(1024, B), a multiple "
                         "of 8")
    _check_device(wv, wc, sb, db, nb, src_l, pos_l, negs_l, alpha)


def sgns_banded_multiblock_nb_ref(wv, wc, sb, db, nb, src_l, pos_l, negs_l,
                                  alpha, band_size: int, nb2: int,
                                  k_equiv: int = 5):
    """Plain PyTorch twin of K5: K4's loop over micro-steps and 1024-row
    tiles, with micro-step s's negatives ``wc[nb[s] * nb2 + negs_l[s]]``
    gathered before its first tile and their deltas added (duplicates
    summed) after its last. Updates wv, wc in place; returns (wv, wc,
    loss_sum ()) with the loss summed over all S * B rows."""
    S, B = src_l.shape
    Ks = negs_l.shape[1]
    TB = _tile(B)
    alpha = alpha.to(torch.float32)
    loss = torch.zeros((), dtype=torch.float32, device=wv.device)
    for s in range(S):
        rows = (nb[s] * nb2 + negs_l[s]).long()
        cn = wc[rows]
        d_neg = torch.zeros_like(cn)
        for t0 in range(0, B, TB):
            rv = (sb[s] * band_size + src_l[s, t0:t0 + TB]).long()
            rc = (db[s] * band_size + pos_l[s, t0:t0 + TB]).long()
            dn, ls = _tile_ref(wv, wc, rv, rc, cn, alpha[s], k_equiv / Ks)
            d_neg += dn
            loss += ls
        wc.index_add_(0, rows, d_neg)
    return wv, wc, loss


def sgns_banded_multiblock_nb(wv, wc, sb, db, nb, src_l, pos_l, negs_l,
                              alpha, band_size: int, nb2: int,
                              k_equiv: int = 5):
    """One superstep with banded negatives (K5, see the module docstring).

    wv, wc: (Np, D) f32 contiguous tables, updated in place.
    sb, db: (S,) source / context BAND INDICES; nb: (S,) negative WINDOW
    indices (window w is rows [w * nb2, (w + 1) * nb2) of wc).
    src_l, pos_l: (S, B) BAND-LOCAL rows; negs_l: (S, Ks) WINDOW-LOCAL
    rows, in [0, nb2). alpha: (S,) f32 rates.
    Returns (wv, wc, loss_sum ()). Indices are not bounds-checked on the
    card (that would synchronise), as on the TPU.
    """
    _check_nb(wv, wc, sb, db, nb, src_l, pos_l, negs_l, alpha)
    if wv.device.type == "cpu":
        return sgns_banded_multiblock_nb_ref(wv, wc, sb, db, nb, src_l,
                                             pos_l, negs_l, alpha, band_size,
                                             nb2, k_equiv)
    if wv.device.type != "cuda":
        raise ValueError(f"no kernel for device {wv.device}")
    S, B = src_l.shape
    Ks, D = negs_l.shape[1], wv.shape[1]
    TB = _tile(B)
    _superstep_smem(K5, Ks, D)
    check_aligned(wv, wc)
    # Tensors made here are freed when this returns, while the launch may
    # still run: the caching allocator hands their memory only to later work
    # on the same stream, which runs after it. Nothing here launches a
    # kernel of its own when the indices are int32 and alpha f32.
    i32 = [t.to(torch.int32).contiguous()
           for t in (sb, db, nb, src_l, pos_l, negs_l)]
    alpha = alpha.to(torch.float32).contiguous()
    dev = wv.device
    f32 = dict(dtype=torch.float32, device=dev)
    scratch = torch.empty(K5.call("scratch_floats", S, B, TB, Ks, D), **f32)
    loss = torch.empty((), **f32)
    K5.launch(dev, wv.data_ptr(), wc.data_ptr(),
              *(t.data_ptr() for t in i32), alpha.data_ptr(),
              S, B, TB, Ks, D, band_size, nb2, k_equiv / Ks,
              scratch.data_ptr(), loss.data_ptr())
    return wv, wc, loss


def _check_fused(wv, wc, sb, db, src_l, pos_l, cn, alpha):
    if src_l.dim() != 1 or pos_l.shape != src_l.shape:
        raise ValueError(f"src_l/pos_l must be (B,), got "
                         f"{tuple(src_l.shape)} / {tuple(pos_l.shape)}")
    B = src_l.shape[0]
    if cn.dim() != 2 or cn.dtype != torch.float32:
        raise ValueError(f"cn must be (Ks, D) float32, got "
                         f"{tuple(cn.shape)} {cn.dtype}")
    D = cn.shape[1]
    _check_tables(wv, wc, D)
    for name, t in (("sb", sb), ("db", db), ("alpha", alpha)):
        if t.numel() != 1:
            raise ValueError(f"{name} must hold one value, got "
                             f"{tuple(t.shape)}")
    # the TPU kernel's asserts (pallas_sgns_banded.py:1093-1094)
    if B < 1 or B % _fused_tile(B) or _fused_tile(B) % 8:
        raise ValueError(f"batch {B} must tile by min(2048, B), a multiple "
                         "of 8")
    _check_device(wv, wc, sb, db, src_l, pos_l, cn, alpha)


def sgns_banded_fused_ref(wv, wc, sb, db, src_l, pos_l, cn, alpha,
                          k_equiv: int = 5):
    """Plain PyTorch twin of K3: the same loop over 2048-row tiles, each
    gathering from the current tables. Updates wv, wc in place; returns
    (wv, wc, d_neg (Ks, D), loss_sum ())."""
    B = src_l.shape[0]
    TB = _fused_tile(B)
    a = alpha.to(torch.float32).reshape(())
    kscale = k_equiv / cn.shape[0]
    sb, db = sb.reshape(()), db.reshape(())
    d_neg = torch.zeros_like(cn)
    loss = torch.zeros((), dtype=torch.float32, device=wv.device)
    for t0 in range(0, B, TB):
        rv = (sb + src_l[t0:t0 + TB]).long()
        rc = (db + pos_l[t0:t0 + TB]).long()
        dn, ls = _tile_ref(wv, wc, rv, rc, cn, a, kscale)
        d_neg += dn
        loss += ls
    return wv, wc, d_neg, loss


def sgns_banded_fused(wv, wc, sb, db, src_l, pos_l, cn, alpha,
                      k_equiv: int = 5):
    """One fused banded micro-step (K3, see the module docstring).

    wv, wc: (Np, D) f32 contiguous tables, updated in place.
    sb, db: one-element int tensors, the source / context band START rows.
    src_l, pos_l: (B,) BAND-LOCAL rows; B tiles by min(2048, B).
    cn: (Ks, D) f32 negative snapshot; alpha: one-element f32 tensor.
    On the card D must be a multiple of 4 (rows move as 16-byte vectors).
    Returns (wv, wc, d_neg (Ks, D), loss_sum ()). Indices are not
    bounds-checked on the card (that would synchronise), as on the TPU.
    """
    _check_fused(wv, wc, sb, db, src_l, pos_l, cn, alpha)
    if wv.device.type == "cpu":
        return sgns_banded_fused_ref(wv, wc, sb, db, src_l, pos_l, cn, alpha,
                                     k_equiv)
    if wv.device.type != "cuda":
        raise ValueError(f"no kernel for device {wv.device}")
    B = src_l.shape[0]
    Ks, D = cn.shape
    TB = _fused_tile(B)
    _superstep_smem(K3, Ks, D)
    check_aligned(wv, wc)
    # Tensors made here are freed when this returns, while the launch may
    # still run: the caching allocator hands their memory only to later work
    # on the same stream, which runs after it. Nothing here launches a
    # kernel of its own when the indices are int32 and cn, alpha f32 and
    # contiguous: the kernel zeroes d_neg and sums the loss itself.
    i32 = [t.to(torch.int32).reshape(-1).contiguous()
           for t in (sb, db, src_l, pos_l)]
    cn = cn.contiguous()
    alpha = alpha.to(torch.float32).reshape(1).contiguous()
    dev = wv.device
    f32 = dict(dtype=torch.float32, device=dev)
    scratch = torch.empty(K3.call("scratch_floats", 1, B, TB, Ks, D), **f32)
    d_neg = torch.empty(Ks, D, **f32)
    loss = torch.empty((), **f32)
    K3.launch(dev, wv.data_ptr(), wc.data_ptr(),
              *(t.data_ptr() for t in i32), cn.data_ptr(), alpha.data_ptr(),
              B, TB, Ks, D, k_equiv / Ks,
              scratch.data_ptr(), d_neg.data_ptr(), loss.data_ptr())
    return wv, wc, d_neg, loss
