"""Inputs of the banded superstep kernels (K4, K5, and K3, the fused
micro-step) shared by the CPU tests, which hold the plain twins to
smore_tpu's Pallas kernels, tests/test_torch_gpu.py, which holds the CUDA
kernels to the same twins on the card, and chip_smoke.py. numpy only: no
JAX, no torch."""

import numpy as np


def multiblock_inputs(seed, S, B, band, n_bands, Ks, D, sb, db, idx_hi=None,
                      alpha=0.05):
    """K4's arguments: tables of ``n_bands`` bands, band indices sb, db,
    band-local rows below ``idx_hi``, a negative snapshot and rates from
    ``alpha`` down to 0.6 alpha."""
    rng = np.random.default_rng(seed)
    n = band * n_bands
    hi = band if idx_hi is None else idx_hi
    return dict(
        wv=(rng.standard_normal((n, D)) * 0.1).astype(np.float32),
        wc=(rng.standard_normal((n, D)) * 0.1).astype(np.float32),
        sb=np.asarray(sb, np.int32),
        db=np.asarray(db, np.int32),
        src_l=rng.integers(0, hi, (S, B)).astype(np.int32),
        pos_l=rng.integers(0, hi, (S, B)).astype(np.int32),
        cn=(rng.standard_normal((S, Ks, D)) * 0.1).astype(np.float32),
        alpha=np.linspace(alpha, 0.6 * alpha, S).astype(np.float32),
    )


def multiblock_nb_inputs(seed, S, B, band, n_bands, nb2, Ks, D, sb, db, nb,
                         idx_hi=None, neg_hi=None, alpha=0.05):
    """K5's arguments: as K4's, with window indices nb and window-local
    negatives below ``neg_hi`` in place of the snapshot."""
    rng = np.random.default_rng(seed)
    n = band * n_bands
    hi = band if idx_hi is None else idx_hi
    return dict(
        wv=(rng.standard_normal((n, D)) * 0.1).astype(np.float32),
        wc=(rng.standard_normal((n, D)) * 0.1).astype(np.float32),
        sb=np.asarray(sb, np.int32),
        db=np.asarray(db, np.int32),
        nb=np.asarray(nb, np.int32),
        src_l=rng.integers(0, hi, (S, B)).astype(np.int32),
        pos_l=rng.integers(0, hi, (S, B)).astype(np.int32),
        negs_l=rng.integers(0, nb2 if neg_hi is None else neg_hi,
                            (S, Ks)).astype(np.int32),
        alpha=np.linspace(alpha, 0.6 * alpha, S).astype(np.float32),
    )


def fused_inputs(seed, B, band, n_bands, Ks, D, sb, db, idx_hi=None,
                 alpha=0.05):
    """K3's arguments: tables of ``n_bands`` bands, the band START rows of
    bands sb and db (0-d int32), (B,) band-local rows below ``idx_hi``, a
    (Ks, D) negative snapshot and the rate ``alpha`` (0-d f32)."""
    rng = np.random.default_rng(seed)
    n = band * n_bands
    hi = band if idx_hi is None else idx_hi
    return dict(
        wv=(rng.standard_normal((n, D)) * 0.1).astype(np.float32),
        wc=(rng.standard_normal((n, D)) * 0.1).astype(np.float32),
        sb=np.asarray(sb * band, np.int32),
        db=np.asarray(db * band, np.int32),
        src_l=rng.integers(0, hi, B).astype(np.int32),
        pos_l=rng.integers(0, hi, B).astype(np.int32),
        cn=(rng.standard_normal((Ks, D)) * 0.1).astype(np.float32),
        alpha=np.asarray(alpha, np.float32),
    )


# Every source and positive row of the superstep is one vertex (row 64 of
# each table): all tiles and steps collide, 1024 deltas a tile into one row.
# A small rate keeps the 2048-fold sums in f32 range.
ALL_COLLIDE = dict(seed=3, S=2, B=2048, band=64, n_bands=3, Ks=128, D=64,
                   sb=[1, 1], db=[1, 1], idx_hi=1, alpha=3e-4)
# The same for K5, with the negatives in window 5 (rows 80..95), inside both
# steps' context band. The window leaves out the collided row: there the
# sum of 4096 equal positive deltas would meet the negatives' deltas, and
# f32 rounds such a sum differently in every order by more than the
# kernels' tolerance.
ALL_COLLIDE_NB = dict(seed=3, S=2, B=2048, band=64, n_bands=3, nb2=16,
                      Ks=128, D=64, sb=[1, 1], db=[1, 1], nb=[5, 5],
                      idx_hi=1, alpha=3e-4)
# K3's all-collide micro-step: two 2048-row tiles whose every source and
# positive row is row 64 of its table, so the second tile gathers the
# first tile's 2048 summed deltas.
ALL_COLLIDE_FUSED = dict(seed=3, B=4096, band=64, n_bands=3, Ks=128, D=64,
                         sb=1, db=1, idx_hi=1, alpha=3e-4)
