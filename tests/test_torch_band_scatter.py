"""Kernel K2 (band row scatter-add): the port's plain twin against
smore_tpu's Pallas ``band_scatter_add`` in interpret mode, on the same numpy
inputs.

Tolerance rtol 2e-5, atol 2e-4, as tests/test_pallas_scatter.py holds the
Pallas kernel against np.add.at: both sides sum in f32, duplicates in
another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smore_tpu.ops.pallas_scatter import band_scatter_add as jax_scatter
from smore_tpu_torch.ops.scatter import band_scatter_add, band_scatter_add_ref

# one intra-op thread: test workers share the cores, and a thread pool
# in each of them oversubscribes the CPU on these tiny shapes
torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-4


def _idx(rng, kind, B, Nb):
    if kind == "random":
        return rng.integers(0, Nb, B).astype(np.int32)
    if kind == "all_same":
        return np.full(B, 7, np.int32)  # worst-case duplicate pile-up
    return (np.arange(B) % Nb).astype(np.int32)


def _run_both(band, idx, delta, start=0, rows=None):
    """JAX on the band slice; the port on a ``rows``-row table holding the
    band at ``start``. Returns (jax band, port band, port table)."""
    Nb, D = band.shape
    rows = rows or Nb
    rng = np.random.default_rng(99)
    table = rng.normal(size=(rows, D)).astype(np.float32)
    table[start:start + Nb] = band
    want = np.asarray(jax_scatter(jnp.asarray(band), jnp.asarray(idx),
                                  jnp.asarray(delta), interpret=True))
    t = torch.from_numpy(table.copy())
    before = band_scatter_add.launches
    out = band_scatter_add(t, torch.tensor(start, dtype=torch.int32),
                           torch.from_numpy(idx), torch.from_numpy(delta))
    assert out is t and band_scatter_add.launches == before  # CPU: twin
    got = t.numpy()
    outside = np.ones(rows, bool)
    outside[start:start + Nb] = False
    assert np.array_equal(got[outside], table[outside])
    return want, got[start:start + Nb]


@pytest.mark.parametrize("kind", ["random", "all_same", "iota"])
def test_twin_matches_pallas(kind):
    rng = np.random.default_rng(1)
    Nb, D, B = 128, 64, 2048
    band = rng.normal(size=(Nb, D)).astype(np.float32)
    delta = rng.normal(size=(B, D)).astype(np.float32)
    want, got = _run_both(band, _idx(rng, kind, B, Nb), delta)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_twin_matches_pallas_multi_tile():
    """B spanning four 2048-row delta tiles accumulates across tiles."""
    rng = np.random.default_rng(2)
    Nb, D, B = 64, 64, 8192
    band = np.zeros((Nb, D), np.float32)
    delta = rng.normal(size=(B, D)).astype(np.float32)
    want, got = _run_both(band, _idx(rng, "random", B, Nb), delta)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_nonzero_band_start_in_a_larger_table():
    rng = np.random.default_rng(3)
    Nb, D, B = 96, 32, 1024
    band = rng.normal(size=(Nb, D)).astype(np.float32)
    delta = rng.normal(size=(B, D)).astype(np.float32)
    want, got = _run_both(band, _idx(rng, "random", B, Nb), delta,
                          start=2 * Nb, rows=4 * Nb)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _args(B=2048, D=64, dtype=torch.float32, device="cpu"):
    return (torch.zeros(128, D, dtype=dtype, device=device),
            torch.zeros((), dtype=torch.int32, device=device),
            torch.zeros(B, dtype=torch.int32, device=device),
            torch.zeros(B, D, dtype=dtype, device=device))


@pytest.mark.parametrize("case,match", [
    ("b100", "tile"),  # the TPU kernel's 2048-row tile assert
    ("b2049", "tile"),
    ("float64", "float32"),
    ("meta", "no kernel"),
    ("d_mismatch", "share D"),
])
def test_check_rejects(case, match):
    args = {
        "b100": lambda: _args(B=100),
        "b2049": lambda: _args(B=2049),
        "float64": lambda: _args(dtype=torch.float64),
        "meta": lambda: _args(device="meta"),
        "d_mismatch": lambda: (_args()[0][:, :32],) + _args()[1:],
    }[case]()
    with pytest.raises(ValueError, match=match):
        band_scatter_add(*args)


def test_twin_is_index_add():
    """The twin is exactly index_add_ at the global rows."""
    rng = np.random.default_rng(4)
    table = torch.from_numpy(rng.normal(size=(300, 16)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 100, 512).astype(np.int32))
    delta = torch.from_numpy(rng.normal(size=(512, 16)).astype(np.float32))
    want = table.clone().index_add_(0, idx.long() + 150, delta)
    band_scatter_add_ref(table, torch.tensor(150), idx, delta)
    assert torch.equal(table, want)
