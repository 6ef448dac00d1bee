"""The port's banded-negative multiblock superstep (K5) against smore_tpu's
Pallas kernel (interpret mode on the CPU). The CUDA kernel is held to the
same twin on the card by tests/test_torch_gpu.py.

On the CPU the port's wrapper runs its twin; smore_tpu's kernel runs on
2-row-folded copies of the same numpy tables. Tolerance rtol 2e-5, atol 1e-6
(the Pallas suite's): both sides are f32 and differ only in the order of the
dot-product and matmul sums. The cases cover a negative window inside the
step's own context band (the TPU kernel's ``ninc`` path), a window in the
previous step's context band (``confn``), a repeated band pair or window,
windows and rows at odd global rows (the TPU picked folded halves by
parity), two 1024-row tiles, and duplicate negatives."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smore_tpu.ops.pallas_sgns_banded import (
    fold_table,
    sgns_banded_multiblock_nb as jax_multiblock_nb,
    unfold_table,
)
from smore_tpu_torch.ops.sgns_banded import (
    K5,
    sgns_banded_multiblock_nb,
    sgns_banded_multiblock_nb_ref,
    sgns_banded_multiblock_ref,
)
from torch_superstep_inputs import ALL_COLLIDE_NB, multiblock_nb_inputs

# one intra-op thread: test workers share the cores, and a thread pool
# in each of them oversubscribes the CPU on these tiny shapes
torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 1e-6
_ARGS = ("wv", "wc", "sb", "db", "nb", "src_l", "pos_l", "negs_l", "alpha")


_inputs = multiblock_nb_inputs


CASES = {
    # tests/test_pallas_sgns_banded.py's case: 16-row windows, window w in
    # band w // 4; step 1 shares sb with step 0, step 3's window lies in
    # its own context band, step 4's in step 3's, step 5 repeats step 0's
    # band pair
    "s6_b128_ninc_confn": dict(seed=0, S=6, B=128, band=64, n_bands=4,
                               nb2=16, Ks=128, D=64, sb=[1, 1, 2, 0, 2, 1],
                               db=[2, 0, 1, 2, 0, 2], nb=[1, 4, 3, 11, 10, 6]),
    # two tiles of 1024: the second gathers the first's writes; step 1's
    # window (9, odd, in band 2) is step 1's own context band
    "s2_b2048_two_tiles": dict(seed=1, S=2, B=2048, band=64, n_bands=3,
                               nb2=16, Ks=128, D=64, sb=[0, 2], db=[1, 2],
                               nb=[3, 9]),
    # 4 distinct negatives and 16 distinct rows per side; step 1 repeats
    # step 0's window, which lies in both steps' context band
    "s2_b256_duplicate_negs": dict(seed=2, S=2, B=256, band=64, n_bands=3,
                                   nb2=32, Ks=32, D=64, sb=[1, 1],
                                   db=[0, 0], nb=[1, 1], idx_hi=16,
                                   neg_hi=4),
    # every source and positive row of the superstep is one vertex, the
    # negatives in a window inside both steps' context band (the card test
    # holds the CUDA kernel to these inputs too)
    "s2_b2048_all_collide": ALL_COLLIDE_NB,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_twin_matches_pallas_kernel(case):
    c = dict(CASES[case])
    band, nb2 = c["band"], c["nb2"]
    x = _inputs(**c)
    jv, jc, jl = jax_multiblock_nb(
        fold_table(jnp.asarray(x["wv"])), fold_table(jnp.asarray(x["wc"])),
        *(jnp.asarray(x[k]) for k in _ARGS[2:]),
        band_size=band, nb2=nb2, k_equiv=5, interpret=True,
    )
    t = {k: torch.from_numpy(v.copy()) for k, v in x.items()}
    before = K5.launches
    tv, tc, tl = sgns_banded_multiblock_nb(*(t[k] for k in _ARGS),
                                           band_size=band, nb2=nb2,
                                           k_equiv=5)
    assert K5.launches == before  # CPU: the twin
    assert tv is t["wv"] and tc is t["wc"]  # updated in place
    np.testing.assert_allclose(tv.numpy(), np.asarray(unfold_table(jv)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(unfold_table(jc)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL, atol=ATOL)
    # the negative windows really moved
    rows = (x["nb"][:, None] * nb2 + x["negs_l"]).ravel()
    assert not np.allclose(tc.numpy()[rows], x["wc"][rows])


def test_negatives_are_fresh_per_step():
    """Step 1 draws from the window step 0 updated. The superstep equals
    its steps run one call each, and differs from K4's form, which reads
    every step's negatives at the superstep's start and adds their deltas
    after it."""
    c = CASES["s2_b256_duplicate_negs"]
    band, nb2 = c["band"], c["nb2"]
    x = _inputs(**c)

    def fresh():
        return {k: torch.from_numpy(v.copy()) for k, v in x.items()}

    t = fresh()
    sgns_banded_multiblock_nb_ref(*(t[k] for k in _ARGS), band_size=band,
                                  nb2=nb2)
    seq = fresh()
    for s in range(2):
        sgns_banded_multiblock_nb_ref(
            *(seq[k] if k in ("wv", "wc") else seq[k][s:s + 1]
              for k in _ARGS), band_size=band, nb2=nb2)
    np.testing.assert_allclose(t["wc"].numpy(), seq["wc"].numpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t["wv"].numpy(), seq["wv"].numpy(),
                               rtol=RTOL, atol=ATOL)

    k4 = fresh()
    rows = (k4["nb"][:, None] * nb2 + k4["negs_l"]).long()
    cn = k4["wc"][rows]  # (S, Ks, D) snapshot at the superstep's start
    _, _, d_neg, _ = sgns_banded_multiblock_ref(
        k4["wv"], k4["wc"], k4["sb"], k4["db"], k4["src_l"], k4["pos_l"], cn,
        k4["alpha"], band_size=band)
    k4["wc"].index_add_(0, rows.reshape(-1), d_neg.flatten(0, 1))
    assert not np.allclose(t["wc"].numpy(), k4["wc"].numpy(), rtol=RTOL,
                           atol=ATOL)


def _cpu_args():
    x = _inputs(**CASES["s6_b128_ninc_confn"])
    return [torch.from_numpy(x[k]) for k in _ARGS]


@pytest.mark.parametrize("bad", ["negs_rank", "wc_dtype", "nb_len",
                                 "pos_shape", "batch_tile"])
def test_wrapper_rejects_bad_inputs(bad):
    wv, wc, sb, db, nb, src, pos, negs, alpha = _cpu_args()
    if bad == "negs_rank":
        negs = negs[0]
    elif bad == "wc_dtype":
        wc = wc.double()
    elif bad == "nb_len":
        nb = nb[:2]
    elif bad == "pos_shape":
        pos = pos[:, :64]
    else:
        src, pos = src[:, :100], pos[:, :100]
    with pytest.raises(ValueError):
        sgns_banded_multiblock_nb(wv, wc, sb, db, nb, src, pos, negs, alpha,
                                  band_size=64, nb2=16)


def test_wrapper_has_no_fallback_off_cpu():
    """A device that is neither the CPU nor a CUDA card gets an error,
    never the twin."""
    args = [a.to("meta") for a in _cpu_args()]
    with pytest.raises(ValueError, match="no kernel"):
        sgns_banded_multiblock_nb(*args, band_size=64, nb2=16)
