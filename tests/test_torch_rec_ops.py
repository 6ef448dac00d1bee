"""The port's recommendation updates (smore_tpu_torch/ops/update.py) against
smore_tpu/ops/update.py on the same seeded inputs.

Nine functions: mf_step, bpr_step, warp_step, skewbpr_step, their
shared-pool forms and fbpr_step; with and without a mask (where the
function takes one), on one shared table and on two, collision "sum" and
"mean", with duplicate rows (40 table rows under 32 samples and their
negatives), and fbpr_step with per-pair alpha and margin. Tables, the
returned loss, and the one-table identity are compared. Tolerances: rtol
1e-5, atol 1e-6 for the single-round updates; rtol 1e-4, atol 1e-5 for the
two Skew-OPT functions (16 sequential rounds).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smore_tpu.ops.update as J
import smore_tpu_torch.ops.update as T

# one intra-op thread: test workers share the cores, and a thread pool
# in each of them oversubscribes the CPU on these tiny shapes
torch.set_num_threads(1)

N, D, B, K, KS = 40, 8, 32, 5, 8
TOL = dict(rtol=1e-5, atol=1e-6)
TOL_SKEW = dict(rtol=1e-4, atol=1e-5)
SKEW = dict(xi=0.5, omega=1.0)  # rounds both skipped and taken


def _inputs(seed, masked):
    """Unit-scale tables (scores of either sign, margins violated and not)
    and indices into 40 rows (duplicates in every index set)."""
    rng = np.random.default_rng(seed)
    x = dict(
        wv=rng.standard_normal((N, D)).astype(np.float32) * 0.7,
        wc=rng.standard_normal((N, D)).astype(np.float32) * 0.7,
        src=rng.integers(0, N, B).astype(np.int32),
        pos=rng.integers(0, N, B).astype(np.int32),
        negs=rng.integers(0, N, (B, K)).astype(np.int32),
        negs16=rng.integers(0, N, (B, 16)).astype(np.int32),
        pool=rng.integers(0, N, KS).astype(np.int32),
        u=rng.random((B, KS + 1)).astype(np.float32),
        alpha_b=rng.uniform(0.01, 0.05, B).astype(np.float32),
        margin_b=rng.uniform(0.2, 1.0, B).astype(np.float32),
    )
    x["mask"] = ((rng.random(B) < 0.7).astype(np.float32) if masked
                 else None)
    return x


def _call(name, m, a, wv, wc, shared, collision):
    """``name`` of module ``m`` on inputs ``a`` (arrays of m's kind)."""
    alpha = a["alpha"]
    kw = dict(shared_table=shared, collision=collision)
    mk = {} if a["mask"] is None else {"mask": a["mask"]}
    if name == "mf_step":
        return m.mf_step(wv, wc, a["src"], a["pos"], a["negs"], alpha,
                         reg=0.02, **mk, **kw)
    if name == "bpr_step":
        return m.bpr_step(wv, wc, a["src"], a["pos"], a["negs"], alpha,
                          **mk, **kw)
    if name == "warp_step":
        return m.warp_step(wv, wc, a["src"], a["pos"], a["negs16"], alpha,
                           **mk, **kw)
    if name.startswith("skewbpr_step"):
        eta = int(name[-1])
        return m.skewbpr_step(wv, wc, a["src"], a["pos"], a["negs16"],
                              alpha, eta=eta, **SKEW, **mk, **kw)
    if name == "fbpr_step":
        return m.fbpr_step(wv, wc, a["src"], a["pos"], a["negs"], alpha,
                           0.5, **mk, **kw)
    if name == "fbpr_step_per_pair":
        return m.fbpr_step(wv, wc, a["src"], a["pos"], a["negs"][:, :1],
                           a["alpha_b"], a["margin_b"], **mk, **kw)
    if name == "bpr_shared_negs_step":
        return m.bpr_shared_negs_step(wv, wc, a["src"], a["pos"], a["pool"],
                                      alpha, k_equiv=5, **kw)
    if name == "mf_shared_negs_step":
        return m.mf_shared_negs_step(wv, wc, a["src"], a["pos"], a["pool"],
                                     alpha, k_equiv=5, **kw)
    if name == "warp_shared_pool_step":
        return m.warp_shared_pool_step(wv, wc, a["src"], a["pos"], a["pool"],
                                       a["u"], alpha, trials=3, **kw)
    if name.startswith("skewbpr_shared_negs_step"):
        eta = int(name[-1])
        return m.skewbpr_shared_negs_step(wv, wc, a["src"], a["pos"],
                                          a["pool"], alpha, k_equiv=16,
                                          eta=eta, **SKEW, **kw)
    raise KeyError(name)


MASKED = ["mf_step", "bpr_step", "warp_step", "skewbpr_step_eta1",
          "skewbpr_step_eta3", "fbpr_step", "fbpr_step_per_pair"]
POOLED = ["bpr_shared_negs_step", "mf_shared_negs_step",
          "warp_shared_pool_step", "skewbpr_shared_negs_step_eta1",
          "skewbpr_shared_negs_step_eta3"]
CASES = ([(n, msk) for n in MASKED for msk in (False, True)]
         + [(n, False) for n in POOLED])


@pytest.mark.parametrize("collision", ["sum", "mean"])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("name,masked", CASES)
def test_rec_update_matches_jax(name, masked, shared, collision):
    x = _inputs(len(name) + 7 * masked, masked)
    tol = TOL_SKEW if name.startswith("skew") else TOL

    def wrap(f):
        return {k: (None if v is None else f(v)) for k, v in x.items()}

    ja = wrap(jnp.asarray)
    ja["alpha"] = jnp.float32(0.05)
    ta = wrap(torch.from_numpy)
    ta["alpha"] = torch.tensor(0.05)
    jwc = ja["wv"] if shared else ja["wc"]
    wv = ta["wv"].clone()
    wc = wv if shared else ta["wc"].clone()
    jv, jc, jl = _call(name, J, ja, ja["wv"], jwc, shared, collision)
    tv, tc, tl = _call(name, T, ta, wv, wc, shared, collision)
    assert tv is wv and tc is wc  # updated in place
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **tol)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **tol)
    np.testing.assert_allclose(float(tl), float(jl), **tol)
    assert not np.allclose(tv.numpy(), x["wv"])  # the update moved rows


def test_warp_first_violator_and_no_violator():
    """warp_step picks the FIRST violating candidate, and a sample with no
    violator is left alone (its rows unchanged), as in the JAX package."""
    wv = np.zeros((6, 2), np.float32)
    wv[0] = [1.0, 0.0]  # the user
    wv[1] = [3.0, 0.0]  # the positive: f_i = 3
    wv[2] = [2.5, 0.0]  # violates (3 - 2.5 < 1)
    wv[3] = [-1.0, 0.0]  # does not
    wv[4] = [2.8, 0.0]  # violates
    wv[5] = [0.0, 1.0]  # a second user: f = 0 against rows 3 and 1 ...
    user = np.array([0, 0], np.int32)
    pos = np.array([1, 1], np.int32)
    negs = np.array([[3, 4, 2], [3, 3, 3]], np.int32)
    t = torch.from_numpy(wv.copy())
    T.warp_step(t, t, torch.from_numpy(user), torch.from_numpy(pos),
                torch.from_numpy(negs), torch.tensor(0.1), shared_table=True)
    jw, _, _ = J.warp_step(jnp.asarray(wv), jnp.asarray(wv),
                           jnp.asarray(user), jnp.asarray(pos),
                           jnp.asarray(negs), jnp.float32(0.1),
                           shared_table=True)
    np.testing.assert_allclose(t.numpy(), np.asarray(jw), **TOL)
    moved = np.abs(t.numpy() - wv).sum(1) > 0
    # row 4 (the first violator of sample 0) moved, rows 2 and 3 did not
    assert moved.tolist() == [True, True, False, False, True, False]
