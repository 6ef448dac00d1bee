"""The rest of the port's ``ops/update.py`` (``pu_sgd_step``,
``pu_sigmoid_step``, ``pu_bpr_step``, ``cosine_step``, ``length_step``,
``grouping_step``) against smore_tpu/ops/update.py.

The same numpy inputs from a seed at toy shapes (N = 64 rows, D = 16, hot
duplicate rows in every index set), with and without ``mask``, collision
"sum" and "mean", and ``shared_table`` True and False where the function
has it (one table passed as both). Tables and loss agree within rtol 1e-5
/ atol 1e-6.
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

TOL = dict(rtol=1e-5, atol=1e-6)
N, D, B, K = 64, 16, 48, 4
ALPHA = 0.05


def _inputs(seed):
    rng = np.random.default_rng(seed)

    def idx(shape):
        x = rng.integers(0, N, shape)
        return np.where(rng.random(shape) < 1 / 3, rng.integers(0, 3, shape),
                        x).astype(np.int32)

    return dict(
        wv=(rng.standard_normal((N, D)) * 0.4).astype(np.float32),
        wc=(rng.standard_normal((N, D)) * 0.4).astype(np.float32),
        src=idx((B,)), pos=idx((B,)), negs=idx((B, K)),
        vgroup=idx((B, 3)), cgroup=idx((B, 2)),
        labels=(rng.random(B) < 0.5).astype(np.float32),
        mask=(rng.random(B) < 0.7).astype(np.float32),
    )


# name -> (argument names after the tables, extra keywords, shared_table)
CASES = {
    "pu_sgd_step": (("src", "pos", "labels"), dict(reg=0.02), False),
    "pu_sigmoid_step": (("src", "pos", "labels"), dict(reg=0.01), False),
    "pu_bpr_step": (("src", "pos", "negs"), {}, True),
    "cosine_step": (("src", "pos", "negs"), {}, False),
    "length_step": (("src", "pos", "negs"), {}, False),
    "grouping_step": (("vgroup", "cgroup", "labels"), dict(reg=0.02), True),
}
PARAMS = [(n, s) for n, (_, _, has) in sorted(CASES.items())
          for s in ([False, True] if has else [False])]


@pytest.mark.parametrize("collision", ["sum", "mean"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name,shared", PARAMS)
def test_update_matches_jax(name, shared, masked, collision):
    x = _inputs(sorted(CASES).index(name))
    arg_names, extra, _ = CASES[name]
    kw = dict(extra, collision=collision)
    if shared:
        kw["shared_table"] = True
    jkw, tkw = dict(kw), dict(kw)
    if masked:
        jkw["mask"] = jnp.asarray(x["mask"])
        tkw["mask"] = torch.from_numpy(x["mask"])
    wc_name = "wv" if shared else "wc"
    jwv, jwc, jl = getattr(J, name)(
        jnp.asarray(x["wv"]), jnp.asarray(x[wc_name]),
        *[jnp.asarray(x[a]) for a in arg_names], jnp.float32(ALPHA), **jkw)
    twv = torch.from_numpy(x["wv"].copy())
    twc = twv if shared else torch.from_numpy(x["wc"].copy())
    out = getattr(T, name)(twv, twc, *[torch.from_numpy(x[a])
                                       for a in arg_names],
                           torch.tensor(ALPHA), **tkw)
    assert out[0] is twv and out[1] is twc  # updated in place
    np.testing.assert_allclose(twv.numpy(), np.asarray(jwv), **TOL)
    np.testing.assert_allclose(twc.numpy(), np.asarray(jwc), **TOL)
    np.testing.assert_allclose(float(out[2]), float(jl), **TOL)
    assert not np.array_equal(twv.numpy(), x["wv"])


def test_pu_bpr_is_bpr_without_l2():
    x = _inputs(7)
    a, b = (torch.from_numpy(x["wv"].copy()) for _ in range(2))
    c, d = (torch.from_numpy(x["wc"].copy()) for _ in range(2))
    args = [torch.from_numpy(x[k]) for k in ("src", "pos", "negs")]
    T.pu_bpr_step(a, c, *args, torch.tensor(ALPHA))
    T.bpr_step(b, d, *args, torch.tensor(ALPHA), reg_ctx=0.0, reg_vtx=0.0)
    assert torch.equal(a, b) and torch.equal(c, d)


def test_length_step_descends():
    """The norm-product deltas are minus the gradient: a positive pair
    whose norms multiply above 1 shrinks."""
    wv = torch.full((2, D), 0.5)
    wc = torch.full((2, D), 0.5)
    one = torch.zeros(1, dtype=torch.int32)
    T.length_step(wv, wc, one, one, torch.ones((1, 1), dtype=torch.int32),
                  torch.tensor(0.01))
    assert float(wv[0].norm() * wc[0].norm()) < 0.5 * 0.5 * D
