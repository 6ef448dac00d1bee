"""The port's community, CBOW and choice updates
(smore_tpu_torch/ops/community.py) against smore_tpu/ops/community.py.

Every function is fed the same numpy inputs from a seed at toy shapes (N =
64 rows, D = 16), with hot duplicate rows in every index set (so that the
port's in-place scatters would show any gather read after a write), with
and without ``mask`` where the function has one, and with collision "sum"
and "mean". The returned tables and the loss must agree with the JAX
package's within rtol 1e-5 / atol 1e-6; the exp-based choice updates
(``dchoice*``, ``choice*``) within rtol 1e-4 / atol 1e-5, since the
exponentials magnify the float32 rounding of their dot products. The
field-community forms run with F = 1, 2 and 3 fields, both variants.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smore_tpu.ops.community as J
import smore_tpu_torch.ops.community as T

# one intra-op thread: test workers share the cores, and a thread pool
# in each of them oversubscribes the CPU on these tiny shapes
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
TOL_EXP = dict(rtol=1e-4, atol=1e-5)
N, D, B = 64, 16, 48
ALPHA = 0.05


def _idx(rng, shape, n=N):
    """Indices into n rows; a third of them on three hot rows."""
    x = rng.integers(0, n, shape)
    hot = rng.random(shape) < 1 / 3
    return np.where(hot, rng.integers(0, 3, shape), x).astype(np.int32)


def _table(rng, rows=N, scale=0.3):
    return (rng.standard_normal((rows, D)) * scale).astype(np.float32)


def _mask(rng):
    return (rng.random(B) < 0.7).astype(np.float32)


COLLISIONS = ["sum", "mean"]
MASKED = [False, True]


def _kw_mask(rng, masked, collision, **kw):
    """(JAX keywords, port keywords), with a (B,) mask when ``masked``."""
    kw = dict(kw, collision=collision)
    if not masked:
        return kw, kw
    m = _mask(rng)
    return dict(kw, mask=jnp.asarray(m)), dict(kw, mask=torch.from_numpy(m))


def _both(jfn, tfn, tables, args, jkw, tkw, tol):
    """Call both packages on the same arrays (the tables copied for the
    port, which updates them in place); compare the tables and the loss."""
    jout = jfn(*[jnp.asarray(t) for t in tables], *map(jnp.asarray, args),
               jnp.float32(ALPHA), **jkw)
    ttabs = [torch.from_numpy(t.copy()) for t in tables]
    tout = tfn(*ttabs, *map(torch.from_numpy, args), torch.tensor(ALPHA),
               **tkw)
    assert len(tout) == len(tables) + 1
    for i, t in enumerate(ttabs):
        assert tout[i] is t  # updated in place
        np.testing.assert_allclose(t.numpy(), np.asarray(jout[i]),
                                   err_msg=f"table {i}", **tol)
        assert not np.array_equal(t.numpy(), tables[i])
    np.testing.assert_allclose(float(tout[-1]), float(jout[-1]), **tol)


@pytest.mark.parametrize("collision", COLLISIONS)
@pytest.mark.parametrize("masked", MASKED)
def test_cbow_step(masked, collision):
    rng = np.random.default_rng(1)
    S, K = 3, 4
    args = [_idx(rng, (B, S)), _idx(rng, (B, S)), _idx(rng, (B, K, S))]
    jkw, tkw = _kw_mask(rng, masked, collision, reg=0.01)
    _both(J.cbow_step, T.cbow_step, [_table(rng, scale=0.2)], args, jkw, tkw,
          TOL)


@pytest.mark.parametrize("collision", COLLISIONS)
def test_dchoice_step(collision):
    rng = np.random.default_rng(2)
    args = [_idx(rng, (B,)), _idx(rng, (B,)), _idx(rng, (B,)),
            _idx(rng, (B, 5))]
    kw = dict(reg=0.01, collision=collision)
    _both(J.dchoice_step, T.dchoice_step, [_table(rng)], args, kw, kw,
          TOL_EXP)


@pytest.mark.parametrize("collision", COLLISIONS)
@pytest.mark.parametrize("masked", MASKED)
def test_choice_softmax_step(masked, collision):
    rng = np.random.default_rng(3)
    args = [_idx(rng, (B,)), _idx(rng, (B,)), _idx(rng, (B, 5))]
    jkw, tkw = _kw_mask(rng, masked, collision, reg=0.02)
    _both(J.choice_softmax_step, T.choice_softmax_step, [_table(rng)], args,
          jkw, tkw, TOL_EXP)


def test_aliases_are_the_same_objects():
    assert T.recall_rank_step is T.choice_softmax_step
    assert T.hop_choice_step is T.choice_softmax_step
    assert T.fields_community_step is T.field_community_step


@pytest.mark.parametrize("collision", COLLISIONS)
@pytest.mark.parametrize("masked", MASKED)
def test_raw_choice_step(masked, collision):
    rng = np.random.default_rng(4)
    args = [_idx(rng, (B,)), _idx(rng, (B,)), _idx(rng, (B, 5))]
    jkw, tkw = _kw_mask(rng, masked, collision, reg=0.01)
    _both(J.raw_choice_step, T.raw_choice_step, [_table(rng), _table(rng)],
          args, jkw, tkw, TOL_EXP)


@pytest.mark.parametrize("collision", COLLISIONS)
def test_choice_step(collision):
    rng = np.random.default_rng(5)
    args = [_idx(rng, (B,)), _idx(rng, (B,)), _idx(rng, (B, 5, 4)),
            _idx(rng, (B, 3))]
    kw = dict(reg=0.01, collision=collision)
    _both(J.choice_step, T.choice_step, [_table(rng), _table(rng)], args, kw,
          kw, TOL_EXP)


def test_field_project():
    v = np.arange(6, dtype=np.int32)
    f = np.array([0, 1, 2, 0, 1, 2], np.int32)
    np.testing.assert_array_equal(
        T.field_project(torch.from_numpy(v), torch.from_numpy(f), 3).numpy(),
        np.asarray(J.field_project(jnp.asarray(v), jnp.asarray(f), 3)))


def _field_inputs(rng, nf, S=4):
    """Shadow tables of N * nf rows, a field per vertex, a context walk
    with its mask (dead ends cut some walks) and vertices."""
    fields_of = rng.integers(0, nf, N).astype(np.int32)
    walk_mask = np.cumprod(rng.random((B, S)) < 0.85, axis=1).astype(
        np.float32)
    walk_mask[:, 0] = 1.0
    return (_table(rng, N * nf), _table(rng, N * nf), _idx(rng, (B,)),
            _idx(rng, (B, S)), walk_mask, fields_of)


@pytest.mark.parametrize("collision", COLLISIONS)
@pytest.mark.parametrize("ms_variant", [False, True])
@pytest.mark.parametrize("nf", [1, 2, 3])
def test_field_community_step(nf, ms_variant, collision):
    rng = np.random.default_rng(10 + nf)
    wv, wc, vertex, walk, wmask, fields_of = _field_inputs(rng, nf)
    negs = _idx(rng, (B, walk.shape[1], 3))
    jout = J.field_community_step(
        jnp.asarray(wv), jnp.asarray(wc), jnp.asarray(vertex),
        jnp.asarray(walk), jnp.asarray(wmask), jnp.asarray(negs),
        jnp.asarray(fields_of), nf, jnp.float32(ALPHA), reg=0.01,
        ms_variant=ms_variant, collision=collision)
    tv, tc = torch.from_numpy(wv.copy()), torch.from_numpy(wc.copy())
    tout = T.field_community_step(
        tv, tc, *map(torch.from_numpy, (vertex, walk, wmask, negs,
                                        fields_of)),
        nf, torch.tensor(ALPHA), reg=0.01, ms_variant=ms_variant,
        collision=collision)
    assert tout[0] is tv and tout[1] is tc
    np.testing.assert_allclose(tv.numpy(), np.asarray(jout[0]), **TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jout[1]), **TOL)
    np.testing.assert_allclose(float(tout[2]), float(jout[2]), **TOL)


# ------------------------------------------------------------ shared pools
@pytest.mark.parametrize("collision", COLLISIONS)
@pytest.mark.parametrize("masked", MASKED)
def test_cbow_step_shared_negs(masked, collision):
    rng = np.random.default_rng(20)
    S, Kp = 3, 16
    args = [_idx(rng, (B, S)), _idx(rng, (B, S)), _idx(rng, (Kp, S))]
    jkw, tkw = _kw_mask(rng, masked, collision, k_equiv=4, reg=0.01)
    _both(J.cbow_step_shared_negs, T.cbow_step_shared_negs,
          [_table(rng, scale=0.2)], args, jkw, tkw, TOL)


@pytest.mark.parametrize("collision", COLLISIONS)
def test_dchoice_step_shared_negs(collision):
    rng = np.random.default_rng(21)
    args = [_idx(rng, (B,)), _idx(rng, (B,)), _idx(rng, (B,)),
            _idx(rng, (16,))]
    kw = dict(k_equiv=5, reg=0.01, collision=collision)
    _both(J.dchoice_step_shared_negs, T.dchoice_step_shared_negs,
          [_table(rng)], args, kw, kw, TOL_EXP)


@pytest.mark.parametrize("collision", COLLISIONS)
@pytest.mark.parametrize("masked", MASKED)
def test_choice_softmax_step_shared_negs(masked, collision):
    rng = np.random.default_rng(22)
    args = [_idx(rng, (B,)), _idx(rng, (B,)), _idx(rng, (16,))]
    jkw, tkw = _kw_mask(rng, masked, collision, k_equiv=5, reg=0.01)
    _both(J.choice_softmax_step_shared_negs,
          T.choice_softmax_step_shared_negs, [_table(rng)], args, jkw, tkw,
          TOL_EXP)


@pytest.mark.parametrize("collision", COLLISIONS)
@pytest.mark.parametrize("ms_variant", [False, True])
@pytest.mark.parametrize("nf", [1, 2, 3])
def test_field_community_step_shared_negs(nf, ms_variant, collision):
    rng = np.random.default_rng(30 + nf)
    wv, wc, vertex, walk, wmask, fields_of = _field_inputs(rng, nf)
    Kp = 8
    # pool f drawn from field f (with one vertex of each field at least)
    pool = np.stack([rng.choice(np.flatnonzero(fields_of == f), Kp)
                     for f in range(nf)]).astype(np.int32)
    jout = J.field_community_step_shared_negs(
        jnp.asarray(wv), jnp.asarray(wc), jnp.asarray(vertex),
        jnp.asarray(walk), jnp.asarray(wmask), jnp.asarray(pool),
        jnp.asarray(fields_of), nf, jnp.float32(ALPHA), k_equiv=3, reg=0.01,
        ms_variant=ms_variant, collision=collision)
    tv, tc = torch.from_numpy(wv.copy()), torch.from_numpy(wc.copy())
    tout = T.field_community_step_shared_negs(
        tv, tc, *map(torch.from_numpy, (vertex, walk, wmask, pool,
                                        fields_of)),
        nf, torch.tensor(ALPHA), k_equiv=3, reg=0.01, ms_variant=ms_variant,
        collision=collision)
    assert tout[0] is tv and tout[1] is tc
    np.testing.assert_allclose(tv.numpy(), np.asarray(jout[0]), **TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jout[1]), **TOL)
    np.testing.assert_allclose(float(tout[2]), float(jout[2]), **TOL)


def test_ms_variant_overrides_reg():
    """msFINE's reg is 0.025 whatever the caller passes."""
    rng = np.random.default_rng(40)
    wv, wc, vertex, walk, wmask, fields_of = _field_inputs(rng, 2)
    negs = _idx(rng, (B, walk.shape[1], 3))
    outs = []
    for reg in (0.0, 0.5):
        tv, tc = torch.from_numpy(wv.copy()), torch.from_numpy(wc.copy())
        T.field_community_step(tv, tc, *map(torch.from_numpy, (
            vertex, walk, wmask, negs, fields_of)), 2, torch.tensor(ALPHA),
            reg=reg, ms_variant=True)
        outs.append(tv)
    assert torch.equal(outs[0], outs[1])
