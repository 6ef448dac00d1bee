"""The port's RNN cell (smore_tpu_torch/ops/rnn.py) against
smore_tpu/ops/rnn.py: given the same parameters and inputs (numpy, from a
seed), rnn_forward, rnn_update and rnn_project agree at rtol 1e-5, atol
1e-6 (float32 products summed in another order), batched over no, one and
two leading axes; init_rnn_cell draws the same law."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smore_tpu.ops import rnn as jrnn
from smore_tpu_torch.models.base import seeded_generator
from smore_tpu_torch.ops import rnn

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
CPU = "cpu"
H, IN = 8, 13


def _params(seed, in_dim=IN):
    rng = np.random.default_rng(seed)
    return {"Wh": rng.uniform(-0.4, 0.4, (H, H)).astype(np.float32),
            "Wx": rng.uniform(-0.4, 0.4, (H, in_dim)).astype(np.float32),
            "b": rng.uniform(-0.1, 0.1, H).astype(np.float32)}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


LEADING = [(), (5,), (3, 4)]


@pytest.mark.parametrize("lead", LEADING)
def test_rnn_forward(lead):
    jp, tp = _both(_params(0))
    rng = np.random.default_rng(1)
    h = rng.standard_normal(lead + (H,)).astype(np.float32)
    x = rng.standard_normal(lead + (IN,)).astype(np.float32)
    _close(rnn.rnn_forward(tp, torch.from_numpy(h), torch.from_numpy(x)),
           jrnn.rnn_forward(jp, jnp.asarray(h), jnp.asarray(x)))


@pytest.mark.parametrize("batch", [None, 1, 6])
def test_rnn_update(batch):
    """One sample or a batch whose outer products are summed."""
    jp, tp = _both(_params(2))
    rng = np.random.default_rng(3)
    lead = () if batch is None else (batch,)
    h, target = (rng.standard_normal(lead + (H,)).astype(np.float32)
                 for _ in range(2))
    x = rng.standard_normal(lead + (IN,)).astype(np.float32)
    want = jrnn.rnn_update(jp, jnp.asarray(h), jnp.asarray(x),
                           jnp.asarray(target), 0.05)
    got = rnn.rnn_update(tp, torch.from_numpy(h), torch.from_numpy(x),
                         torch.from_numpy(target), 0.05)
    assert set(got) == {"Wh", "Wx", "b"}
    for k in got:
        _close(got[k], want[k])
    # the inputs are not changed in place
    assert np.array_equal(tp["Wh"].numpy(), _params(2)["Wh"])


@pytest.mark.parametrize("in_dim,dt", [(IN, 0.37), (1, 2.5), (IN, 0.0)])
def test_rnn_project(in_dim, dt):
    jp, tp = _both(_params(4, in_dim))
    emb = np.random.default_rng(5).standard_normal((7, H)).astype(np.float32)
    _close(rnn.rnn_project(tp, torch.from_numpy(emb), dt),
           jrnn.rnn_project(jp, jnp.asarray(emb), dt))


@pytest.mark.parametrize("scale", [None, 0.1])
def test_init_rnn_cell_law(scale):
    p = rnn.init_rnn_cell(seeded_generator(0, 0, CPU), 40, 32, scale=scale,
                          device=CPU)
    s = 1.0 / np.sqrt(32) if scale is None else scale
    assert p["Wh"].shape == (32, 32) and p["Wx"].shape == (32, 40)
    assert p["b"].shape == (32,) and not p["b"].any()
    for w in (p["Wh"], p["Wx"]):
        assert w.dtype == torch.float32
        assert float(w.abs().max()) <= s
        # uniform(-s, s): mean 0, variance s^2 / 3
        assert abs(float(w.mean())) < 0.1 * s
        assert abs(float(w.var()) / (s * s / 3) - 1) < 0.15
    # seeded: the same generator state draws the same cell
    q = rnn.init_rnn_cell(seeded_generator(0, 0, CPU), 40, 32, scale=scale,
                          device=CPU)
    assert all(torch.equal(p[k], q[k]) for k in p)
