"""The port's SASRec family (smore_tpu_torch/models/sasrec.py) against
smore_tpu/models/sasrec.py, at 2 blocks, 2 heads, D=16, L=8.

Given ``load_flax_params`` of the flax tree: the hidden states with dropout
off agree at atol 1e-5; the loss given fixed negatives (and, for
Rec-Denoiser, fixed Gumbel uniforms) at rtol 1e-5; every gradient at rtol
1e-4, atol 1e-6; two Adam steps' parameters at atol 1e-3 * alpha (float32
sums in another order; Adam's first step is about alpha * sign(g)). The
forward-only step leaves every parameter but the item table bit-unchanged.
``build_sequences`` and ``sinusoidal_positions`` are bit-equal and
``evaluate_ranking`` agrees within 1/n users. A run killed after an epoch's
checkpoint and resumed is step-identical on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import smore_tpu.models.sasrec as jsas
from smore_tpu_torch.models import sasrec as sas
from torch_graph_call_cases import optax_adam

torch.set_num_threads(1)

CPU = "cpu"
D, L, BLOCKS, HEADS, K = 16, 8, 2, 2, 3
MODELS = ["SASRec", "GSASRec", "RecDenoiser"]
ALPHA = 0.01


def _edges(path, seed=0, users=14, items=15):
    """User -> item edges in file order; some users under 2 items, some
    over L + 1 (so sequences are cut and left-padded)."""
    rng = np.random.default_rng(seed)
    lines = []
    for u in range(users):
        for _ in range(int(rng.integers(1, 14))):
            lines.append(f"u{u} i{rng.integers(0, items)} 1\n")
    rng.shuffle(lines)
    path.write_text("".join(lines))
    return str(path)


def _pair(path, name, dropout=0.0, **kw):
    jm = getattr(jsas, name).load_edge_list(path, negative_samples=K, **kw)
    jm.init(dim=D, max_seq_len=L, num_blocks=BLOCKS, num_heads=HEADS,
            dropout=dropout)
    m = getattr(sas, name).load_edge_list(path, negative_samples=K,
                                          device=CPU, **kw)
    m.init(dim=D, max_seq_len=L, num_blocks=BLOCKS, num_heads=HEADS,
           dropout=dropout)
    m.load_flax_params(jax.tree.map(np.asarray, jm.params))
    return jm, m


def _draws(jm, batch, seed=1):
    """Fixed negatives (B, L, K) and each block's (2, L, L) uniforms."""
    rng = np.random.default_rng(seed)
    negs = rng.integers(0, jm.graph.n_vertices,
                        (batch.shape[0], L, K)).astype(np.int32)
    us = [rng.uniform(1e-6, 1 - 1e-6, (2, L, L)).astype(np.float32)
          for _ in range(BLOCKS)]
    return negs, us


def _jax_value_and_grad(jm, params, batch, negs, us, monkeypatch):
    """The JAX loss and gradients with its negative and Gumbel draws
    replaced by ``negs`` and ``us``."""
    it = iter(us)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda *a, **k: jnp.asarray(next(it)))
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.asarray(negs))
    out = jax.value_and_grad(jm._loss_fn)(params, jnp.asarray(batch),
                                          jax.random.PRNGKey(0))
    monkeypatch.undo()
    return out


def _port_loss(m, batch, negs, us):
    return m.loss_fn(torch.from_numpy(batch).long(),
                     negs=torch.from_numpy(negs).long(),
                     gumbel_u=[torch.from_numpy(u) for u in us])


def _as_port(m, tree):
    """A flax-layout tree (params, gradients) in the port's layout:
    {parameter name: tensor}."""
    twin = type(m)(m.graph, negative_samples=K, device=CPU)
    twin.init(dim=D, max_seq_len=L, num_blocks=BLOCKS, num_heads=HEADS,
              dropout=0.0)
    twin.load_flax_params(jax.tree.map(np.asarray, tree))
    return dict(twin.net.named_parameters())


def test_sinusoidal_positions_bit_equal():
    for max_len, dim in ((8, 16), (50, 64), (7, 5), (1, 2)):
        a = sas.sinusoidal_positions(max_len, dim)
        b = jsas.sinusoidal_positions(max_len, dim)
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_build_sequences_bit_equal(tmp_path, seed):
    jm, m = _pair(_edges(tmp_path / "e.txt", seed), "SASRec")
    a, b = m.build_sequences(), jm.build_sequences()
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert a.shape[1] == L + 1 and (a == m.graph.n_vertices).any()


@pytest.mark.parametrize("name", MODELS)
def test_hidden_states_dropout_off(tmp_path, name):
    jm, m = _pair(_edges(tmp_path / "e.txt"), name, dropout=0.2)
    seqs = jm.build_sequences()[:, :-1]  # left-padded rows included
    got = m.hidden_states(seqs).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.hidden_states(seqs)),
                               rtol=0, atol=1e-5)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(m.score_next(seqs).numpy(),
                               np.asarray(jm.score_next(seqs)), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("name", MODELS)
def test_loss_and_every_gradient(tmp_path, name, monkeypatch):
    jm, m = _pair(_edges(tmp_path / "e.txt", 2), name, beta=0.3)
    batch = jm.build_sequences()
    negs, us = _draws(jm, batch)
    lj, gj = _jax_value_and_grad(jm, jm.params, batch, negs, us,
                                 monkeypatch)
    loss = _port_loss(m, batch, negs, us)
    np.testing.assert_allclose(float(loss.detach()), float(lj), rtol=1e-5)
    loss.backward()
    want = _as_port(m, gj)
    got = dict(m.net.named_parameters())
    assert set(got) == set(want)
    for k, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), want[k].detach().numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", MODELS)
def test_two_adam_steps(tmp_path, name, monkeypatch):
    """The port's optimiser against optax.adam, fed the same gradients (the
    JAX ones): a gradient that is float noise around 0 in both packages
    (the key bias, which the softmax cancels) makes Adam's first step
    +-alpha in either, so the gradients are held to each other above and
    the update rule here."""
    jm, m = _pair(_edges(tmp_path / "e.txt", 3), name)
    batch = jm.build_sequences()
    negs, us = _draws(jm, batch, seed=4)
    _, gj = _jax_value_and_grad(jm, jm.params, batch, negs, us, monkeypatch)
    tx = optax.adam(ALPHA)
    params, opt_state = jm.params, tx.init(jm.params)
    opt = m.make_optimizer(ALPHA)
    grads = _as_port(m, gj)
    for _ in range(2):
        upd, opt_state = tx.update(gj, opt_state)
        params = optax.apply_updates(params, upd)
        for k, p in m.net.named_parameters():
            p.grad = grads[k].detach().clone()
        opt.step()
    want = _as_port(m, params)
    for k, p in m.net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want[k].detach().numpy(), rtol=0,
                                   atol=1e-3 * ALPHA, err_msg=k)
    # and the port's own step from its own gradients moves every parameter
    # whose gradient is not noise by the same amount
    _, m2 = _pair(_edges(tmp_path / "e.txt", 3), name)
    opt2 = m2.make_optimizer(ALPHA)
    _port_loss(m2, batch, negs, us).backward()
    opt2.step()
    want1 = _as_port(m2, optax.apply_updates(
        jm.params, tx.update(gj, tx.init(jm.params))[0]))
    for k, p in m2.net.named_parameters():
        g = grads[k].detach().abs()
        solid = (g > 1e3 * 1e-8) | (g == 0)
        np.testing.assert_allclose(p.detach()[solid].numpy(),
                                   want1[k].detach()[solid].numpy(), rtol=0,
                                   atol=1e-3 * ALPHA, err_msg=k)


@pytest.mark.parametrize("name", MODELS)
def test_numpy_adam_is_optax_adam(tmp_path, name, monkeypatch):
    """``optax_adam``, the reference the card's optimiser is held to in
    tests/test_torch_gpu.py, against optax.adam on the JAX parameters and
    gradients, two steps: elementwise float32 in either, so within a few
    float32 ulps of the parameters."""
    jm, m = _pair(_edges(tmp_path / "e.txt", 3), name)
    batch = jm.build_sequences()
    negs, us = _draws(jm, batch, seed=4)
    _, gj = _jax_value_and_grad(jm, jm.params, batch, negs, us, monkeypatch)
    tx = optax.adam(ALPHA)
    params, opt_state = jm.params, tx.init(jm.params)
    for _ in range(2):
        upd, opt_state = tx.update(gj, opt_state)
        params = optax.apply_updates(params, upd)
    want = _as_port(m, params)
    got = optax_adam({k: v.detach().numpy()
                      for k, v in _as_port(m, jm.params).items()},
                     {k: v.detach().numpy()
                      for k, v in _as_port(m, gj).items()}, ALPHA, 2)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v.detach().numpy(), rtol=0,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("name", MODELS)
def test_forward_only_step_trains_the_item_table_alone(tmp_path, name):
    _, m = _pair(_edges(tmp_path / "e.txt", 5), name, dropout=0.2)
    before = {k: p.detach().clone() for k, p in m.net.named_parameters()}
    m.train(epochs=1, batch_size=4, alpha=ALPHA, verbose=False,
            forward_only=True)
    for k, p in m.net.named_parameters():
        if k == "item.weight":
            assert not torch.equal(p, before[k])
        else:
            assert torch.equal(p, before[k]), k


@pytest.mark.parametrize("name", ["SASRec", "RecDenoiser"])
def test_evaluate_ranking_agrees(tmp_path, name):
    jm, m = _pair(_edges(tmp_path / "e.txt", 6, users=40, items=20), name)
    seqs = jm.build_sequences()
    jm._holdout_seqs = m._holdout_seqs = seqs
    a = m.evaluate_ranking(ks=(1, 5, 10), batch_size=7)
    b = jm.evaluate_ranking(ks=(1, 5, 10), batch_size=7)
    assert set(a) == set(b)
    for k in a:
        assert abs(a[k] - b[k]) <= 1.0 / len(seqs), k
    with pytest.raises(ValueError):
        type(m)(m.graph, device=CPU).evaluate_ranking()


def test_weight_file_byte_equal(tmp_path):
    jm, m = _pair(_edges(tmp_path / "e.txt", 7), "GSASRec")
    jm.save_weights(str(tmp_path / "jax.txt"))
    m.save_weights(str(tmp_path / "port.txt"))
    a = (tmp_path / "port.txt").read_bytes()
    assert a == (tmp_path / "jax.txt").read_bytes()
    # the pad row is dropped: one row per vertex
    assert a.split(b"\n")[0] == f"{m.graph.n_vertices} {D}".encode()


def test_init_laws(tmp_path):
    m = sas.RecDenoiser.load_edge_list(
        _edges(tmp_path / "e.txt", 8, users=300, items=200), device=CPU)
    dim = 64
    m.init(dim=dim, max_seq_len=L, num_blocks=BLOCKS, num_heads=HEADS)
    net = m.net
    item = net.item.weight.detach()
    assert item.shape == (m.graph.n_vertices + 1, dim)
    assert abs(float(item.std()) / (0.5 / dim) - 1) < 0.05
    for blk in net.blocks:
        for lin in (blk.q, blk.k, blk.v, blk.o, blk.ff0, blk.ff1):
            w = lin.weight.detach()
            s = np.sqrt(1.0 / lin.in_features)  # lecun-normal's std
            assert abs(float(w.std()) / s - 1) < 0.1
            assert float(w.abs().max()) <= 2 * s / 0.87962566103423978
            assert not lin.bias.any()
        for ln in (blk.ln0, blk.ln1):
            assert bool((ln.weight == 1).all()) and not ln.bias.any()
        assert bool((blk.mask_logits == 2.0).all())
        assert blk.mask_logits.shape == (L, L)
        assert blk.ln0.eps == 1e-6
    # the same seed draws the same network
    m2 = sas.RecDenoiser(m.graph, device=CPU)
    m2.init(dim=dim, max_seq_len=L, num_blocks=BLOCKS, num_heads=HEADS)
    for (k, p), q in zip(net.named_parameters(), m2.net.parameters()):
        assert torch.equal(p, q), k


@pytest.mark.parametrize("name", ["SASRec", "RecDenoiser"])
def test_kill_after_an_epoch_then_resume_is_step_identical(tmp_path, name,
                                                           monkeypatch):
    path = _edges(tmp_path / "e.txt", 9, users=30)
    kw = dict(epochs=3, batch_size=8, alpha=ALPHA, verbose=False,
              holdout=True)

    def fresh():
        m = getattr(sas, name).load_edge_list(path, negative_samples=K,
                                              device=CPU, seed=2)
        m.init(dim=D, max_seq_len=L, num_blocks=BLOCKS, num_heads=HEADS,
               dropout=0.2)
        return m

    ref = fresh()
    ref.train(checkpoint=str(tmp_path / "ref"), **kw)
    ck = str(tmp_path / "ck")
    saves = []
    real_save = sas.save_checkpoint

    def killing_save(*a, **k):
        real_save(*a, **k)
        saves.append(k["step"])
        if len(saves) == 2:
            raise KeyboardInterrupt  # the kill, right after a save

    monkeypatch.setattr(sas, "save_checkpoint", killing_save)
    with pytest.raises(KeyboardInterrupt):
        fresh().train(checkpoint=ck, **kw)
    monkeypatch.setattr(sas, "save_checkpoint", real_save)
    assert saves == [1, 2]
    b = fresh()
    b.train(checkpoint=ck, **kw)
    for (k, p), q in zip(ref.net.named_parameters(), b.net.parameters()):
        assert torch.equal(p, q), k
    assert b.evaluate_ranking() == ref.evaluate_ranking()


def test_learns_a_successor_chain(tmp_path):
    """Each item has one successor, on one 30-item cycle (so no held-out
    target repeats its user's 8 earlier items): full autodiff ranks it in
    the top 10 for most held-out users (chance is 10 of the 130
    vertices)."""
    rng = np.random.default_rng(10)
    ring = rng.permutation(30)
    succ = np.empty(30, np.int64)
    succ[ring] = np.roll(ring, -1)
    lines = []
    for u in range(100):
        it = int(rng.integers(0, 30))
        for _ in range(9):
            lines.append(f"u{u} i{it} 1\n")
            it = int(succ[it])
    (tmp_path / "e.txt").write_text("".join(lines))
    m = sas.SASRec.load_edge_list(str(tmp_path / "e.txt"), device=CPU,
                                  negative_samples=3)
    m.init(dim=D, max_seq_len=L, num_blocks=1, num_heads=1, dropout=0.0)
    m.train(epochs=40, batch_size=25, alpha=0.01, verbose=False,
            holdout=True)
    assert m.evaluate_ranking()["recall@10"] > 0.9
