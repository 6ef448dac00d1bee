"""The calls of the models that run their own loops (TransE, RotatE,
ComplEx, HAN, SASRec, gSASRec, Rec-Denoiser) on the CPU: what the card
captures as one CUDA graph a call.

- The capture guard (tests/test_torch_graph_call.py's ``CaptureGuard``):
  every call of a ``train()`` has no host sync and no data-dependent shape;
  for the SASRec family the loss and the backward (the CPU's Adam is not
  ``capturable``, so its update is held on the card).
- Each family's call, an epoch or ``steps_per_call`` steps, is bit-equal
  to the eager loop it replaced, from the same generator.
- KG's staged rates are the JAX loop's ``jnp.float32(lr)`` bit for bit, and
  one KG step on a staged (1,) rate agrees with the JAX step.
- With a stand-in graph (capture keeps the call, a replay runs what was
  captured): the first call eager, each kind captured once, every later
  call a replay; kill and resume at an epoch boundary step-identical.

The capture itself is held on the card (tests/test_torch_gpu.py, marker
``gpu``, and chip_smoke.py phase 36).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smore_tpu.models.kg as JKG
import smore_tpu_torch.models.han as THAN
import smore_tpu_torch.models.kg as TKG
import smore_tpu_torch.models.sasrec as TSAS
from smore_tpu.graph.knowledge import KnowledgeGraph as JKnowledgeGraph
from smore_tpu_torch.models import base
from smore_tpu_torch.models.base import (
    ALPHA_MIN_FRAC,
    TRAIN_STREAM,
    CapturedCalls,
    OwnLoop,
    clamp_batch,
    epoch_calls,
    seeded_generator,
)
from test_torch_graph_call import CaptureGuard, RecordingGraph
from torch_graph_call_cases import OWN_LOOP_CHUNK as CHUNK
from torch_graph_call_cases import (
    OWN_LOOP,
    SEQ,
    build_own_loop,
    own_loop_state,
)

# one intra-op thread: test workers share the cores, and a thread pool
# in each of them oversubscribes the CPU on these tiny shapes
torch.set_num_threads(1)

CPU = torch.device("cpu")  # the port defaults to the card
MODULES = {"TransE": TKG, "RotatE": TKG, "ComplEx": TKG, "HAN": THAN,
           "SASRec": TSAS, "GSASRec": TSAS, "RecDenoiser": TSAS}


class PausableGuard(CaptureGuard):
    """The guard, off while ``paused``."""

    paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.paused:
            return func(*args, **(kwargs or {}))
        return super().__torch_dispatch__(func, types, args, kwargs)


@pytest.mark.parametrize("steps", [None, "chunk"])
@pytest.mark.parametrize("name", OWN_LOOP)
def test_a_call_has_no_sync_and_no_data_dependent_shape(name, steps,
                                                        monkeypatch,
                                                        tmp_path):
    m, kw = build_own_loop(name, CPU, str(tmp_path),
                           steps_per_call=CHUNK[name] if steps else None)
    guard = PausableGuard()
    runs = []
    orig = CapturedCalls.__call__

    def guarded(self, run, kind=None):
        def under_guard():
            runs.append(kind)
            with guard:
                run()
        orig(self, under_guard, kind)

    monkeypatch.setattr(CapturedCalls, "__call__", guarded)
    if name in SEQ:
        step = torch.optim.Adam.step

        def unguarded_step(self, *a, **k):
            guard.paused = True
            try:
                return step(self, *a, **k)
            finally:
                guard.paused = False

        monkeypatch.setattr(torch.optim.Adam, "step", unguarded_step)
    m.train(**kw)
    c = m.last_calls
    assert c.calls == len(runs) >= 3 and c.replays == 0  # eager on the CPU
    for k, v in own_loop_state(m).items():
        assert bool(torch.isfinite(v).all()), k


# ------------------------------------------- the loops the calls replaced
def _kg_eager_loop(m, epochs, batch, alpha, verbose=False):
    """``_KGBase.train`` before its calls: a permutation, then a rate and
    a step a batch, the renorm at the epoch's end."""
    n = m.kg.n_triples
    batch = clamp_batch(min(n, m.kg.n_entities), batch)
    n_batches = max(1, n // batch)
    step = m._make_step()
    gen = seeded_generator(m.seed, TRAIN_STREAM, m.device)
    total, done = epochs * n_batches, 0
    for _ in range(epochs):
        perm = torch.randperm(n, generator=gen, device=m.device)
        perm = perm[: n_batches * batch].reshape(n_batches, batch)
        for b in range(n_batches):
            u = torch.rand((2, batch), generator=gen, device=m.device)
            lr = max(alpha * (1.0 - done / total), alpha * ALPHA_MIN_FRAC)
            step(m.state, perm[b], u, lr)
            done += 1
        m._renorm(m.state)
    return gen


def _han_eager_loop(m, epochs, batch, walk_times, walk_steps,
                    verbose=False):
    step = m._make_step(batch, walk_times, walk_steps)
    ctx = m._make_ctx()
    gen = seeded_generator(m.seed, TRAIN_STREAM, m.device)
    for _ in range(epochs * max(1, m.hg.n_vertices // batch + 1)):
        step(m.state, ctx, gen)
    return gen


def _seq_eager_loop(m, epochs, batch_size, alpha, verbose=False):
    seqs = m.build_sequences()
    n_seq = len(seqs)
    opt = m.make_optimizer(alpha)
    gen = seeded_generator(m.seed, TRAIN_STREAM, m.device)
    bs = min(batch_size, n_seq)
    n_batches = max(1, n_seq // bs)
    seqs_d = torch.from_numpy(seqs).long().to(m.device)
    for _ in range(epochs):
        perm = torch.randperm(n_seq, generator=gen, device=m.device)
        perm = perm[: n_batches * bs].view(n_batches, bs)
        for b in range(n_batches):
            loss = m.loss_fn(seqs_d[perm[b]], gen)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
    return gen


def _eager_loop(name):
    if name == "HAN":
        return _han_eager_loop
    return _seq_eager_loop if name in SEQ else _kg_eager_loop


@pytest.mark.parametrize("steps", [None, "chunk"])
@pytest.mark.parametrize("name", OWN_LOOP)
def test_the_calls_are_bit_equal_to_the_eager_loop(name, steps, tmp_path):
    got, kw = build_own_loop(name, CPU, str(tmp_path),
                             steps_per_call=CHUNK[name] if steps else None)
    got.train(**kw)
    n_calls = got.last_calls.calls
    want, kw = build_own_loop(name, CPU, str(tmp_path))
    gen = _eager_loop(name)(want, **kw)
    assert n_calls == (3 if steps is None else 6)  # each epoch 2 calls
    assert torch.equal(got.last_calls.gen.get_state(), gen.get_state())
    for k, v in own_loop_state(want).items():
        assert torch.equal(own_loop_state(got)[k], v), k


def test_epoch_calls():
    assert epoch_calls(6, None) == [6]
    assert epoch_calls(6, 4) == [4, 2]
    assert epoch_calls(6, 3) == [3, 3]
    assert epoch_calls(6, 9) == [6]
    assert epoch_calls(47, 10) == [10, 10, 10, 10, 7]


# ---------------------------------------------------------- the KG rates
@pytest.fixture(scope="module")
def kg_path(tmp_path_factory):
    from smore_tpu_torch.utils import oracle_data as od

    return od.make_kg(str(tmp_path_factory.mktemp("kg") / "kg.txt"),
                      n_clusters=2, per=20, n_rel=2, triples_per_rel=100)


def test_kg_staged_rates_are_jax_rates_bit_for_bit(kg_path, monkeypatch,
                                                   tmp_path):
    """The rates the port stages each epoch are the ones the JAX loop
    passes its step, ``jnp.float32(lr)`` (smore_tpu/models/kg.py), for an
    uninterrupted run and for a resumed one."""
    epochs, alpha, batch = 5, 0.0173, 32
    jm = JKG.TransE(JKnowledgeGraph.load_triples(kg_path), seed=0)
    jm.init(dim=8)
    seen_jax = []

    def recording_step(state, idx, key, lr):
        seen_jax.append(np.asarray(lr))
        return state, jnp.float32(0)

    monkeypatch.setattr(jm, "_make_step", lambda b: recording_step)
    jm.train(epochs=epochs, batch=batch, alpha=alpha, verbose=False)
    want = np.stack(seen_jax)
    assert want.dtype == np.float32

    tm, _ = build_own_loop("TransE", CPU, str(tmp_path))
    seen = []
    orig = base._AlphaStaging.put

    def recording_put(self, values, dst):
        seen.append(values.copy())
        orig(self, values, dst)

    monkeypatch.setattr(base._AlphaStaging, "put", recording_put)
    tm.train(epochs=epochs, batch=batch, alpha=alpha, verbose=False)
    got = np.concatenate(seen)
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    n_batches = len(want) // epochs
    for ep in range(epochs):  # a run resumed at epoch ep stages the same
        assert TKG.kg_rates(ep * n_batches, n_batches, alpha,
                            len(want)).tobytes() == want[
            ep * n_batches:(ep + 1) * n_batches].tobytes()


KG_MODELS = {
    "transe_l2": (JKG.TransE, TKG.TransE, dict(norm=2)),
    "transe_l1": (JKG.TransE, TKG.TransE, dict(norm=1)),
    "rotate": (JKG.RotatE, TKG.RotatE, dict(margin=3.0,
                                            adversarial_temp=10.0)),
    "complex": (JKG.ComplEx, TKG.ComplEx, {}),
}


@pytest.mark.parametrize("name", sorted(KG_MODELS))
def test_kg_step_on_a_staged_rate_matches_jax(name, kg_path):
    """One step as a call runs it (its rate a float32 (1,) tensor read from
    the staged buffer) against the JAX step on the same ids and uniforms:
    every table within tests/test_torch_kg.py's rtol 1e-5, atol 1e-6."""
    jcls, tcls, kw = KG_MODELS[name]
    jm = jcls(JKnowledgeGraph.load_triples(kg_path), seed=0, **kw)
    jm.init(dim=8)
    tm = tcls(TKG.KnowledgeGraph.load_triples(kg_path), seed=0, device=CPU,
              **kw)
    tm.load_state_numpy({k: np.asarray(v) for k, v in jm.state.items()})
    B, lr = 32, 0.05
    idx = np.random.default_rng(2).permutation(jm.kg.n_triples)[:B]
    key = jax.random.PRNGKey(4)
    js, jl = jm._make_step(B)({k: jnp.array(v) for k, v in jm.state.items()},
                              jnp.asarray(idx, dtype=jnp.int32), key,
                              jnp.float32(lr))
    k1, k2 = jax.random.split(key)
    u = torch.from_numpy(np.stack([np.asarray(jax.random.uniform(k1, (B,))),
                                   np.asarray(jax.random.uniform(k2, (B,)))]))
    rates = torch.from_numpy(TKG.kg_rates(0, 3, lr, 3))
    tl = tm._make_step()(tm.state, torch.from_numpy(idx), u,
                         rates.index_select(0, torch.zeros(1, dtype=int)))
    for k in js:
        np.testing.assert_allclose(tm.state[k].numpy(), np.asarray(js[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-6)


# ------------------------------------ the captured path, with a stand-in
def _on_stand_in(monkeypatch):
    """Every own-loop model captures its calls, on the CPU too, into
    RecordingGraph, its warm-up run inline."""
    monkeypatch.setattr(base, "CallGraph", RecordingGraph)
    monkeypatch.setattr(base, "_warm_up", lambda run, device: run())
    monkeypatch.setattr(OwnLoop, "_captures", lambda self: True)


@pytest.mark.parametrize("steps", [None, "chunk"])
@pytest.mark.parametrize("name", ["TransE", "HAN", "SASRec"])
def test_replays_run_what_was_captured(name, steps, monkeypatch, tmp_path):
    """Through the stand-in graph every call but the first is a replay of
    its kind's graph (an epoch; or the first, middle and last calls of an
    epoch, by length), and the result is the eager loop's bit for bit."""
    chunk = CHUNK[name] if steps else None
    eager, kw = build_own_loop(name, CPU, str(tmp_path), steps_per_call=chunk)
    eager.train(**kw)
    _on_stand_in(monkeypatch)
    m, kw = build_own_loop(name, CPU, str(tmp_path), steps_per_call=chunk)
    m.train(**kw)
    c = m.last_calls
    assert c.replays == c.calls - 1 == eager.last_calls.calls - 1
    kinds = {"TransE": {None: [(True, True, 6)],
                        4: [(False, True, 2), (True, False, 4)]},
             "HAN": {None: [4], 3: [1, 3]},
             "SASRec": {None: [(True, 4)], 3: [(False, 1), (True, 3)]}}
    assert sorted(c.nodes, key=str) == sorted(kinds[name][chunk], key=str)
    assert c.graphs == {}  # dropped by close()
    for k, v in own_loop_state(eager).items():
        assert torch.equal(own_loop_state(m)[k], v), k


@pytest.mark.parametrize("name", OWN_LOOP)
def test_captured_kill_and_resume_at_an_epoch_boundary_is_step_identical(
        name, monkeypatch, tmp_path):
    _on_stand_in(monkeypatch)
    full, kw = build_own_loop(name, CPU, str(tmp_path), epochs=4)
    full.train(**kw)
    assert full.last_calls.replays == 3

    mod = MODULES[name]
    saves = []
    orig = mod.save_checkpoint

    def killing_save(*a, **k):
        orig(*a, **k)
        saves.append(k["step"])
        if len(saves) == 2:  # after the warm-up epoch and a replay
            raise KeyboardInterrupt

    ck = str(tmp_path / "ck")
    a, kw = build_own_loop(name, CPU, str(tmp_path), epochs=4)
    monkeypatch.setattr(mod, "save_checkpoint", killing_save)
    with pytest.raises(KeyboardInterrupt):
        a.train(checkpoint=ck, **kw)
    monkeypatch.setattr(mod, "save_checkpoint", orig)
    assert saves == [1, 2]
    b, kw = build_own_loop(name, CPU, str(tmp_path), epochs=4)
    b.train(checkpoint=ck, **kw)
    assert b.last_calls.calls == 2 and b.last_calls.replays == 1
    for k, v in own_loop_state(full).items():
        assert torch.equal(own_loop_state(b)[k], v), k


def test_what_is_captured():
    """On the card by default; not on the CPU, not with capture=False."""

    class Model(OwnLoop):
        def __init__(self, device, capture=True):
            self.device, self.capture = torch.device(device), capture

    assert Model("cuda")._captures()
    assert not Model("cpu")._captures()
    assert not Model("cuda", capture=False)._captures()
