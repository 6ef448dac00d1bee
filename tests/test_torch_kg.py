"""The port's knowledge-graph family (TransE, RotatE, ComplEx) against
smore_tpu's.

- The triple loader is bit-equal: triples, weights, names, the
  per-relation entity pools.
- ``_score`` of the three models on the JAX model's init tables: rtol 1e-5,
  atol 1e-6.
- One step fed the JAX step's triple ids and the uniforms its key draws
  (TransE L2 and L1, also with coordinates of h + r - t exactly 0, where
  JAX's |x| has gradient 1 and torch's 0; RotatE with and without the
  adversarial weight; ComplEx): every table within rtol 1e-5, atol 1e-6.
- ``evaluate_link_prediction`` gives the same (MRR, hits@3) on one state.
- ``save_embeddings`` files byte-equal to the JAX package's on one state.
- A run killed after half its epochs and resumed from its checkpoint ends
  on the uninterrupted run's tables bit for bit (CPU, one thread).
- The learning gates of tests/test_kg_models.py, at its arguments.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smore_tpu.models.kg as JKG
import smore_tpu_torch.models.kg as TKG
from smore_tpu.graph.knowledge import KnowledgeGraph as JKnowledgeGraph
from smore_tpu_torch.graph.knowledge import KnowledgeGraph
from smore_tpu_torch.models import ComplEx, RotatE, TransE

# one intra-op thread: test workers share the cores, and a thread pool
# in each of them oversubscribes the CPU on these tiny shapes
torch.set_num_threads(1)

CPU = torch.device("cpu")  # the port defaults to the card
TOL = dict(rtol=1e-5, atol=1e-6)
LR = 0.05
MODELS = {
    "transe_l2": (JKG.TransE, TransE, dict(norm=2)),
    "transe_l1": (JKG.TransE, TransE, dict(norm=1)),
    "rotate": (JKG.RotatE, RotatE, dict(margin=3.0, adversarial_temp=10.0)),
    "rotate_noadv": (JKG.RotatE, RotatE, dict(margin=3.0,
                                              adversarial_temp=0.0)),
    "complex": (JKG.ComplEx, ComplEx, {}),
}


@pytest.fixture(scope="module")
def kg_path(tmp_path_factory):
    """tests/test_kg_models.py's people-food-cuisine triples."""
    rng = np.random.default_rng(11)
    lines = []
    foods = {0: [f"f{j}" for j in range(0, 12, 2)],
             1: [f"f{j}" for j in range(1, 12, 2)]}
    for c, fs in foods.items():
        for f in fs:
            lines.append(f"{f} in c{c}\n")
    for i in range(16):
        for f in rng.choice(foods[i % 2], 4, replace=False):
            lines.append(f"p{i} likes {f}\n")
    p = tmp_path_factory.mktemp("kg") / "triples.txt"
    p.write_text("".join(lines))
    return str(p)


@pytest.fixture(scope="module")
def kgs(kg_path):
    return JKnowledgeGraph.load_triples(kg_path), KnowledgeGraph.load_triples(
        kg_path)


def test_loader_bit_equal(tmp_path):
    """Weights, a bad weight token, short lines and repeated names."""
    p = tmp_path / "t.txt"
    p.write_text("a r1 b 2.5\nb r2 c\nshort line\nc r1 a x\n"
                 "d r2 a 0.5\nb r1 d\n\na r2 b\n")
    jk, tk = JKnowledgeGraph.load_triples(str(p)), KnowledgeGraph.load_triples(
        str(p))
    for f in ("heads", "relations", "tails", "weights", "rel_indptr",
              "rel_entities"):
        a, b = getattr(jk, f), getattr(tk, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert tk.entities == jk.entities
    assert tk.relations_names == jk.relations_names
    assert tk.entity2id == jk.entity2id and tk.relation2id == jk.relation2id
    assert (tk.n_entities, tk.n_relations, tk.n_triples) == (4, 2, 6)


def _pair(name, kgs, dim=8):
    """The JAX model and the port's on the same triples, the port holding
    the JAX model's init tables."""
    jcls, tcls, kw = MODELS[name]
    jm = jcls(kgs[0], seed=0, **kw)
    jm.init(dim=dim)
    tm = tcls(kgs[1], seed=0, device=CPU, **kw)
    tm.init(dim=dim)
    assert {k: v.shape for k, v in tm.state.items()} == {
        k: v.shape for k, v in jm.state.items()}
    tm.load_state_numpy({k: np.asarray(v) for k, v in jm.state.items()})
    assert tm.dim == dim
    return jm, tm


@pytest.mark.parametrize("name", sorted(MODELS))
def test_score_matches_jax(name, kgs):
    jm, tm = _pair(name, kgs)
    rng = np.random.default_rng(1)
    kg = kgs[0]
    h, t = rng.integers(0, kg.n_entities, (2, 40))
    r = rng.integers(0, kg.n_relations, 40)
    want = np.asarray(jm._score(jm.state, jnp.asarray(h), jnp.asarray(r),
                                jnp.asarray(t)))
    got = tm._score(tm.state, torch.from_numpy(h), torch.from_numpy(r),
                    torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _zero_coordinate_state(jm, kg):
    """Dyadic tables (sums exact) whose first 4 coordinates of h + r - t
    are exactly 0 for every triple."""
    rng = np.random.default_rng(3)
    st = {k: np.round(rng.uniform(-1, 1, np.shape(v)) * 64) / 64
          for k, v in jm.state.items()}
    st["entity"][:, :4] = 0.25
    st["relation"][:, :4] = 0.0
    return {k: v.astype(np.float32) for k, v in st.items()}


@pytest.mark.parametrize("name,zero", [
    ("transe_l2", False), ("transe_l1", False), ("transe_l1", True),
    ("transe_l2", True), ("rotate", False), ("rotate_noadv", False),
    ("complex", False)])
def test_one_step_fed_jax_draws(name, zero, kgs):
    jm, tm = _pair(name, kgs)
    kg = kgs[0]
    if zero:
        st = _zero_coordinate_state(jm, kg)
        jm.state = {k: jnp.asarray(v) for k, v in st.items()}
        tm.load_state_numpy(st)
    B = 32
    idx = np.random.default_rng(2).permutation(kg.n_triples)[:B]
    key = jax.random.PRNGKey(4)
    jstate = {k: jnp.array(v) for k, v in jm.state.items()}
    js, jl = jm._make_step(B)(jstate, jnp.asarray(idx, dtype=jnp.int32), key,
                              jnp.float32(LR))
    k1, k2 = jax.random.split(key)
    u = torch.from_numpy(np.stack([np.asarray(jax.random.uniform(k1, (B,))),
                                   np.asarray(jax.random.uniform(k2, (B,)))]))
    if zero:
        # the case is real: some gated triple has exact zero coordinates
        d = (tm.state["entity"][kg.heads[idx]] + tm.state["relation"][
            kg.relations[idx]] - tm.state["entity"][kg.tails[idx]])
        assert (d[:, :4] == 0).all()
    tl = tm._make_step()(tm.state, torch.from_numpy(idx), u, LR)
    for k in js:
        np.testing.assert_allclose(tm.state[k].numpy(), np.asarray(js[k]),
                                   err_msg=k, **TOL)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    if zero and name == "transe_l1":
        # torch's own abs would have left those coordinates unmoved
        moved = tm.state["entity"][:, :4] != 0.25
        assert moved.any()


def test_jax_abs_gradient_convention():
    """The convention the L1 step relies on: 1 at 0 in JAX, 0 in torch."""
    assert float(jax.grad(jnp.abs)(0.0)) == 1.0
    x = torch.zeros(1, requires_grad=True)
    TKG._abs_jax(x).sum().backward()
    assert float(x.grad) == 1.0


@pytest.mark.parametrize("name", ["transe_l2", "rotate", "complex"])
def test_evaluate_link_prediction_equal(name, kgs):
    jm, tm = _pair(name, kgs)
    want = jm.evaluate_link_prediction(test_triples=50, num_negatives=10,
                                       seed=3)
    assert tm.evaluate_link_prediction(test_triples=50, num_negatives=10,
                                       seed=3) == want


@pytest.mark.parametrize("name", ["transe_l2", "rotate", "complex"])
def test_save_embeddings_byte_equal(name, kgs, tmp_path):
    jm, tm = _pair(name, kgs)
    jm.save_embeddings(str(tmp_path / "je.txt"), str(tmp_path / "jr.txt"))
    tm.save_embeddings(str(tmp_path / "te.txt"), str(tmp_path / "tr.txt"))
    assert (tmp_path / "te.txt").read_bytes() == (
        tmp_path / "je.txt").read_bytes()
    assert (tmp_path / "tr.txt").read_bytes() == (
        tmp_path / "jr.txt").read_bytes()


def _train(tm, ckpt=None, epochs=4, **kw):
    tm.train(epochs=epochs, batch=16, alpha=0.02, verbose=False,
             checkpoint=ckpt, **kw)
    return {k: v.clone() for k, v in tm.state.items()}


@pytest.mark.parametrize("name", ["transe_l1", "rotate", "complex"])
def test_kill_at_half_then_resume_is_step_identical(name, kgs, tmp_path,
                                                    monkeypatch):
    jcls, tcls, kw = MODELS[name]

    def fresh():
        m = tcls(kgs[1], seed=0, device=CPU, **kw)
        m.init(dim=8)
        return m

    ref = _train(fresh())
    ckpt = str(tmp_path / "ck")
    real_save = TKG.save_checkpoint

    def killing_save(path, state, step=0, extra=None):
        real_save(path, state, step=step, extra=extra)
        if step == 2:
            raise KeyboardInterrupt("simulated preemption")

    monkeypatch.setattr(TKG, "save_checkpoint", killing_save)
    with pytest.raises(KeyboardInterrupt):
        _train(fresh(), ckpt)
    monkeypatch.undo()
    got = _train(fresh(), ckpt)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


def test_resume_with_other_epochs_warns(kgs, tmp_path, capsys):
    ckpt = str(tmp_path / "ck")
    m = TransE(kgs[1], seed=0, device=CPU)
    m.init(dim=8)
    _train(m, ckpt, epochs=2)
    capsys.readouterr()
    _train(m, ckpt, epochs=3)
    assert "re-stretches" in capsys.readouterr().out


def _rank_gate(tcls, kg_path, **kw):
    """tests/test_kg_models.py's gate: known (p, likes, f) triples outscore
    corrupted tails on average after 60 epochs."""
    kg = KnowledgeGraph.load_triples(kg_path)
    m = tcls(kg, seed=0, device=CPU, **kw)
    m.init(dim=16)
    m.train(epochs=60, batch=32, alpha=0.05, verbose=False)
    rid = kg.relation2id["likes"]
    sel = kg.relations == rid
    h = torch.from_numpy(kg.heads[sel][:32])
    t = torch.from_numpy(kg.tails[sel][:32])
    r = torch.full((32,), rid, dtype=torch.int32)
    t_bad = torch.from_numpy(np.random.default_rng(0).integers(
        0, kg.n_entities, 32))
    pos = m._score(m.state, h, r, t).mean()
    neg = m._score(m.state, h, r, t_bad).mean()
    assert (pos > neg) if m._higher_is_better else (pos < neg)
    return m


def test_transe_learns(kg_path, tmp_path):
    m = _rank_gate(TransE, kg_path, norm=2)
    m.save_embeddings(str(tmp_path / "e.txt"), str(tmp_path / "r.txt"))
    header = (tmp_path / "e.txt").read_text().split("\n")[0]
    assert header == f"{m.kg.n_entities} 16"


def test_transe_l1_learns(kg_path):
    _rank_gate(TransE, kg_path, norm=1)


def test_rotate_learns(kg_path):
    m = _rank_gate(RotatE, kg_path, margin=3.0, adversarial_temp=10.0)
    rel = m._relation_out().numpy()
    d = rel.shape[1] // 2
    np.testing.assert_allclose(rel[:, :d] ** 2 + rel[:, d:] ** 2, 1.0,
                               atol=1e-5)


def test_complex_learns(kg_path):
    _rank_gate(ComplEx, kg_path)


def test_transe_entities_normalized(kg_path):
    m = TransE(KnowledgeGraph.load_triples(kg_path), seed=0, device=CPU)
    m.init(dim=8)
    m.train(epochs=3, batch=16, alpha=0.01, verbose=False)
    norms = np.linalg.norm(m.state["entity"].numpy(), axis=1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)
