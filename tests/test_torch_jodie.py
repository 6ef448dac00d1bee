"""The port's JODIE (smore_tpu_torch/models/jodie.py and its scan,
smore_tpu_torch/ops/jodie_epoch.py) against smore_tpu/models/jodie.py.

Given ``load_state_numpy`` of the JAX model's state and the negatives the
JAX epoch draws from its key (events with neg == i among them), one epoch
of about 300 events at dim 8, and at dims 50 and 128 (dims the card's
kernel takes since its levelled redesign), with features and without,
leaves the same dynamic and static tables and the same mean loss at atol
1e-5 (float32 sums in another order); two epochs threaded through the statics agree with
the JAX ``train``; ``project``, ``evaluate_predictions`` and the weight
files agree; a run killed after an epoch's checkpoint and resumed is
step-identical on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smore_tpu.graph.bipartite import InteractionGraph as JaxIG
from smore_tpu.models.jodie import JODIE as JaxJODIE
from smore_tpu_torch.models import jodie as jodie_mod
from smore_tpu_torch.models.jodie import JODIE
from smore_tpu_torch.ops.jodie_epoch import (
    KERNEL,
    jodie_epoch,
    jodie_epoch_ref,
)

torch.set_num_threads(1)

ATOL = 1e-5
CPU = "cpu"


def _events(path, seed=0, events=300, users=7, items=9, features=True):
    """Events with time ties; two feature columns when ``features``."""
    rng = np.random.default_rng(seed)
    t, lines = 0.0, []
    for _ in range(events):
        if rng.random() < 0.8:
            t += float(rng.integers(0, 3))
        line = f"u{rng.integers(0, users)} i{rng.integers(0, items)} {t}"
        if features:
            line += f" {rng.random():.3f} {rng.random():.3f}"
        lines.append(line + "\n")
    path.write_text("".join(lines))
    return str(path)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(path, dim=8):
    jm = JaxJODIE(JaxIG.load_interactions(path), seed=0)
    jm.init(dim)
    m = JODIE.load_interactions(path, device=CPU)
    m.load_state_numpy(_np(jm.state))
    return jm, m


def _jax_negs(key, ig):
    return np.array(jax.random.randint(key, (ig.n_interactions,), 0,
                                       ig.n_items))


def _close(got, want):
    np.testing.assert_allclose(got.numpy() if isinstance(got, torch.Tensor)
                               else got, np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("features", [True, False])
@pytest.mark.parametrize("bce_lr", [0.0, 0.05, 0.2])
def test_one_epoch_matches_jax(tmp_path, features, bce_lr):
    jm, m = _pair(_events(tmp_path / "ev.txt", features=features))
    key = jax.random.PRNGKey(11)
    negs = _jax_negs(key, jm.ig)
    assert (negs == jm.ig.item_ids).any(), "no event with neg == i"
    want = jm._epoch_fn()(jm.state, key, jnp.float32(0.05),
                          jnp.float32(bce_lr))
    got = m.epoch(m.state, 0.05, bce_lr, negs=torch.from_numpy(negs))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("bce_lr", [0.0, 0.2])
@pytest.mark.parametrize("features", [True, False])
@pytest.mark.parametrize("dim", [50, 128])
def test_one_epoch_matches_jax_at_width(tmp_path, dim, features, bce_lr):
    jm, m = _pair(_events(tmp_path / "ev.txt", seed=12, events=200,
                          features=features), dim=dim)
    key = jax.random.PRNGKey(13)
    negs = _jax_negs(key, jm.ig)
    assert (negs == jm.ig.item_ids).any(), "no event with neg == i"
    want = jm._epoch_fn()(jm.state, key, jnp.float32(0.05),
                          jnp.float32(bce_lr))
    got = m.epoch(m.state, 0.05, bce_lr, negs=torch.from_numpy(negs))
    assert got[0].shape == (jm.ig.n_users, dim)
    for g, w in zip(got, want):
        _close(g, w)


def test_two_epochs_through_the_statics(tmp_path):
    """JAX ``train``'s loop: each epoch restarts the dynamics from the
    statics the last one left; the port's epochs fed the same draws."""
    path = _events(tmp_path / "ev.txt", seed=1)
    jm, m = _pair(path)
    jm.train(epochs=2, learning_rate=0.05, bce_lr=0.1, verbose=False)
    key = jax.random.PRNGKey(jm.seed + 1)
    state = m.state
    for _ in range(2):
        key, ke = jax.random.split(key)
        ue, ie, us, is_, _ = m.epoch(
            state, 0.05, 0.1, negs=torch.from_numpy(_jax_negs(ke, jm.ig)))
        state = dict(state, user_static=us, item_static=is_)
    _close(ue, jm.user_dyn)
    _close(ie, jm.item_dyn)
    _close(state["user_static"], jm.state["user_static"])
    _close(state["item_static"], jm.state["item_static"])


def test_project_and_evaluate(tmp_path):
    jm, m = _pair(_events(tmp_path / "ev.txt", seed=2))
    emb = np.random.default_rng(3).standard_normal((5, 8)).astype(np.float32)
    for dt in (0.0, -2.0, 7.5):
        _close(m.project(torch.from_numpy(emb), dt),
               jm.project(jnp.asarray(emb), dt))
    t = torch.from_numpy(emb)
    assert m.project(t, 0.0) is t and m.project(t, -1.0) is t
    # the same dynamic tables score the same
    rng = np.random.default_rng(4)
    ue = rng.standard_normal((jm.ig.n_users, 8)).astype(np.float32)
    ie = rng.standard_normal((jm.ig.n_items, 8)).astype(np.float32)
    jm.user_dyn, jm.item_dyn = jnp.asarray(ue), jnp.asarray(ie)
    m.user_dyn, m.item_dyn = torch.from_numpy(ue), torch.from_numpy(ie)
    assert m.evaluate_predictions() == jm.evaluate_predictions()
    assert m.evaluate_predictions(tail=20) == jm.evaluate_predictions(
        tail=20)


def test_weight_files_and_state_round_trip(tmp_path):
    jm, m = _pair(_events(tmp_path / "ev.txt", seed=5))
    jm.train(epochs=1, learning_rate=0.05, verbose=False)
    m.load_state_numpy(_np(jm.state))
    m.user_dyn = torch.from_numpy(np.array(jm.user_dyn))
    m.item_dyn = torch.from_numpy(np.array(jm.item_dyn))
    files = {k: [str(tmp_path / f"{k}_{s}.txt") for s in "ui"]
             for k in ("jax", "port")}
    jm.save_weights(*files["jax"])
    m.save_weights(*files["port"])
    for a, b in zip(files["port"], files["jax"]):
        assert open(a, "rb").read() == open(b, "rb").read()
    back = m.state_numpy()
    want = _np(jm.state)
    assert set(back) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            assert all(np.array_equal(back[k][n], v[n]) for n in v)
        else:
            assert np.array_equal(back[k], v)


def test_init_laws(tmp_path):
    m = JODIE.load_interactions(_events(tmp_path / "ev.txt", users=60,
                                        items=80, events=400), device=CPU)
    m.init(32)
    st = m.state
    for k, rows in (("user_static", m.ig.n_users),
                    ("item_static", m.ig.n_items)):
        t = st[k]
        assert t.shape == (rows, 32)
        assert float(t.abs().max()) <= 0.5 / 32  # (U(0,1) - 0.5) / dim
    in_dim = 32 + 2 + 1  # dim + features + dt
    for name, n_in in (("user_rnn", in_dim), ("item_rnn", in_dim),
                       ("proj_rnn", 1)):
        p = st[name]
        assert p["Wh"].shape == (32, 32) and p["Wx"].shape == (32, n_in)
        assert float(p["Wh"].abs().max()) <= 0.1 and not p["b"].any()
    assert torch.equal(m.user_dyn, st["user_static"])


def test_time_gaps_match_the_scan(tmp_path):
    """(t - the row's last event time) / 100, the first from min_time: the
    JAX scan's carried last-time arrays, replayed on the host."""
    ig = JaxIG.load_interactions(_events(tmp_path / "ev.txt", seed=6))
    got = jodie_mod._time_gaps(ig.user_order, ig.user_indptr, ig.timestamps,
                               ig.min_time)
    last = np.full(ig.n_users, np.float32(ig.min_time), np.float32)
    want = np.empty(ig.n_interactions, np.float32)
    for e, u in enumerate(ig.user_ids):
        want[e] = (ig.timestamps[e] - last[u]) / np.float32(100.0)
        last[u] = ig.timestamps[e]
    assert np.array_equal(got, want)


def test_kill_after_an_epoch_then_resume_is_step_identical(tmp_path,
                                                           monkeypatch):
    path = _events(tmp_path / "ev.txt", seed=7)

    def fresh():
        m = JODIE.load_interactions(path, device=CPU, seed=3)
        m.init(8)
        return m

    ref = fresh()
    ref.train(epochs=3, learning_rate=0.05, bce_lr=0.2, verbose=False,
              checkpoint=str(tmp_path / "ref"))
    ck = str(tmp_path / "ck")
    saves = []
    real_save = jodie_mod.save_checkpoint

    def killing_save(*a, **kw):
        real_save(*a, **kw)
        saves.append(kw["step"])
        if len(saves) == 2:
            raise KeyboardInterrupt  # the kill, right after a save

    monkeypatch.setattr(jodie_mod, "save_checkpoint", killing_save)
    with pytest.raises(KeyboardInterrupt):
        fresh().train(epochs=3, learning_rate=0.05, bce_lr=0.2,
                      verbose=False, checkpoint=ck)
    monkeypatch.setattr(jodie_mod, "save_checkpoint", real_save)
    assert saves == [1, 2]
    b = fresh()
    b.train(epochs=3, learning_rate=0.05, bce_lr=0.2, verbose=False,
            checkpoint=ck)
    assert torch.equal(b.user_dyn, ref.user_dyn)
    assert torch.equal(b.item_dyn, ref.item_dyn)
    for k in ("user_static", "item_static"):
        assert torch.equal(b.state[k], ref.state[k])
    # a finished checkpoint trains nothing more and keeps the tables
    c = fresh()
    c.train(epochs=3, learning_rate=0.05, bce_lr=0.2, verbose=False,
            checkpoint=ck)
    assert torch.equal(c.user_dyn, ref.user_dyn)


def test_bce_step_learns(tmp_path):
    """With bce_lr the BCE signal trains the tables: the statics' pairwise
    accuracy on the last events rises well above chance on a clustered
    set (users meet only their cluster's items)."""
    rng = np.random.default_rng(8)
    t, lines = 0.0, []
    for _ in range(1500):
        u = int(rng.integers(0, 12))
        t += float(rng.random())
        lines.append(f"u{u} i{int(rng.choice(np.arange(u % 3, 24, 3)))} "
                     f"{t:.3f}\n")
    (tmp_path / "ev.txt").write_text("".join(lines))
    m = JODIE.load_interactions(str(tmp_path / "ev.txt"), device=CPU)
    m.init(16)
    m.train(epochs=4, learning_rate=0.05, bce_lr=0.2, verbose=False)
    m.user_dyn, m.item_dyn = m.state["user_static"], m.state["item_static"]
    assert m.evaluate_predictions() > 0.8


def test_wrapper_raises_off_cpu_and_on_bad_shapes(tmp_path):
    _, m = _pair(_events(tmp_path / "ev.txt", seed=9))
    st = m.state
    up, ip = st["user_rnn"], st["item_rnn"]
    uid, iid, cu, ci = m.scan_inputs(st)
    ue, ie = st["user_static"].clone(), st["item_static"].clone()
    args = [ue, ie, ue.clone(), ie.clone(), uid, iid, iid.clone(), cu, ci]
    meta = [a.to("meta") for a in args]
    metap = [{k: v.to("meta") for k, v in p.items()} for p in (up, ip)]
    with pytest.raises(ValueError, match="no kernel"):
        jodie_epoch(*meta, *metap, 0.05, 0.05)
    bad = list(args)
    bad[7] = cu[:, :4].contiguous()
    with pytest.raises(ValueError):
        jodie_epoch(*bad, up, ip, 0.05, 0.05)
    bad = list(args)
    bad[6] = iid[:-1]
    with pytest.raises(ValueError):
        jodie_epoch(*bad, up, ip, 0.05, 0.05)
    # on the CPU the wrapper is the plain loop, and launches nothing
    before = KERNEL.launches
    a = [t.clone() for t in args]
    b = [t.clone() for t in args]
    la = jodie_epoch(*a, up, ip, 0.05, 0.1)
    lb = jodie_epoch_ref(*b, up, ip, 0.05, 0.1)
    assert torch.equal(la, lb) and all(torch.equal(x, y)
                                       for x, y in zip(a, b))
    assert KERNEL.launches == before
