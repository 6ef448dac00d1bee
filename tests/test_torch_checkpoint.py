"""Checkpoint / resume and warm start in the port.

- ``utils/checkpoint``: round trip, one file per directory, a failed write
  leaves the previous checkpoint whole.
- Kill at 50% and resume in a fresh model is step-identical (bit-equal
  tables) to an uninterrupted run, for LINE's unbanded route, LINE's banded
  multiblock route (forced on a toy graph, padded tables), DeepWalk (epoch
  hoist), APP, BPR (hoisted shared pool), NERANK (four tables), ECO (one
  table) and FINE (two shadow tables): the
  learning rate is a function of the restored step
  counter and the draws of the restored generator state. This holds on the
  CPU with one intra-op thread, where every sum runs in one order.
- Resuming a finished run trains nothing; ``resume=False`` starts again and
  overwrites.
- ``warm_start`` (native and Python readers) and ``load_pretrain`` are
  bit-equal to smore_tpu's.
"""

import os

import numpy as np
import pytest
import torch

import smore_tpu.native.fastgraph as JFG
import smore_tpu_torch.native.fastgraph as TFG
from smore_tpu.graph.graph import Graph as JGraph
from smore_tpu.io.embeddings import warm_start as j_warm_start
from smore_tpu.models import DeepWalk as JDeepWalk
from smore_tpu_torch.graph.graph import Graph
from smore_tpu_torch.io.embeddings import warm_start
from smore_tpu_torch.models import APP, BPR, ECO, FINE, LINE, NERANK, DeepWalk
from smore_tpu_torch.models.base import TrainDriver
from smore_tpu_torch.utils.checkpoint import (
    checkpoint_exists,
    load_checkpoint,
    save_checkpoint,
)

# one intra-op thread: test workers share the cores, a thread pool in each
# of them oversubscribes the CPU, and one thread sums in one order
torch.set_num_threads(1)

CPU = torch.device("cpu")  # the port defaults to the card


def _edges(n=60, e=400, seed=0):
    """tests/test_checkpoint_resume.py's toy graph."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(e):
        a, b = rng.integers(0, n, 2)
        if a != b:
            out.append((f"n{a}", f"n{b}", round(rng.uniform(0.5, 2.0), 3)))
    return out


@pytest.fixture(scope="module")
def toy():
    return Graph.from_edges(_edges(), undirected=True)


@pytest.fixture(scope="module")
def banded_graph():
    """200 vertices in 4 bands of 64 rows."""
    return Graph.from_edges(_edges(n=200, e=3000, seed=7), undirected=True)


# ------------------------------------------------------ checkpoint files
def test_checkpoint_round_trip(tmp_path):
    path = str(tmp_path / "ck")
    assert not checkpoint_exists(path)
    os.makedirs(path)
    assert not checkpoint_exists(path)  # a directory without the file
    big = torch.arange(40, dtype=torch.float32).reshape(10, 4)
    gen = torch.Generator().manual_seed(5)
    state = {"vertex": big[:3], "context": torch.ones(3, 4)}
    save_checkpoint(path, state, step=7, extra={"gen": gen.get_state()})
    assert checkpoint_exists(path)
    assert os.listdir(path) == ["checkpoint.pt"]
    loaded, step, extra = load_checkpoint(path)
    assert step == 7 and set(loaded) == {"vertex", "context"}
    for k, v in state.items():
        assert torch.equal(loaded[k], v) and loaded[k].device == CPU
    # a view is stored as its own rows, not its base tensor's
    assert loaded["vertex"].untyped_storage().nbytes() == 3 * 4 * 4
    g2 = torch.Generator()
    g2.set_state(extra["gen"])
    assert torch.equal(torch.rand(4, generator=g2),
                       torch.rand(4, generator=gen))
    assert load_checkpoint(path)[2] is not None
    save_checkpoint(path, state, step=8)
    assert load_checkpoint(path)[1:] == (8, None)


def test_failed_write_keeps_previous_checkpoint(tmp_path, monkeypatch):
    path = str(tmp_path / "ck")
    save_checkpoint(path, {"vertex": torch.zeros(2, 2)}, step=1)

    def torn_save(obj, f):
        f.write(b"half a checkpoint")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", torn_save)
    with pytest.raises(OSError, match="disk full"):
        save_checkpoint(path, {"vertex": torch.ones(2, 2)}, step=2)
    monkeypatch.undo()
    state, step, _ = load_checkpoint(path)
    assert step == 1 and torch.equal(state["vertex"], torch.zeros(2, 2))
    assert os.listdir(path) == ["checkpoint.pt"]


# ------------------------------------------------------ kill and resume
def _line(g, **kw):
    m = LINE(g, seed=0, device=CPU)
    m.init(dim=kw.pop("dim", 8), order=2)
    return m


def _walker(cls):
    def make(g, **kw):
        m = cls(g, seed=0, device=CPU)
        m.init(dim=8)
        return m
    return make


CASES = {
    # batch clamped to the vertex count, 4 steps a call: 17 calls
    "line_unbanded": (_line, "toy", dict(
        sample_times=0.004, negative_samples=2, alpha=0.02, batch=64,
        steps_per_call=4, group=1)),
    # the multiblock route's twin: 16 micro-steps of 128 samples a
    # superstep, 2 supersteps a call: 8 calls on padded 2D band tables
    "line_banded_multiblock": (lambda g: _line(g, dim=64), "banded", dict(
        sample_times=0.032, batch=128, steps_per_call=32, banded=True,
        band_size=64, multiband=True)),
    # truncated budget: batch 8, epoch hoist 8, one step a call: 10 calls
    "deepwalk": (_walker(DeepWalk), "toy", dict(
        walk_times=10, walk_steps=10, window_size=3, negative_samples=2,
        steps_per_call=8)),
    # 1200 walks, batch 8, epoch hoist 8, one step a call: 19 calls
    "app": (_walker(APP), "toy", dict(
        walk_times=10, sample_times=2, jump=0.3, steps_per_call=8)),
    # batch clamped to 60, 8 inner batches a step (the shared pool's
    # hoist), 4 steps a call: 11 calls
    "bpr": (_walker(BPR), "toy", dict(sample_times=0.02,
                                      steps_per_call=32)),
    # four tables, batch 60, 4 steps a call: 9 calls
    "nerank": (_walker(NERANK), "toy", dict(
        sample_times=0.002, walk_steps=2, negative_samples=3,
        steps_per_call=4)),
    # one table, 5 rounds folded into each batch of 60: 9 calls
    "eco": (_walker(ECO), "toy", dict(
        sample_times=0.002, negative_samples=3, steps_per_call=4)),
    # two shadow tables and the context walk, batch 60: 9 calls
    "fine": (_walker(FINE), "toy", dict(
        sample_times=0.002, walk_steps=2, negative_samples=3,
        steps_per_call=4)),
}


def _kill_then_resume(make, g, kw, ckpt, monkeypatch):
    """(uninterrupted model, model resumed after a kill at half the
    calls)."""
    ref = make(g)
    ref.train(verbose=False, **kw)
    d = ref.last_driver
    steps = -(-d.total_samples // d.samples_per_step)
    calls = -(-steps // d.steps_per_call)
    kill_at = calls // 2
    assert kill_at >= 2

    saves = []
    orig = TrainDriver._save_ckpt

    def killing_save(self, state, gen, done):
        orig(self, state, gen, done)
        saves.append(done)
        if len(saves) == kill_at:
            raise KeyboardInterrupt("simulated preemption")

    a = make(g)
    a.set_checkpoint(ckpt, every=1)
    monkeypatch.setattr(TrainDriver, "_save_ckpt", killing_save)
    with pytest.raises(KeyboardInterrupt):
        a.train(verbose=False, **kw)
    monkeypatch.undo()
    assert len(saves) == kill_at

    b = make(g)
    b.set_checkpoint(ckpt, every=1)
    b.train(verbose=False, **kw)
    done = saves[-1] * d.samples_per_step
    assert b.last_driver.executed_samples == d.executed_samples - done
    return ref, b


@pytest.mark.parametrize("case", sorted(CASES))
def test_kill_at_half_then_resume_is_step_identical(case, toy, banded_graph,
                                                    tmp_path, monkeypatch):
    make, gname, kw = CASES[case]
    g = toy if gname == "toy" else banded_graph
    ckpt = str(tmp_path / "ck")
    ref, b = _kill_then_resume(make, g, kw, ckpt, monkeypatch)
    assert set(b.state) == set(ref.state)
    for k, v in ref.state.items():
        assert b.state[k].shape == (g.n_vertices, v.shape[1])
        assert torch.equal(b.state[k], v), k
    if case.startswith("line_banded"):  # TrainDriver holds padded tables
        saved, _, _ = load_checkpoint(ckpt)
        n_pad = b.banded_tables.n_rows_padded
        assert n_pad > g.n_vertices
        assert saved["vertex"].shape == (n_pad, 64)
        assert torch.equal(saved["vertex"][:g.n_vertices], ref.state["vertex"])


@pytest.mark.parametrize("case", ["line_unbanded", "deepwalk"])
def test_resume_of_finished_run_is_a_no_op(case, toy, tmp_path):
    make, _, kw = CASES[case]
    ckpt = str(tmp_path / "ck")
    m = make(toy)
    m.set_checkpoint(ckpt, every=1)
    m.train(verbose=False, **kw)
    m2 = make(toy)
    m2.set_checkpoint(ckpt, every=1)
    m2.train(verbose=False, **kw)
    assert m2.last_driver.executed_samples == 0
    for k, v in m.state.items():
        assert torch.equal(m2.state[k], v)


def test_resume_false_overwrites(toy, tmp_path):
    _, _, kw = CASES["deepwalk"]
    ckpt = str(tmp_path / "ck")
    other = DeepWalk(toy, seed=1, device=CPU)
    other.init(dim=8)
    other.set_checkpoint(ckpt)
    other.train(verbose=False, **kw)
    ref = _walker(DeepWalk)(toy)
    ref.train(verbose=False, **kw)
    m = _walker(DeepWalk)(toy)
    m.set_checkpoint(ckpt, resume=False)
    m.train(verbose=False, **kw)
    assert m.last_driver.executed_samples == ref.last_driver.executed_samples
    saved, step, _ = load_checkpoint(ckpt)
    for k, v in ref.state.items():
        assert torch.equal(m.state[k], v)
        assert torch.equal(saved[k], v)
    assert not torch.equal(saved["vertex"], other.state["vertex"])


def test_checkpoint_every_sets_the_cadence(toy, tmp_path, monkeypatch):
    """Every ``every`` calls and after the last one."""
    _, _, kw = CASES["line_unbanded"]
    saves = []
    orig = TrainDriver._save_ckpt

    def record(self, state, gen, done):
        saves.append(done)
        orig(self, state, gen, done)

    monkeypatch.setattr(TrainDriver, "_save_ckpt", record)
    m = _line(toy)
    m.set_checkpoint(str(tmp_path / "ck"), every=5)
    m.train(verbose=False, **kw)
    d = m.last_driver
    S = d.steps_per_call
    calls = -(-(-(-d.total_samples // d.samples_per_step)) // S)
    assert calls > 10
    assert saves == [c * S for c in range(5, calls, 5)] + [calls * S]


def test_ckpt_kw_phases(toy):
    m = _line(toy)
    assert m._ckpt_kw() == {} and m._ckpt_kw("p") == {}
    m.set_checkpoint("/ck", every=3, resume=False)
    assert m._ckpt_kw() == {"checkpoint_path": "/ck", "checkpoint_every": 3,
                            "resume": False}
    assert m._ckpt_kw("phase1")["checkpoint_path"] == os.path.join(
        "/ck", "phase1")
    m.set_checkpoint(None)
    assert m._ckpt_kw() == {}


# ----------------------------------------------------------- warm start
def _pretrain_file(tmp_path, names, dim=8):
    """A saved-embedding file with rows of the right length, rows of the
    wrong length, unknown names and a name given twice."""
    rng = np.random.default_rng(4)
    lines = [f"{len(names)} {dim}"]
    for i, nm in enumerate(names[::2]):
        k = dim + (1 if i % 7 == 3 else 0)
        lines.append(nm + " " + " ".join(f"{v:.7g}" for v in
                                         rng.normal(size=k) * 10))
    lines.append("nobody " + " ".join(["1.5"] * dim))
    lines.append(names[0] + " " + " ".join(["-0.25e-3"] * dim))
    p = tmp_path / "pre.txt"
    p.write_text("\n".join(lines) + "\n")
    return str(p)


@pytest.mark.parametrize("route", ["native_f32", "python_f32",
                                   "python_f64"])
def test_warm_start_bit_equal_to_jax(toy, tmp_path, monkeypatch, route):
    names = toy.names
    path = _pretrain_file(tmp_path, names)
    dtype = np.float64 if route == "python_f64" else np.float32
    table = np.random.default_rng(0).normal(size=(len(names), 8)).astype(
        dtype)
    if route == "python_f32":
        monkeypatch.setattr(TFG, "available", lambda: False)
        monkeypatch.setattr(JFG, "available", lambda: False)
    else:
        assert TFG.available() and JFG.available()
    got = warm_start(table, names, path)
    want = j_warm_start(table, names, path)
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, table)
    np.testing.assert_array_equal(got[1::2], table[1::2])  # not in the file


def test_load_pretrain_bit_equal_to_jax(toy, tmp_path):
    path = _pretrain_file(tmp_path, toy.names)
    jm = JDeepWalk(JGraph.from_edges(_edges(), undirected=True), seed=0)
    jm.init(dim=8)
    tm = DeepWalk(toy, seed=0, device=CPU)
    tm.load_state_numpy({k: np.asarray(v) for k, v in jm.state.items()})
    vertex = tm.state["vertex"]
    for table in ("vertex", "context"):
        jm.load_pretrain(path, table=table)
        tm.load_pretrain(path, table=table)
        np.testing.assert_array_equal(tm.state[table].numpy(),
                                      np.asarray(jm.state[table]))
    assert tm.state["vertex"] is vertex  # in place
