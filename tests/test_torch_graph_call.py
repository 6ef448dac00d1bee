"""TrainDriver's call on the CPU: what the card captures as one CUDA graph.

- The capture guard: one call of every StepFn meant to be captured (each
  single-device LINE route, one or more models of every family that
  trains through ``PairModelBase._drive``) under a TorchDispatchMode that
  fails on a host sync (``aten._local_scalar_dense``: ``.item()``,
  ``int()``, ``float()``) or an op whose output shape depends on the data
  (``nonzero``, ``unique*``, ``masked_select``, ``repeat_interleave`` with
  tensor repeats): neither can be captured. The guard catches a step that
  does.
- Driver parity with smore_tpu's TrainDriver: the call of static buffers
  gives tables bit-equal to the eager loop it replaced (LINE unbanded and
  multiblock); call k's alphas are JAX's traced ``sched`` for call k bit
  for bit; a call's loss is ``jnp.mean`` of its steps' losses.
- The captured path's control flow (warm-up, capture, replays) with a
  stand-in graph: checkpoint and resume at a call boundary step-identical;
  each launch counter credited, on every replay, the launches the graph
  holds, which must equal how far it moved while the call was captured;
  the collectives a capture tallied credited on every replay, not timed.

The capture itself is held on the card (tests/test_torch_gpu.py, marker
``gpu``, and chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smore_tpu.models.base import TrainDriver as JDriver
from smore_tpu_torch.models import LINE, base
from smore_tpu_torch.models.base import TrainDriver, alpha_schedule
from smore_tpu_torch.ops import launches
from smore_tpu_torch.ops.sgns import K1
from smore_tpu_torch.ops.sgns_banded import K4
from smore_tpu_torch.parallel import mesh
from smore_tpu_torch.parallel.mesh import CommStats
from torch_graph_call_cases import CASES, CaptureGuard, build, toy_graph

# one intra-op thread: test workers share the cores, and a thread pool
# in each of them oversubscribes the CPU on these tiny shapes
torch.set_num_threads(1)

CPU = torch.device("cpu")  # the port defaults to the card


@pytest.fixture
def guarded_calls(monkeypatch):
    """Every TrainDriver call runs under the guard; yields the drivers."""
    drivers = []
    orig = TrainDriver._call

    def call(self, *a):
        drivers.append(self)
        with CaptureGuard():
            orig(self, *a)

    monkeypatch.setattr(TrainDriver, "_call", call)
    return drivers


@pytest.mark.parametrize("case", CASES)
def test_a_call_has_no_sync_and_no_data_dependent_shape(case, guarded_calls,
                                                        tmp_path):
    m, kw = build(case, CPU, str(tmp_path))
    m.train(**kw)
    assert guarded_calls, "no call ran"
    for d in guarded_calls:
        assert d.calls >= 1 and d.replays == 0  # eager on the CPU
    for k, v in m.state.items():
        assert bool(torch.isfinite(v).all()), k


def _syncing_step(kind):
    def step(state, ctx, gen, alpha):
        w = state["w"]
        if kind == "item":
            w.add_(float(alpha.item()))
        elif kind == "nonzero":
            w.index_fill_(0, torch.nonzero(w[:, 0]).flatten(), 0.5)
        elif kind == "bool_index":
            w[w > 0] *= 0.5
        else:
            w.add_(torch.unique(w).sum())
        return state, w.sum()

    return step


@pytest.mark.parametrize("kind", ["item", "nonzero", "bool_index",
                                  "unique"])
def test_the_guard_catches_a_step_that_syncs(kind, guarded_calls):
    d = TrainDriver(_syncing_step(kind), ctx=None, samples_per_step=1,
                    alpha=0.1, total_samples=8, steps_per_call=2,
                    device=CPU)
    with pytest.raises(AssertionError, match="cannot be captured"):
        d.train({"w": torch.ones(4, 3)}, torch.Generator(), verbose=False)


# ------------------------------------------------------- driver parity
def _old_eager_loop(self, state, gen, done, steps_total, inv_total, verbose,
                    t0):
    """The loop the call replaced: a fresh alpha tensor a call, the steps
    threaded through a dict, the tables as the last step left them."""
    S, M = self.steps_per_call, self.micro_steps
    cur = dict(state)
    while done < steps_total:
        alphas = torch.from_numpy(alpha_schedule(
            done, S, M, self.alpha, inv_total)).to(self.device)
        for i in range(S):
            cur, _ = self.step_fn(cur, self.ctx, gen, alphas[i])
        done += S
        self.calls += 1
    state.update(cur)
    return done


@pytest.mark.parametrize("route", ["line_unbanded_g8", "line_multiblock"])
def test_the_call_is_bit_equal_to_the_eager_loop(route, monkeypatch,
                                                 tmp_path):
    got, kw = build(route, CPU, str(tmp_path))
    got.train(**kw)
    assert got.last_driver.calls >= 3
    want, kw = build(route, CPU, str(tmp_path))
    monkeypatch.setattr(TrainDriver, "_train_calls", _old_eager_loop)
    want.train(**kw)
    for k in want.state:
        assert torch.equal(got.state[k], want.state[k]), k


def _recorded_alphas(M):
    """Alphas seen by each step of each call, from both drivers."""
    sps, total, S, alpha = 96, 77_777, 5, 0.0173
    steps = -(-total // sps)

    def jstep(st, ctx, key, a):
        a = jnp.reshape(a, (-1,))
        log = jax.lax.dynamic_update_slice(st["log"], a, (st["i"][0] * M,))
        return {"log": log, "i": st["i"] + 1}, jnp.float32(0)

    jd = JDriver(jstep, ctx=None, samples_per_step=sps, alpha=alpha,
                 total_samples=total, steps_per_call=S, micro_steps=M)
    call = jd._make_call()
    inv_total = float(sps) / float(total)
    want = []
    for k in (0, 1, steps // S):
        sched = jnp.asarray((float(k * S), alpha, alpha * 1e-4, inv_total),
                            dtype=jnp.float32)
        st = {"log": jnp.zeros(S * M, jnp.float32),
              "i": jnp.zeros(1, jnp.int32)}
        st, _, _ = call(st, None, jax.random.PRNGKey(0), sched)
        want.append(np.asarray(st["log"]))

    seen = []

    def tstep(state, ctx, gen, a):
        seen.append(a.reshape(-1).clone())
        return state, torch.zeros(())

    td = TrainDriver(tstep, ctx=None, samples_per_step=sps, alpha=alpha,
                     total_samples=total, steps_per_call=S, micro_steps=M,
                     device=CPU)
    td.train({}, torch.Generator(), verbose=False)
    per_call = torch.cat(seen).numpy().reshape(-1, S * M)
    got = [per_call[k] for k in (0, 1, steps // S)]
    return got, want


@pytest.mark.parametrize("M", [1, 4])
def test_call_k_alphas_are_jax_traced_sched_bit_for_bit(M):
    got, want = _recorded_alphas(M)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_a_calls_loss_is_the_jax_mean_of_its_steps():
    S = 8
    losses = np.random.default_rng(0).integers(-512, 512, (3, S)) / 256.0
    losses = losses.astype(np.float32)  # a 2^-8 grid: both means are exact

    def jstep(st, ctx, key, a):
        return {"i": st["i"] + 1}, jnp.asarray(losses.reshape(-1))[st["i"][0]]

    jd = JDriver(jstep, ctx=None, samples_per_step=1, alpha=0.1,
                 total_samples=3 * S, steps_per_call=S)
    call = jd._make_call()
    st = {"i": jnp.zeros(1, jnp.int32)}
    want = []
    for k in range(3):
        sched = jnp.asarray((k * S, 0.1, 1e-5, 1.0 / (3 * S)), jnp.float32)
        st, _, jl = call(st, None, jax.random.PRNGKey(0), sched)
        want.append(float(jl))

    flat = torch.from_numpy(losses.reshape(-1))
    got = []
    orig = TrainDriver._call

    def call_and_read(self, *a):
        orig(self, *a)
        got.append(float(a[-1]))

    def tstep(state, ctx, gen, a):
        state["i"] += 1
        return state, flat[int(state["i"]) - 1].clone()

    td = TrainDriver(tstep, ctx=None, samples_per_step=1, alpha=0.1,
                     total_samples=3 * S, steps_per_call=S, device=CPU)
    td._call = call_and_read.__get__(td)
    td.train({"i": torch.zeros((), dtype=torch.int64)}, torch.Generator(),
             verbose=False)
    assert got == want == [float(np.mean(r)) for r in losses]


# ------------------------------------ the captured path, with a stand-in
class RecordingGraph:
    """Capture keeps the call and runs nothing; a replay runs it, as the
    card would run what capture recorded."""

    def __init__(self, gen, error_mode="global"):
        self.run = None

    def capture(self, run):
        self.run = run

    def kernel_launches(self):
        return {}

    def replay(self):
        self.run()


def _on_stand_in(monkeypatch, graph_cls):
    """Every TrainDriver captures its calls, on the CPU too, into
    ``graph_cls``, its warm-up run inline."""
    monkeypatch.setattr(base, "CallGraph", graph_cls)
    monkeypatch.setattr(base, "_warm_up", lambda run, device: run())
    monkeypatch.setattr(TrainDriver, "_captures", lambda self: True)


@pytest.mark.parametrize("route", ["line_unbanded_g8", "line_multiblock"])
def test_captured_kill_and_resume_at_a_call_boundary_is_step_identical(
        route, tmp_path, monkeypatch):
    _on_stand_in(monkeypatch, RecordingGraph)
    full, kw = build(route, CPU, str(tmp_path))
    full.train(**kw)
    d = full.last_driver
    assert d.replays == d.calls - 1 >= 3

    saves = []
    orig = TrainDriver._save_ckpt

    def killing_save(self, state, gen, done):
        orig(self, state, gen, done)
        saves.append(done)
        if len(saves) == 3:  # after the warm-up and two replays
            raise KeyboardInterrupt

    ck = str(tmp_path / "ck")
    a, kw = build(route, CPU, str(tmp_path))
    a.set_checkpoint(ck)
    monkeypatch.setattr(TrainDriver, "_save_ckpt", killing_save)
    with pytest.raises(KeyboardInterrupt):
        a.train(**kw)
    monkeypatch.setattr(TrainDriver, "_save_ckpt", orig)
    b, kw = build(route, CPU, str(tmp_path))
    b.set_checkpoint(ck)
    b.train(**kw)
    assert b.last_driver.calls == d.calls - 3
    for k in full.state:
        assert torch.equal(b.state[k], full.state[k]), k


def _counting_graph(nodes):
    """A stand-in whose capture runs the call's Python once (as capture
    does, the counters move), whose nodes hold ``nodes`` launches, and
    whose replay runs no Python."""

    class CountingGraph:
        def __init__(self, gen, error_mode="global"):
            self.error_mode = error_mode

        def capture(self, run):
            run()

        def kernel_launches(self):
            return dict(nodes)

        def replay(self):
            pass

    return CountingGraph


def _k1_k4_step(state, ctx, gen, alpha):  # two K1 launches and one K4
    K1.launches += 2
    K4.launches += 1
    return state, torch.zeros(())


def test_each_replay_credits_the_counters_the_graphs_launches(monkeypatch):
    S, calls = 3, 5
    _on_stand_in(monkeypatch, _counting_graph(
        {"sgns_shared_grads": 2 * S, "sgns_banded_multiblock": S}))
    before = launches.read()
    d = TrainDriver(_k1_k4_step, ctx=None, samples_per_step=1, alpha=0.1,
                    total_samples=S * calls, steps_per_call=S, device=CPU)
    d.train({}, torch.Generator(), verbose=False)
    assert (d.calls, d.replays) == (calls, calls - 1)
    moved = launches.moved(before)
    # the warm-up ran its launches; capture's were taken back; each
    # replay was credited the graph's S x (2, 1)
    assert moved == {"sgns_shared_grads": 2 * S * calls,
                     "sgns_banded_multiblock": S * calls}


def test_a_graph_whose_launches_differ_from_the_capture_raises(monkeypatch):
    """A graph that holds fewer K4 launches than the wrappers issued while
    it was captured raises before any replay; the counters keep only the
    warm-up's launches."""
    S = 3
    _on_stand_in(monkeypatch, _counting_graph(
        {"sgns_shared_grads": 2 * S, "sgns_banded_multiblock": S - 1}))
    before = launches.read()
    d = TrainDriver(_k1_k4_step, ctx=None, samples_per_step=1, alpha=0.1,
                    total_samples=S * 4, steps_per_call=S, device=CPU)
    with pytest.raises(RuntimeError, match="captured graph holds"):
        d.train({}, torch.Generator(), verbose=False)
    assert d.replays == 0
    assert launches.moved(before) == {"sgns_shared_grads": 2 * S,
                                      "sgns_banded_multiblock": S}


def test_each_replay_credits_the_collectives_its_capture_tallied(
        monkeypatch):
    """A call of two all_reduces: the eager first call's are timed; the
    capture's are issued with no synchronisation, tallied, taken back and
    credited on every replay, so the calls and bytes are the eager run's
    and the seconds are not timed; the graph is captured in the
    thread-local error mode."""
    monkeypatch.setattr(mesh.dist, "all_reduce", lambda t, group=None: None)
    modes = []

    class TallyingGraph(_counting_graph({})):
        def __init__(self, gen, error_mode="global"):
            modes.append(error_mode)

        def capture(self, run):
            with monkeypatch.context() as m:
                m.setattr(mesh, "_capturing", lambda t: True)
                run()

    monkeypatch.setattr(base, "CallGraph", TallyingGraph)
    monkeypatch.setattr(base, "_warm_up", lambda run, device: run())
    comm = CommStats()
    loop = base.CapturedCalls(None, CPU, True, comm)
    x = torch.ones(3, 2)

    def run():
        comm.all_reduce(x)
        comm.all_reduce(x[0])

    loop(run)
    assert comm.seconds is not None and comm.seconds >= 0  # timed, eager
    for _ in range(4):
        loop(run)
    assert (loop.calls, loop.replays) == (5, 4)
    assert (comm.calls, comm.bytes) == (10, 5 * (24 + 8))
    assert comm.seconds is None and modes == ["thread_local"]


def test_what_is_captured():
    """On the card by default; not on the CPU, not with capture=False."""
    def step(state, ctx, gen, alpha):
        return state, torch.zeros(())

    def driver(**kw):
        return TrainDriver(step, ctx=None, samples_per_step=1, alpha=0.1,
                           total_samples=8, steps_per_call=2, **kw)

    cuda = torch.device("cuda")  # never allocated on: only the decision
    assert driver(device=cuda)._captures()
    assert not driver(device=CPU)._captures()
    assert not driver(device=cuda, capture=False)._captures()


def test_line_trains_eagerly_on_the_cpu_and_keeps_its_tables():
    """The CPU path goes through the same call with no capture, and the
    tables a train() returns are the buffers it was given (updated in
    place, as the JAX call's donated ones)."""
    m = LINE(toy_graph(), seed=0, device=CPU)
    m.init(dim=16, order=2)
    tables = dict(m.state)
    m.train(sample_times=0.02, banded=False, batch=1024, steps_per_call=4,
            verbose=False)
    d = m.last_driver
    assert d.replays == 0 and d.calls >= 2 and d.copy_back_bytes == 0
    for k, v in m.state.items():
        assert v is tables[k]
