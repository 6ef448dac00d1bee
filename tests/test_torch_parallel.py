"""Training on several ranks in the PyTorch port (``parallel/mesh.py`` and
``TrainDriver``'s "dp", "hogwild" and "rows" modes) against smore_tpu's
``TrainDriver`` on the virtual CPU devices of tests/conftest.py and against
the port's own single-device runs.

Each world size W is ONE spawn of W gloo ranks on the CPU
(tests/torch_parallel_worker.py, one intra-op thread each) that runs every
task of that W in order and saves what it got; the tests read those files.
A spawn that does not end within SPAWN_TIMEOUT seconds fails its tests.

- ``mesh.py``: the mesh's dim name and size, ``shard_state``'s placements,
  row ownership equal to DTensor's local shapes (23 rows on 3 ranks: 8 / 8
  / 7; fewer rows than ranks), ``RowShard``'s gather and add equal to the
  whole table's, bit for bit, and its refusal of any other op.
- The merge law: a key-free step with a term per rank through smore_tpu's
  driver on a mesh of W devices and the port's on W ranks, "dp" and
  "hogwild", W = 2 and 4: the tables within rtol 1e-6, atol 1e-7 (two
  compilers' float32), the executed samples equal; the argument errors
  carry JAX's messages.
- "rows" equals one device BIT FOR BIT on the CPU (every gathered entry adds
  only zeros, every owned row takes its adds in index order): LINE o2
  unbanded (group 8, auto hoist 32, K1's twin, collision "mean") and
  DeepWalk at W = 2 and 3; the saved weights file is byte-equal.
- Ports of tests/test_parallel.py (its graphs, arguments and thresholds)
  and of the hogwild kill and resume of tests/test_checkpoint_resume.py:282
  (step-identical at W = 2); a checkpoint of 2 ranks resumed by 3 raises.
- The mesh modes' call (what an NCCL rank captures as one CUDA graph), at
  W = 2 on LINE "dp", "rows" and "hogwild", DeepWalk "rows" and BPR "dp"
  (tests/torch_graph_call_cases.py ``MESH_CASES``): no host sync and no
  data-dependent shape inside it (``CaptureGuard``), "rows" adding
  unowned ids through ``RowShard``'s masked add; its tables bit-equal to
  the eager loop it replaced, with the same collectives' calls and bytes;
  eager on gloo; on a stand-in graph the captured control flow (one eager
  call, then replays) with the same tables and collectives. ``RowShard``'s
  masked add bit for bit the owned adds alone, signed zeros included.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from smore_tpu.models.base import TrainDriver as JTrainDriver
from smore_tpu.parallel.mesh import make_mesh as j_make_mesh
from smore_tpu_torch.graph.graph import Graph
from smore_tpu_torch.parallel.mesh import CommStats, RowShard
from torch_graph_call_cases import MESH_CASES, CaptureGuard

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
SPAWN_TIMEOUT = 120
MERGE_RTOL, MERGE_ATOL = 1e-6, 1e-7
TASKS = {
    2: ["mesh_checks", "merge_law", "rows_line", "rows_deepwalk", "dp_line",
        "dp_deepwalk", "row_sharded_tables", "rec_dp", "hogwild_banded",
        "kill_resume", "mesh_calls"],
    3: ["mesh_checks", "rows_line", "rows_deepwalk", "resume_other_world"],
    4: ["mesh_checks", "merge_law"],
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(world: int, out_dir: str) -> None:
    """Run TASKS[world] on ``world`` gloo ranks; every rank must exit 0."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), str(port), out_dir]
        + TASKS[world], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=ROOT) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {world}:\n{out[-4000:]}"


class _Runs:
    """The saved results of one spawn: ``runs(task, rank)``."""

    def __init__(self, out_dir: str, world: int):
        self.out_dir, self.world = out_dir, world

    def __call__(self, task: str, rank: int = 0) -> dict:
        return torch.load(
            os.path.join(self.out_dir, f"{task}.w{self.world}.r{rank}.pt"),
            weights_only=True)


@pytest.fixture(scope="module")
def out_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ranks"))


@pytest.fixture(scope="module")
def w2(out_dir):
    _spawn(2, out_dir)
    return _Runs(out_dir, 2)


@pytest.fixture(scope="module")
def w3(out_dir, w2):  # resumes w2's checkpoint
    _spawn(3, out_dir)
    return _Runs(out_dir, 3)


@pytest.fixture(scope="module")
def w4(out_dir):
    _spawn(4, out_dir)
    return _Runs(out_dir, 4)


def _world(request, world: int) -> _Runs:
    return request.getfixturevalue(f"w{world}")


@pytest.fixture(scope="module")
def comm_graph():
    return Graph.from_edges(W.comm_edges(), undirected=True)


def _sep(wv: np.ndarray, g) -> float:
    """tests/test_parallel.py's intra- minus cross-community cosine."""
    wv = wv / (np.linalg.norm(wv, axis=1, keepdims=True) + 1e-9)
    intra, cross = [], []
    for a in range(0, 24, 3):
        for b in range(1, 24, 3):
            s = wv[g.name2id[f"v{a}"]] @ wv[g.name2id[f"v{b}"]]
            (intra if (a < 12) == (b < 12) else cross).append(s)
    return float(np.mean(intra) - np.mean(cross))


# ------------------------------------------------------------- mesh.py
@pytest.mark.parametrize("world", [2, 3, 4])
def test_make_mesh_and_shard_state(request, world):
    for rank in range(world):
        got = _world(request, world)("mesh_checks", rank)
        assert got["dim_names"] == ["d"] and got["size"] == world
        assert got["placements"] == ["S(0)"] and got["row_sharded"]
        assert got["untouched"]  # a 1-D tensor and a number stay as given


@pytest.mark.parametrize("world", [2, 3, 4])
def test_row_ownership_matches_dtensor(request, world):
    runs = _world(request, world)
    for n in (23, world - 1, 1):
        spans = [runs("mesh_checks", r)[f"range_{n}"] for r in range(world)]
        sizes = [runs("mesh_checks", r)[f"local_{n}"] for r in range(world)]
        assert [hi - lo for lo, hi in spans] == sizes
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    if world == 3:
        assert [runs("mesh_checks", r)["local_23"] for r in range(3)] == [
            8, 8, 7]


@pytest.mark.parametrize("world", [2, 3, 4])
def test_row_shard_gather_and_add(request, world):
    for rank in range(world):
        got = _world(request, world)("mesh_checks", rank)
        assert torch.equal(got["gather"], got["gather_want"])
        assert torch.equal(got["added"], got["added_want"])
        assert got["shape"] == ((23, 4), "torch.float32", "cpu")
        assert got["refused"].startswith("sigmoid: a row-sharded table")


# ------------------------------------------------------------ the merge
def _jax_merge(world: int, mode: str):
    def step(state, c, key, alpha):
        r = jax.lax.axis_index("d")
        w = state["w"]
        return {"w": w + alpha * ((r + 1) * c - 0.5 * w)}, jnp.mean(w)

    w0, c = W.merge_inputs()
    d = JTrainDriver(step, jnp.asarray(c), mesh=j_make_mesh(world),
                     sharding=mode, monitor=False, **W.MERGE_KW)
    out = d.train({"w": jnp.asarray(w0)}, jax.random.PRNGKey(0),
                  verbose=False)
    return np.asarray(out["w"]), d.executed_samples, d.n_shards


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("mode", ["dp", "hogwild"])
def test_merge_law_matches_jax(request, world, mode):
    if len(jax.devices()) < world:
        pytest.fail(f"tests/conftest.py provides {len(jax.devices())} "
                    f"virtual devices, {world} needed")
    want, executed, n_shards = _jax_merge(world, mode)
    runs = _world(request, world)
    for rank in range(world):
        got = runs("merge_law", rank)
        np.testing.assert_allclose(got[mode].numpy(), want, rtol=MERGE_RTOL,
                                   atol=MERGE_ATOL)
        assert got[f"{mode}_executed"] == executed
        assert got[f"{mode}_n_shards"] == n_shards == world


def test_driver_argument_errors_match_jax(w2):
    mesh = j_make_mesh(2)
    want = []
    for kw in (dict(sharding="bogus"), dict(micro_steps=2)):
        with pytest.raises(ValueError) as e:
            JTrainDriver(None, None, mesh=mesh, **dict(W.MERGE_KW, **kw))
        want.append(str(e.value))
    assert w2("merge_law")["errors"] == want


# ------------------------------------------------- rows against one rank
@pytest.fixture(scope="module")
def one_device():
    line = W._line(W.comm_edges())
    line.train(**W.ROWS_LINE_KW)
    dw = W._deepwalk(W.comm_edges())
    dw.train(**W.ROWS_DW_KW)
    return {"rows_line": line, "rows_deepwalk": dw}


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("task", ["rows_line", "rows_deepwalk"])
def test_rows_equals_one_device(request, one_device, world, task):
    ref = one_device[task]
    runs = _world(request, world)
    for rank in range(world):
        got = runs(task, rank)
        assert set(got["state"]) == set(ref.state)
        for k, v in ref.state.items():
            torch.testing.assert_close(got["state"][k], v, rtol=0, atol=0)
    if task == "rows_line":
        got = runs(task, 0)
        assert got["placements"] == ["S(0)"]
        assert got["hoist"] == ref.last_driver.micro_steps == 32
        assert got["comm_calls"] > 0
        assert got["local_rows"] == -(-24 // world)


@pytest.mark.parametrize("world", [2, 3])
def test_rows_save_weights_byte_equal(request, one_device, world, tmp_path):
    path = str(tmp_path / "one.txt")
    one_device["rows_line"].save_weights(path)
    got = _world(request, world)("rows_line")["weights"]
    with open(path, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()


# -------------------------------------------- tests/test_parallel.py's
def test_line_dp_trains(w2):
    a, b = w2("dp_line", 0), w2("dp_line", 1)
    assert torch.isfinite(a["vertex"]).all()
    assert tuple(a["vertex"].shape) == (24, 16)
    # the replicated tables agree across ranks
    assert torch.equal(a["vertex"], b["vertex"])
    assert a["n_shards"] == 2 and a["hoist"] == 1  # dp: one batch a step


def test_deepwalk_dp_learns_communities(w2, comm_graph):
    got = w2("dp_deepwalk")
    assert got["dp_hoist"] == 1
    assert _sep(got["dp"]["vertex"].numpy(), comm_graph) > 0.2


def test_dp_streams_are_independent(w2):
    """Each rank draws its own stream, so the dp run differs from the
    single-device run at equal steps."""
    one = W._line(W.comm_edges())
    one.train(**W.STREAMS_KW)
    assert not np.allclose(one.state["vertex"].numpy(),
                           w2("dp_line")["streams"].numpy())


def test_line_row_sharded_tables(w2):
    got = w2("row_sharded_tables")
    assert got["placed"] and got["still_sharded"]
    assert got["sharding"] == "rows"
    wv = got["state"]["vertex"]
    assert torch.isfinite(wv).all() and tuple(wv.shape) == (24, 16)


def test_rows_and_dp_reach_same_quality(w2, comm_graph):
    got = w2("dp_deepwalk")
    seps = {m: _sep(got[m]["vertex"].numpy(), comm_graph)
            for m in ("dp", "rows")}
    assert seps["dp"] > 0.2 and seps["rows"] > 0.2, seps


def test_banded_multiblock_hogwild_on_mesh(w2):
    """On the K4 twin: per-rank streams on replicated tables, merged once a
    call; learns the structure and differs from one device at the same
    budget, at matched quality."""
    edges, comm = W.banded_edges()
    got = w2("hogwild_banded")
    assert got["n_shards"] == 2 and got["sharding"] == "hogwild"
    assert got["route"].startswith("LINE._make_banded_multiblock_step")
    g = Graph.from_edges(edges, undirected=True)
    assert got["names"] == g.names
    wv = got["state"]["vertex"].numpy()
    assert np.isfinite(wv).all()

    def sep(w):
        x = w / (np.linalg.norm(w, axis=1, keepdims=True) + 1e-9)
        vid = np.array([g.name2id[f"v{i}"] for i in range(512)])
        r2 = np.random.default_rng(9)
        a = r2.integers(0, 512, 4000)
        b = r2.integers(0, 512, 4000)
        s = (x[vid[a]] * x[vid[b]]).sum(1)
        same = comm[a] == comm[b]
        return s[same].mean() - s[~same].mean()

    assert sep(wv) > 0.3
    one = W._line(edges, dim=64)
    one.train(**W.HOG_KW)
    w1 = one.state["vertex"].numpy()
    assert not np.allclose(w1, wv)
    assert abs(sep(w1) - sep(wv)) < 0.15


def test_rec_family_trains_dp_on_a_mesh(w2):
    got = w2("rec_dp")
    assert got["sharding"] == "dp" and got["hoist"] == 1
    assert got["n_shards"] == 2 and torch.isfinite(got["vertex"]).all()


# ------------------------------------------------------ kill and resume
def test_hogwild_kill_resume_is_step_identical(w2):
    for rank in range(2):
        got = w2("kill_resume", rank)
        assert got["killed"] and got["calls"] > 2
        torch.testing.assert_close(got["resumed"], got["ref"], rtol=0,
                                   atol=0)
        # the resumed run ran the calls after the second checkpoint
        assert got["resumed_executed"] == (
            got["ref_executed"] * (got["calls"] - 2) // got["calls"])


def test_resume_at_another_world_size_raises(w3):
    for rank in range(3):
        err = w3("resume_other_world", rank)["error"]
        assert "saved by 2 ranks" in err and "has 3" in err


# --------------------------------------------------- the mesh modes' call
@pytest.mark.parametrize("name", sorted(MESH_CASES))
def test_a_mesh_call_has_no_sync_and_no_data_dependent_shape(w2, name):
    for rank in range(2):
        got = w2("mesh_calls", rank)[name]
        assert got["error"] == ""
        assert got["sharding"] == MESH_CASES[name][1]
        # gloo's collectives cannot be captured: every call eager
        assert got["calls"] >= 1 and got["replays"] == 0
        assert not got["captured"]
        if got["sharding"] == "rows":  # the masked add took unowned ids
            assert 0 < got["unowned"] < got["adds"]


@pytest.mark.parametrize("name", sorted(MESH_CASES))
def test_the_mesh_call_is_bit_equal_to_the_eager_loop(w2, name):
    for rank in range(2):
        got = w2("mesh_calls", rank)[name]
        assert got["calls"] == got["old_calls"]
        assert got["comm"] == got["old_comm"] and got["comm"][0] > 0
        assert set(got["state"]) == set(got["old_state"])
        for k, v in got["old_state"].items():
            assert torch.equal(got["state"][k], v), k


@pytest.mark.parametrize("name", [n for n in sorted(MESH_CASES)
                                  if n.startswith("line")])
def test_a_mesh_call_captured_on_a_stand_in_graph(w2, name):
    """As on an NCCL group: the first call eager, the rest replays of one
    graph captured with the thread-local error mode; the tables and the
    collectives are the eager run's."""
    for rank in range(2):
        got = w2("mesh_calls", rank)[name]
        assert got["stand_in_calls"] == got["calls"] >= 3
        assert got["stand_in_replays"] == got["calls"] - 1
        assert got["stand_in_modes"] == ["thread_local"]
        assert got["stand_in_comm"] == got["comm"]
        for k, v in got["state"].items():
            assert torch.equal(got["stand_in_state"][k], v), k


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


@pytest.mark.parametrize("alpha", [1, -0.5])
def test_row_shard_masked_add_is_the_owned_adds_bit_for_bit(alpha):
    """Rows 8:16 of 23, most ids unowned, duplicates; the owned ids hit
    rows 8:12 only and rows 12:16 hold -0.0 entries, which only unowned
    ids' zeros reach: every bit as the boolean-index form leaves them,
    with no op a capture cannot take."""
    rng = np.random.default_rng(4)
    lo, hi = 8, 16
    local = torch.from_numpy(rng.standard_normal((hi - lo, 4)).astype(
        np.float32))
    local[4:, 0], local[::2, 1] = -0.0, 0.0
    idx = torch.from_numpy(rng.permutation(np.r_[
        rng.integers(lo, lo + 4, 12), rng.choice(np.r_[0:lo, hi:23], 48)]))
    delta = torch.from_numpy(rng.standard_normal((60, 4)).astype(np.float32))
    delta[::3, 2] = -0.0
    owned = (idx >= lo) & (idx < hi)
    want = local.clone().index_add_(0, idx[owned] - lo, delta[owned],
                                    alpha=alpha)
    shard = RowShard(local.clone(), 23, lo, CommStats())
    with CaptureGuard():
        shard.index_add_(0, idx, delta, alpha=alpha)
    assert torch.signbit(want[4:, 0]).all()  # the -0.0 entries stay
    assert torch.equal(_bits(shard.local), _bits(want))


def test_row_shard_empty_shard_adds_nothing():
    shard = RowShard(torch.zeros(0, 4), 3, 3, CommStats())
    shard.index_add_(0, torch.tensor([0, 2, 1]), torch.ones(3, 4))
    assert tuple(shard.local.shape) == (0, 4)
