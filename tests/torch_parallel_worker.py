"""One rank of the PyTorch port's multi-rank tests
(tests/test_torch_parallel.py).

    python tests/torch_parallel_worker.py RANK WORLD PORT OUT TASK [TASK ...]

joins a gloo group of WORLD CPU ranks at 127.0.0.1:PORT
(``parallel.mesh.init_distributed``), runs each TASK in order on a 1-D CPU
mesh and writes what the tests compare to ``OUT/TASK.wWORLD.rRANK.pt``. It
imports torch and the port only; the tests hold the results to smore_tpu's
and to the port's single-device runs. The graphs and training arguments
are those of tests/test_parallel.py and tests/test_checkpoint_resume.py,
and live here so that the tests train the single-device runs with the same
ones; the mesh modes' calls are those of tests/torch_graph_call_cases.py.
"""

from __future__ import annotations

import os
import sys
from types import SimpleNamespace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch.distributed as dist  # noqa: E402

from smore_tpu_torch.graph.graph import Graph  # noqa: E402
from smore_tpu_torch.models import BPR, DeepWalk, LINE, base  # noqa: E402
from smore_tpu_torch.models.base import (  # noqa: E402
    TrainDriver,
    _snapshot,
    alpha_schedule,
)
from smore_tpu_torch.parallel.mesh import (  # noqa: E402
    CommStats,
    RowShard,
    init_distributed,
    make_mesh,
    row_range,
    row_sharded,
    shard_state,
)
from torch_graph_call_cases import (  # noqa: E402
    MESH_CASES,
    CaptureGuard,
    build_mesh,
)

CPU = torch.device("cpu")

# tests/test_parallel.py's settings
LINE_DP_KW = dict(sample_times=0.05, negative_samples=5, alpha=0.02,
                  batch=64, steps_per_call=8, collision="mean",
                  verbose=False)
STREAMS_KW = dict(sample_times=0.02, negative_samples=3, alpha=0.02,
                  batch=64, steps_per_call=4, collision="mean",
                  verbose=False)
ROWS_SHARDED_KW = dict(sample_times=0.01, negative_samples=3, alpha=0.02,
                       batch=64, steps_per_call=4, collision="mean",
                       verbose=False)
DW_KW = dict(walk_times=100, walk_steps=10, window_size=3,
             negative_samples=5, alpha=0.01, batch_walks=8,
             steps_per_call=8, collision="sum", verbose=False)
HOG_KW = dict(sample_times=1.0, negative_samples=5, alpha=0.0125,
              batch=128, steps_per_call=8, shared_negatives=16,
              banded=True, multiband=True, band_size=128,
              edge_stream=True, hoist=2, verbose=False)
# rows against one device: LINE o2 unbanded on K1's twin (group 8, auto
# hoist 32, collision "mean" as in test_parallel.py:98) and DeepWalk
ROWS_LINE_KW = dict(sample_times=0.02, negative_samples=3, alpha=0.02,
                    batch=64, steps_per_call=64, collision="mean",
                    use_pallas=True, verbose=False)
ROWS_DW_KW = dict(walk_times=20, walk_steps=10, window_size=3,
                  negative_samples=5, alpha=0.01, batch_walks=8,
                  steps_per_call=8, collision="sum", verbose=False)
# tests/test_checkpoint_resume.py:282's hogwild kill and resume
KILL_KW = dict(sample_times=0.02, negative_samples=2, alpha=0.02,
               batch=128, steps_per_call=8, shared_negatives=16,
               banded=True, multiband=True, band_size=64,
               edge_stream=True, hoist=2, verbose=False)
# the merge law: a key-free step on one table, every rank's own term
MERGE_ROWS, MERGE_DIM = 12, 5
MERGE_KW = dict(samples_per_step=10, alpha=0.1, total_samples=1000,
                steps_per_call=4)


def comm_edges():
    """tests/test_parallel.py's graph: two dense 12-vertex communities and
    one bridge edge."""
    rng = np.random.default_rng(7)
    edges = []
    for base in (0, 12):
        for i in range(12):
            for j in range(i + 1, 12):
                if rng.random() < 0.6:
                    edges.append((f"v{base + i}", f"v{base + j}", 1.0))
    edges.append(("v0", "v12", 1.0))
    return edges


def banded_edges():
    """test_banded_multiblock_hogwild_on_mesh's 512-vertex, 4-community
    graph; returns (edges, community of each vertex)."""
    rng = np.random.default_rng(5)
    nv, n_comm = 512, 4
    comm = rng.integers(0, n_comm, nv)
    edges = []
    for _ in range(6000):
        if rng.random() < 0.9:
            c = rng.integers(0, n_comm)
            members = np.flatnonzero(comm == c)
            a, b = members[rng.integers(0, len(members), 2)]
        else:
            a, b = rng.integers(0, nv, 2)
        if a != b:
            edges.append((f"v{a}", f"v{b}", 1.0))
    return edges, comm


def toy_edges(n: int = 256, seed: int = 3):
    """tests/test_checkpoint_resume.py's ``_toy_graph(n=256, seed=3)``."""
    rng = np.random.default_rng(seed)
    edges = []
    for _ in range(400):
        a, b = rng.integers(0, n, 2)
        if a != b:
            edges.append((f"n{a}", f"n{b}",
                          float(f"{rng.uniform(0.5, 2.0):.3f}")))
    return edges


def merge_inputs():
    """(table, per-rank term) of the merge-law step."""
    rng = np.random.default_rng(11)
    w = rng.standard_normal((MERGE_ROWS, MERGE_DIM)).astype(np.float32)
    c = rng.standard_normal((MERGE_ROWS, MERGE_DIM)).astype(np.float32)
    return w, c


def merge_step(state, c, gen, alpha):
    """w += alpha * ((rank + 1) * c - w / 2): no draw, a term per rank."""
    w = state["w"]
    r = dist.get_rank() if dist.is_initialized() else 0
    w.add_(alpha * ((r + 1) * c - 0.5 * w))
    return state, w.mean()


def _line(edges, order=2, dim=16):
    m = LINE(Graph.from_edges(edges, undirected=True), seed=0, device=CPU)
    m.init(dim=dim, order=order)
    return m


def _deepwalk(edges):
    m = DeepWalk(Graph.from_edges(edges, undirected=True), seed=0,
                 device=CPU)
    m.init(dim=16)
    return m


def _tables(m):
    """The model's whole tables (gathered when row-sharded) as tensors."""
    return {k: torch.from_numpy(v) for k, v in m.state_numpy().items()}


def _dw_train(m, **kw):
    """DeepWalk.train with DW_KW updated by ``kw``."""
    m.train(**dict(DW_KW, **kw))
    return m


# --------------------------------------------------------------- tasks
def mesh_checks(run, out):
    mesh, rank, world = run.mesh, run.rank, run.world
    out["dim_names"] = list(mesh.mesh_dim_names)
    out["size"] = mesh.size()
    t = torch.arange(23 * 4, dtype=torch.float32).reshape(23, 4)
    placed = shard_state({"t": t, "v": torch.arange(5.0), "s": 3}, mesh)
    out["placements"] = [str(p) for p in placed["t"].placements]
    out["row_sharded"] = placed["t"].placements == row_sharded(mesh)
    out["untouched"] = (type(placed["v"]) is torch.Tensor
                        and placed["s"] == 3)
    for n in (23, world - 1, 1):
        local = shard_state({"t": torch.zeros(n, 2)}, mesh)["t"].to_local()
        out[f"local_{n}"] = int(local.shape[0])
        out[f"range_{n}"] = row_range(n, world, rank)
    # RowShard against the whole table: a gather and an add, with
    # duplicate and unowned rows, and an op it must refuse
    rng = np.random.default_rng(3)
    full = torch.from_numpy(rng.standard_normal((23, 4)).astype(np.float32))
    lo, hi = row_range(23, world, rank)
    table = RowShard(full[lo:hi].clone(), 23, lo, CommStats())
    idx = torch.from_numpy(rng.integers(0, 23, (6, 3))).int()
    out["gather"] = table[idx]
    out["gather_want"] = full[idx]
    add_idx = torch.from_numpy(np.r_[rng.integers(0, 23, 40), [0, 0, 22]])
    delta = torch.from_numpy(rng.standard_normal((43, 4)).astype(np.float32))
    table.index_add_(0, add_idx, delta)
    out["added"] = table.local
    out["added_want"] = full.clone().index_add_(0, add_idx, delta)[lo:hi]
    out["shape"] = (tuple(table.shape), str(table.dtype), str(table.device))
    try:
        torch.sigmoid(table)
        out["refused"] = ""
    except TypeError as e:
        out["refused"] = str(e)


def merge_law(run, out):
    mesh = run.mesh
    w0, c = merge_inputs()
    for mode in ("dp", "hogwild"):
        d = TrainDriver(merge_step, torch.from_numpy(c), mesh=mesh,
                        sharding=mode, device=CPU, **MERGE_KW)
        st = d.train({"w": torch.from_numpy(w0.copy())},
                     torch.Generator(), verbose=False)
        out[mode] = st["w"]
        out[f"{mode}_executed"] = d.executed_samples
        out[f"{mode}_n_shards"] = d.n_shards
    errors = []
    for kw in (dict(sharding="bogus"), dict(micro_steps=2)):
        try:
            TrainDriver(merge_step, None, mesh=mesh, device=CPU,
                        **dict(MERGE_KW, **kw))
            errors.append("")
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors


def rows_line(run, out):
    mesh, world = run.mesh, run.world
    m = _line(comm_edges())
    m.train(mesh=mesh, sharding="rows", **ROWS_LINE_KW)
    out["placements"] = [str(p) for p in m.state["vertex"].placements]
    out["hoist"] = m.last_driver.micro_steps
    out["comm_calls"] = m.last_driver.comm.calls
    out["local_rows"] = int(m.state["vertex"].to_local().shape[0])
    out["state"] = _tables(m)
    path = os.path.join(run.dir, f"rows_line_w{world}.txt")
    m.save_weights(path)
    out["weights"] = path


def rows_deepwalk(run, out):
    mesh = run.mesh
    m = _deepwalk(comm_edges())
    m.train(mesh=mesh, sharding="rows", **ROWS_DW_KW)
    out["state"] = _tables(m)


def dp_line(run, out):
    """test_line_dp_trains; and test_dp_streams_are_independent's mesh
    run."""
    mesh = run.mesh
    m = _line(comm_edges())
    m.train(mesh=mesh, **LINE_DP_KW)
    out["vertex"] = m.state["vertex"]
    out["n_shards"] = m.last_driver.n_shards
    out["hoist"] = m.last_driver.micro_steps
    m = _line(comm_edges())
    m.train(mesh=mesh, **STREAMS_KW)
    out["streams"] = m.state["vertex"]


def dp_deepwalk(run, out):
    """test_deepwalk_dp_learns_communities; test_rows_and_dp_reach_same_
    quality's rows run (its dp run is this one)."""
    mesh = run.mesh
    m = _dw_train(_deepwalk(comm_edges()), mesh=mesh)
    out["dp"] = _tables(m)
    out["dp_hoist"] = m.last_driver.micro_steps
    m = _dw_train(_deepwalk(comm_edges()), mesh=mesh, sharding="rows")
    out["rows"] = _tables(m)


def row_sharded_tables(run, out):
    """test_line_row_sharded_tables: tables placed by shard_state train
    without mesh=."""
    mesh = run.mesh
    m = _line(comm_edges())
    m.state = shard_state(m.state, mesh)
    out["placed"] = m.state["vertex"].placements == row_sharded(mesh)
    m.train(**ROWS_SHARDED_KW)
    out["sharding"] = m.last_driver.sharding
    out["still_sharded"] = m.state["vertex"].placements == row_sharded(mesh)
    out["state"] = _tables(m)


def rec_dp(run, out):
    """The rec family on a mesh: dp, one batch a step."""
    mesh = run.mesh
    edges = [(f"u{i}", f"i{(i * 7 + j) % 40}", 1.0)
             for i in range(30) for j in range(3)]
    m = BPR(Graph.from_edges(edges, undirected=False), seed=0, device=CPU)
    m.init(dim=8)
    m.train(sample_times=0.01, batch=32, mesh=mesh, verbose=False)
    d = m.last_driver
    out["hoist"], out["sharding"] = d.micro_steps, d.sharding
    out["n_shards"] = d.n_shards
    out["vertex"] = m.state["vertex"]


def hogwild_banded(run, out):
    """test_banded_multiblock_hogwild_on_mesh on the K4 twin."""
    mesh = run.mesh
    edges, _ = banded_edges()
    m = _line(edges, dim=64)
    m.train(mesh=mesh, **HOG_KW)
    d = m.last_driver
    out["n_shards"], out["sharding"] = d.n_shards, d.sharding
    out["route"] = d.step_fn.__qualname__
    out["state"] = _tables(m)
    out["names"] = m.graph.names


class _Killed(Exception):
    pass


def kill_resume(run, out):
    """tests/test_checkpoint_resume.py:282 at this world size: the
    uninterrupted hogwild run, then one killed after its second checkpoint
    and resumed."""
    mesh, world = run.mesh, run.world
    ckpt = os.path.join(run.dir, f"hog_ckpt_w{world}")
    edges = toy_edges()
    kw = dict(KILL_KW, mesh=mesh)
    ref = _line(edges, dim=64)
    ref.train(**kw)
    out["ref"] = ref.state["vertex"]
    out["calls"] = -(-ref.last_driver.total_samples
                     // ref.last_driver.samples_per_step
                     // ref.last_driver.steps_per_call)
    a = _line(edges, dim=64)
    a.set_checkpoint(ckpt, every=1)
    orig, saves = TrainDriver._save_ckpt, []

    def killing_save(self, state, gen, done):
        orig(self, state, gen, done)
        saves.append(done)
        if len(saves) == 2:
            raise _Killed

    TrainDriver._save_ckpt = killing_save
    try:
        a.train(**kw)
        out["killed"] = False
    except _Killed:
        out["killed"] = True
    finally:
        TrainDriver._save_ckpt = orig
    b = _line(edges, dim=64)
    b.set_checkpoint(ckpt, every=1)
    b.train(**kw)
    out["resumed"] = b.state["vertex"]
    out["resumed_executed"] = b.last_driver.executed_samples
    out["ref_executed"] = ref.last_driver.executed_samples
    out["ckpt"] = ckpt


def resume_other_world(run, out):
    """A checkpoint that 2 ranks saved, resumed by this world size."""
    mesh = run.mesh
    m = _line(toy_edges(), dim=64)
    m.set_checkpoint(os.path.join(run.dir, "hog_ckpt_w2"), every=1)
    try:
        m.train(**dict(KILL_KW, mesh=mesh))
        out["error"] = ""
    except ValueError as e:
        out["error"] = str(e)


def old_mesh_loop(self, state, gen, done, steps_total, inv_total, verbose,
                  t0):
    """The eager loop that the mesh modes' call of static buffers replaced:
    a fresh alpha tensor a call, the merges threaded through the steps, the
    tables as the last step left them."""
    S, M, mode = self.steps_per_call, self.micro_steps, self._mode
    cur, old = dict(state), None
    while done < steps_total:
        alphas = torch.from_numpy(alpha_schedule(
            done, S, M, self.alpha, inv_total)).to(self.device)
        if mode == "hogwild":
            old = _snapshot(cur, old)
        for i in range(S):
            if mode == "dp":
                old = _snapshot(cur, old)
            cur, _ = self.step_fn(cur, self.ctx, gen, alphas[i])
            if mode == "dp":
                cur = self._merge(old, cur)
        if mode == "hogwild":
            cur = self._merge(old, cur)
        done += S
        self.calls += 1
    state.update(cur)
    return done


def _mesh_run(run, name, patches=()):
    """Train ``name`` of MESH_CASES with ``patches`` ((owner, attribute,
    value), undone after); returns (model, driver)."""
    saved = [(o, a, getattr(o, a)) for o, a, _ in patches]
    for o, a, v in patches:
        setattr(o, a, v)
    try:
        m, kw = build_mesh(name, CPU, run.dir, run.mesh)
        m.train(**kw)
    finally:
        for o, a, v in saved:
            setattr(o, a, v)
    return m, m.last_driver


def mesh_calls(run, out):
    """Each MESH_CASES case trained three ways: its calls under
    CaptureGuard (no host sync, no boolean index, no data-dependent shape:
    what a capture cannot take), with the ids that "rows" adds to each
    shard recorded; the eager loop those calls replaced; and, for LINE,
    the captured path's control flow as on an NCCL group, with a stand-in
    graph. The tables and the collectives of each."""
    guarded, add = TrainDriver._call, RowShard._index_add
    adds, modes = [], []

    def call(self, *a):
        with CaptureGuard():
            guarded(self, *a)

    def recording_add(self, dim, idx, src, alpha=1):
        adds.append((idx.clone(), self.lo, self.local.shape[0]))
        return add(self, dim, idx, src, alpha)

    class StandInGraph:
        """Capture keeps the call and runs nothing; a replay runs it, as
        the card would run what capture recorded."""

        def __init__(self, gen, error_mode="global"):
            modes.append(error_mode)
            self.run = None

        def capture(self, run):
            self.run = run
            return 0

        def kernel_launches(self):
            return {}

        def replay(self):
            self.run()

    for name in MESH_CASES:
        adds[:], modes[:] = [], []
        try:
            m, d = _mesh_run(run, name, [(TrainDriver, "_call", call),
                                         (RowShard, "_index_add",
                                          recording_add)])
        except AssertionError as e:
            out[name] = dict(error=str(e))
            continue
        got = dict(error="", state=_tables(m), sharding=d.sharding,
                   calls=d.calls, replays=d.replays,
                   captured=d.loop.captured,
                   comm=(d.comm.calls, d.comm.bytes),
                   adds=sum(len(i) for i, _, _ in adds),
                   unowned=sum(int(((i < lo) | (i >= lo + n)).sum())
                               for i, lo, n in adds))
        m, d = _mesh_run(run, name, [(TrainDriver, "_train_calls",
                                      old_mesh_loop)])
        got.update(old_state=_tables(m), old_calls=d.calls,
                   old_comm=(d.comm.calls, d.comm.bytes))
        if name.startswith("line"):
            m, d = _mesh_run(run, name, [
                (base, "CallGraph", StandInGraph),
                (base, "_warm_up", lambda run, device: run()),
                (base, "backend_of", lambda mesh: "nccl"),
                (TrainDriver, "_captures", lambda self: True)])
            got.update(stand_in_state=_tables(m), stand_in_calls=d.calls,
                       stand_in_replays=d.replays,
                       stand_in_comm=(d.comm.calls, d.comm.bytes),
                       stand_in_modes=list(modes))
        out[name] = got


TASKS = {f.__name__: f for f in (
    mesh_checks, merge_law, rows_line, rows_deepwalk, dp_line, dp_deepwalk,
    row_sharded_tables, rec_dp, hogwild_banded, kill_resume,
    resume_other_world, mesh_calls)}


def main(argv) -> None:
    rank, world, port = int(argv[0]), int(argv[1]), int(argv[2])
    out_dir = argv[3]
    # the ranks yield the cores to the test workers running beside them
    os.nice(10)
    torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo")
    run = SimpleNamespace(mesh=make_mesh(world, device_type="cpu"),
                          rank=rank, world=world, dir=out_dir)
    for name in argv[4:]:
        out = {}
        TASKS[name](run, out)
        torch.save(out, os.path.join(out_dir, f"{name}.w{world}.r{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
