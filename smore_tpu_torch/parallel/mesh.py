"""Process groups, device meshes and row-sharded tables for training on
several devices.

Port of ``smore_tpu/parallel/mesh.py``. The JAX package drives every device
of a ``Mesh`` from one process; PyTorch's idiom is one process per device
(SPMD), the shape of the JAX package's multi-host mode, so here every rank
runs the same program and ``TrainDriver`` (``models/base.py``) merges their
work with ``torch.distributed`` collectives:

  - ``"dp"`` / ``"hogwild"``: replicated tables, an independent sample
    stream per rank, the ranks' table deltas summed by ``all_reduce`` every
    step or every call;
  - ``"rows"``: one logical sample stream, each rank storing only its rows
    of every table (``Shard(0)``, DTensor's chunking); the step reads and
    writes the tables through ``RowShard``, which gathers rows with one
    ``all_reduce`` of the gathered block and applies row updates locally.

The backend is chosen once, in ``init_distributed``: NCCL when every rank
has a card of its own, gloo when ranks share a card or run on the CPU
(NCCL refuses two ranks on one device). Gloo reduces CUDA tensors but does
not gather them (``all_gather`` of CUDA tensors over gloo crashed on the
H100 machine), so whole-table gathers go through the CPU under gloo. NCCL's
collectives can be captured into a CUDA graph, gloo's cannot: on an NCCL
group ``TrainDriver`` captures each call with its collectives
(``CommStats`` counts them), on a gloo group it runs them eagerly.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

# torch.distributed.tensor (DTensor) is imported where a function needs it:
# loading it costs ~1 s a process, which every command-line run would pay.
_DTENSOR_MODULE = "torch.distributed.tensor"


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> str:
    """Join the process group: ``coordinator`` is ``host:port`` of rank 0
    (``tcp://`` rendezvous with ``num_processes`` ranks, this one
    ``process_id``); without it the ``env://`` variables that ``torchrun``
    sets are read. ``backend`` None picks "nccl" when every rank has a CUDA
    card of its own on this host and "gloo" otherwise; nothing switches
    backend after a failure. Each rank's current CUDA device is its local
    rank modulo the cards present. Returns the backend, which rank 0 also
    prints."""
    world = num_processes or int(os.environ.get("WORLD_SIZE", "1"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    if backend is None:
        own_card = (torch.cuda.is_available()
                    and torch.cuda.device_count() >= local_world)
        backend = "nccl" if own_card else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    kw = {}
    if coordinator is not None:
        kw = dict(init_method=f"tcp://{coordinator}", world_size=world,
                  rank=process_id)
    dist.init_process_group(backend, **kw)
    rank = dist.get_rank()
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", str(rank)))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if rank == 0:
        print(f"init_distributed: {dist.get_world_size()} ranks, backend "
              f"{backend}", flush=True)
    return backend


def make_mesh(n_devices: Optional[int] = None, axis: str = "d",
              device_type: str = "cuda") -> DeviceMesh:
    """A 1-D mesh named ``axis`` over every rank of the process group (one
    device per rank); ``n_devices``, when given, must be the world size.
    ``device_type`` "cpu" for ranks without a card."""
    world = dist.get_world_size()
    if n_devices not in (None, world):
        raise ValueError(f"one rank per device: n_devices {n_devices} is not "
                         f"the world size {world}")
    return init_device_mesh(device_type, (world,), mesh_dim_names=(axis,))


def backend_of(mesh: DeviceMesh) -> str:
    return dist.get_backend(mesh.get_group())


def replicated(mesh: DeviceMesh) -> tuple:
    from torch.distributed.tensor import Replicate

    return (Replicate(),)


def row_sharded(mesh: DeviceMesh) -> tuple:
    """Table placement: rows split over the mesh's one axis."""
    from torch.distributed.tensor import Shard

    return (Shard(0),)


def batch_sharded(mesh: DeviceMesh) -> tuple:
    """Index-batch placement: the leading dim split over the mesh."""
    from torch.distributed.tensor import Shard

    return (Shard(0),)


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor, without loading DTensor's module: no
    DTensor can exist before it is loaded."""
    mod = sys.modules.get(_DTENSOR_MODULE)
    return mod is not None and isinstance(t, mod.DTensor)


def row_range(n_rows: int, world: int, rank: int) -> Tuple[int, int]:
    """The rows [lo, hi) that ``rank`` of ``world`` owns under ``Shard(0)``:
    DTensor's chunking, ceil(n_rows / world) rows a rank, the last ranks
    shorter or empty."""
    c = -(-n_rows // world)
    lo = min(rank * c, n_rows)
    return lo, min(lo + c, n_rows)


def shard_state(state: Dict[str, torch.Tensor], mesh: DeviceMesh):
    """Every 2-D table as a ``Shard(0)`` DTensor over ``mesh``, other entries
    unchanged. Each rank keeps its own rows of its own copy
    (``src_data_rank=None``: no collective), so every rank must hold the
    same tables, as ranks that built them from one seed do. A model whose
    tables are placed so trains in "rows" mode on ``mesh``."""
    from torch.distributed.tensor import distribute_tensor

    return {k: distribute_tensor(v, mesh, row_sharded(mesh),
                                 src_data_rank=None)
            if getattr(v, "ndim", 0) == 2 else v
            for k, v in state.items()}


def row_mesh(state: Dict[str, torch.Tensor]) -> Optional[DeviceMesh]:
    """The mesh of the first row-sharded DTensor table of ``state``."""
    for v in state.values():
        if is_dtensor(v) and v.placements == row_sharded(v.device_mesh):
            return v.device_mesh
    return None


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _capturing(t: torch.Tensor) -> bool:
    """Whether the current stream of ``t``'s card is being captured into a
    CUDA graph (never for a CPU tensor)."""
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


class CommStats:
    """The collectives of one training run: count, payload bytes and
    seconds.

    An eager collective is timed by the host's clock with the device
    synchronised before and after it, so the compute queued before it is
    not charged to it; ``seconds`` sums those times. A collective issued
    while the current stream is being captured into a CUDA graph is issued
    with no synchronisation (a capture cannot wait on the device), and its
    call and bytes are tallied against that graph: ``recorded`` takes them
    back after the capture, since nothing ran, and ``credit`` adds them on
    every replay (``models.base.CapturedCalls`` does both), so a captured
    run counts the calls and bytes an eager one would. They are tallied as
    issued, not read from the graph's nodes: an in-place ``all_reduce`` on
    one rank may leave no node at all. Nothing inside a graph can be timed,
    so once a collective was captured ``seconds`` is None: not timed."""

    def __init__(self):
        self.calls, self.bytes = 0, 0
        self.seconds: Optional[float] = 0.0

    def all_reduce(self, t: torch.Tensor, group=None) -> None:
        if _capturing(t):
            dist.all_reduce(t, group=group)
            self.seconds = None
        else:
            _sync(t)
            t0 = time.perf_counter()
            dist.all_reduce(t, group=group)
            _sync(t)
            if self.seconds is not None:
                self.seconds += time.perf_counter() - t0
        self.calls += 1
        self.bytes += t.numel() * t.element_size()

    def read(self) -> Tuple[int, int]:
        """(calls, bytes) so far."""
        return self.calls, self.bytes

    def recorded(self, before: Tuple[int, int]) -> Tuple[int, int]:
        """After a capture: the calls and bytes tallied since ``before``
        (``read()``) are taken back, since nothing ran; returns them as the
        credit of one replay for ``credit``."""
        calls, nbytes = self.calls - before[0], self.bytes - before[1]
        self.credit((-calls, -nbytes))
        return calls, nbytes

    def credit(self, replayed: Tuple[int, int]) -> None:
        """Add a replay's (calls, bytes)."""
        self.calls += replayed[0]
        self.bytes += replayed[1]


def gather_rows(local: torch.Tensor, n_rows: int, group=None) -> torch.Tensor:
    """The whole (n_rows, ...) table from each rank's ``row_range`` block,
    on every rank (a collective: every rank calls it)."""
    world = dist.get_world_size(group)
    c = -(-n_rows // world)
    via = torch.device("cpu") if dist.get_backend(group) == "gloo" else \
        local.device
    block = torch.zeros((c,) + tuple(local.shape[1:]), dtype=local.dtype,
                        device=via)
    block[:local.shape[0]] = local
    parts = [torch.empty_like(block) for _ in range(world)]
    dist.all_gather(parts, block, group=group)
    return torch.cat(parts)[:n_rows].to(local.device)


def full_table(t: torch.Tensor) -> torch.Tensor:
    """``t`` whole: a row-sharded DTensor gathered (on every rank), any
    other tensor as it is."""
    if is_dtensor(t):
        return gather_rows(t.to_local(), t.shape[0],
                           t.device_mesh.get_group())
    return t


def rows_to_dtensor(local: torch.Tensor, n_rows: int, mesh: DeviceMesh):
    """This rank's ``row_range`` block as its shard of a ``Shard(0)``
    DTensor of n_rows rows (no collective)."""
    from torch.distributed.tensor import DTensor

    shape = (n_rows,) + tuple(local.shape[1:])
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, row_sharded(mesh), run_check=False,
                              shape=shape, stride=stride)


class RowShard(torch.Tensor):
    """The table that a step sees in "rows" mode: this rank's rows [lo, hi)
    of an (N, D) table split over a process group, reporting the global
    shape (N, D) and the shard's dtype and device.

    ``t[idx]`` gathers the rows ``idx`` (any shape of row ids): each rank
    fills the rows it owns, zeros elsewhere, and one ``all_reduce(SUM)`` of
    the (..., D) block completes it, O(len(idx) * D) traffic, exact because
    every entry adds only zeros. ``t.index_add_(0, idx, delta)`` adds the
    owned rows' deltas locally, in ``idx`` order, with no communication:
    every rank holds the same ids and deltas. Any other operation raises
    TypeError naming it: a silent gather of the whole table would defeat a
    mode whose point is tables larger than one card."""

    _META = (torch.Tensor.shape.__get__, torch.Tensor.dtype.__get__,
             torch.Tensor.device.__get__, torch.Tensor.ndim.__get__)

    @staticmethod
    def __new__(cls, local: torch.Tensor, n_rows: int, lo: int,
                comm: CommStats, group=None):
        t = torch.Tensor._make_wrapper_subclass(
            cls, (n_rows,) + tuple(local.shape[1:]), dtype=local.dtype,
            device=local.device)
        t.local, t.lo, t.comm, t.group = local, lo, comm, group
        return t

    def __repr__(self) -> str:
        return (f"RowShard(rows {self.lo}:{self.lo + self.local.shape[0]} "
                f"of {tuple(self.shape)})")

    def _owned(self, idx: torch.Tensor) -> torch.Tensor:
        return (idx >= self.lo) & (idx < self.lo + self.local.shape[0])

    def _gather(self, idx) -> torch.Tensor:
        if not (isinstance(idx, torch.Tensor) and not idx.is_floating_point()
                and idx.dtype != torch.bool):
            raise TypeError("a row-sharded table is indexed by a tensor of "
                            f"row ids, not {type(idx).__name__}")
        out = torch.zeros(tuple(idx.shape) + tuple(self.local.shape[1:]),
                          dtype=self.local.dtype, device=self.local.device)
        if self.local.shape[0]:
            owned = self._owned(idx)
            rows = self.local[torch.where(owned, idx - self.lo, 0)]
            out = rows.masked_fill_(~owned.unsqueeze(-1), 0.0)
        self.comm.all_reduce(out, self.group)
        return out

    def _index_add(self, dim: int, idx: torch.Tensor, src: torch.Tensor,
                   alpha=1):
        """Add the owned rows' deltas in ``idx`` order, in a form of fixed
        shape (no boolean index, so that a CUDA graph can capture it). An
        unowned id adds a zero whose product with ``alpha`` is -0.0 to row
        ``id % local_rows`` of this shard: x + -0.0 is x for every x, +0.0
        and -0.0 included, so the rows end bit for bit as the owned adds
        alone leave them. The unowned ids are spread over the shard's rows
        because adds that pile onto one row serialise the card's
        atomics."""
        if dim != 0:
            raise TypeError(f"a row-sharded table adds rows (dim 0), not "
                            f"dim {dim}")
        n = self.local.shape[0]
        if n == 0:  # nothing owned, no row to send the rest to
            return self
        owned = self._owned(idx)
        rows = torch.where(owned, idx - self.lo, idx % n)
        zero = -0.0 if alpha >= 0 else 0.0  # alpha * zero is -0.0
        src = torch.where(owned.unsqueeze(-1), src, zero)
        self.local.index_add_(0, rows, src, alpha=alpha)
        return self

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.Tensor.__getitem__:
            return args[0]._gather(args[1])
        if func is torch.Tensor.index_add_:
            return args[0]._index_add(*args[1:], **kwargs)
        if func in cls._META:
            with torch._C.DisableTorchFunctionSubclass():
                return func(*args, **kwargs)
        raise TypeError(
            f"{getattr(func, '__name__', func)}: a row-sharded table only "
            "gathers rows (t[idx]) and adds to them (t.index_add_(0, idx, "
            "delta)); a whole-table operation would gather every row")

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise TypeError(f"{func}: not defined on a row-sharded table")
