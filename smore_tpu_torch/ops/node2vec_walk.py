"""node2vec's second-order walks on the card: the node2vec walk kernel.

``smore_tpu/sampling/walks.py::node2vec_walk`` is a loop of jnp ops over
the steps, with no Pallas kernel. Here one launch of
``csrc/node2vec_walk.cu`` takes every step, with the rounding of
``SamplerTables._context_of``, the acceptance test and the restart rule of
``sampling/walks.node2vec_walk_ref``, so its walks are bit-equal to that
plain twin's given the same uniforms.

The kernel is latency-bound, and has two instances (``LANES``): one
thread a walk, and a warp a walk. In the warp, the lanes split into one
group a trial, which draws its candidate and searches prev's sorted list
with the group's lanes at once, and a ballot keeps the earliest accepted
trial: a step is ~3-4 dependent reads, against ~19 for one thread a walk
on the Youtube graph. One thread a walk issues ~32 times fewer
instructions a walk, so it wins once the batch fills the card.
``lanes_for`` picks the instance from the batch and the card's SM count
alone.

``check`` holds the inputs to the kernel's contract on any device.
``node2vec_walk`` launches the kernel for CUDA tensors and raises for any
other device; ``sampling/walks.node2vec_walk`` runs the twin on the CPU.
``KERNEL.launches`` counts kernel launches, and the tracer's counter
``node2vec_walk.warp_launches`` those of a multi-lane instance.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from smore_tpu_torch.ops.launches import Kernel, aligned, device_index
from smore_tpu_torch.utils import profiling

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# one launcher for every instance: the device index, then the lane count
KERNEL = Kernel("node2vec_walk",
                [_I] * 2 + [_P] * 9 + [_I] * 4 + [_F] * 3 + [_P],
                symbol="node2vec_walk_launch_lanes")

# the kernel's instances, lanes a walk (node2vec_walk_steps<lanes>)
LANES = (1, 32)
# the largest batch, in walks an SM, that takes a warp a walk: on the H100
# a warp a walk is ahead up to ~20,000 walks on the Flickr tables and
# ~33,000 on Youtube's, one thread a walk above (chip_smoke.py phase 38;
# PERF.md section 6)
WARP_WALKS_PER_SM = 160


def lanes_for(B: int, sms: int) -> int:
    """The instance for a launch of B walks on a card of ``sms`` SMs: a
    warp a walk while one thread a walk would leave the card nearly empty,
    one thread a walk once the batch fills it."""
    return 32 if B <= WARP_WALKS_PER_SM * sms else 1


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def biases(p: float, q: float) -> Tuple[float, float, float]:
    """(1/p, 1/q, the largest of 1/p, 1 and 1/q), as the twin computes
    them in Python's doubles before float32 takes them."""
    inv_p, inv_q = 1.0 / p, 1.0 / q
    return inv_p, inv_q, max(inv_p, 1.0, inv_q)


def check(starts, steps: int, trials: int, u_first, u, vert_meta, ctx_pa,
          indptr, sorted_nbrs) -> None:
    """What the kernel takes: one device, a (B,) int32 batch of starts,
    (B, 2) and (steps - 1, B, trials, 3) float32 uniforms, at least one
    trial, vert_meta (N, 2) int32, ctx_pa (E, 4) float32, indptr (N + 1,)
    int32 and sorted_nbrs (E,) int32."""
    if starts.dim() != 1 or starts.dtype != torch.int32:
        raise ValueError(f"starts must be (B,) int32, got "
                         f"{tuple(starts.shape)} {starts.dtype}")
    if trials < 1:
        raise ValueError(f"trials must be at least 1, got {trials}")
    B = starts.shape[0]
    want = {"u_first": (u_first, (B, 2)),
            "u": (u, (max(steps - 1, 0), B, trials, 3))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {shape} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    n = vert_meta.shape[0]
    if (vert_meta.dim() != 2 or vert_meta.shape[1] != 2
            or vert_meta.dtype != torch.int32 or ctx_pa.dim() != 2
            or ctx_pa.shape[1] != 4 or ctx_pa.dtype != torch.float32):
        raise ValueError("tables must hold vert_meta (N, 2) int32 and ctx_pa "
                         "(E, 4) float32")
    if (tuple(indptr.shape) != (n + 1,) or indptr.dtype != torch.int32
            or tuple(sorted_nbrs.shape) != (ctx_pa.shape[0],)
            or sorted_nbrs.dtype != torch.int32):
        raise ValueError("the neighbour index must hold indptr (N + 1,) "
                         "int32 and sorted_nbrs (E,) int32")
    devs = {t.device for t in (starts, u_first, u, vert_meta, ctx_pa,
                               indptr, sorted_nbrs)}
    if len(devs) != 1:
        raise ValueError(f"all tensors must share one device, got {devs}")


def node2vec_walk(starts, u_first, u, vert_meta, ctx_pa, indptr,
                  sorted_nbrs, steps: int, p: float, q: float,
                  trials: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Second-order walks of ``steps`` steps from ``starts``: (walk (B,
    steps + 1) int32, row_mask (B,) float32, 0 where the start has no
    out-edge), in one launch on the current stream, of the instance
    ``lanes_for`` picks. Arguments as ``check`` takes them, on a CUDA card.
    Vertex ids are not bounds-checked on the card."""
    check(starts, steps, trials, u_first, u, vert_meta, ctx_pa, indptr,
          sorted_nbrs)
    dev = starts.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    B = starts.shape[0]
    walk = torch.empty((B, steps + 1), dtype=torch.int32, device=dev)
    row_mask = torch.empty((B,), dtype=torch.float32, device=dev)
    if B == 0:  # a grid of no blocks is a launch error
        return walk, row_mask
    inv_p, inv_q, max_bias = biases(p, q)
    # freed on return while the launch may still run: the caching allocator
    # hands their memory only to later work on the same stream
    starts, u = starts.contiguous(), u.contiguous()
    u_first = aligned(u_first, 8)
    meta, ctx = aligned(vert_meta, 8), aligned(ctx_pa, 16)
    indptr, nbrs = indptr.contiguous(), sorted_nbrs.contiguous()
    lanes = lanes_for(B, _sm_count(device_index(dev)))
    KERNEL.launch(dev, lanes, starts.data_ptr(), u_first.data_ptr(),
                  u.data_ptr(), meta.data_ptr(), ctx.data_ptr(),
                  indptr.data_ptr(), nbrs.data_ptr(), walk.data_ptr(),
                  row_mask.data_ptr(), B, steps, trials, ctx.shape[0], inv_p,
                  inv_q, max_bias)
    if lanes > 1:
        profiling.count("node2vec_walk.warp_launches")
    return walk, row_mask
