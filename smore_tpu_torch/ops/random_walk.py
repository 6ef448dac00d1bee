"""Batched random walks on the card: the walk kernel.

``smore_tpu/sampling/walks.py::random_walk`` is a ``lax.scan`` over the
steps, with no Pallas kernel. Here one launch of ``csrc/random_walk.cu``
takes every step, one thread a walk, with the rounding of
``SamplerTables._context_of`` and ``sampling/walks.random_walk``'s restart
rule, so its walks are bit-equal to the plain twin
``sampling/walks.random_walk_ref`` given the same uniforms.

``check`` holds the inputs to the kernel's contract on any device.
``random_walk`` launches the kernel for CUDA tensors and raises for any
other device; ``sampling/walks.random_walk`` runs the twin on the CPU.
``KERNEL.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from smore_tpu_torch.ops.launches import Kernel, aligned

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("random_walk", [_I] + [_P] * 6 + [_I] * 4 + [_P])


def check(starts, steps: int, u, vert_meta, ctx_pa) -> None:
    """What the kernel takes: one device, a (B,) int32 batch of starts,
    (steps, B, 2) float32 uniforms, vert_meta (N, 2) int32 and ctx_pa
    (E, 4) float32."""
    if starts.dim() != 1 or starts.dtype != torch.int32:
        raise ValueError(f"starts must be (B,) int32, got "
                         f"{tuple(starts.shape)} {starts.dtype}")
    want = (steps, starts.shape[0], 2)
    if tuple(u.shape) != want or u.dtype != torch.float32:
        raise ValueError(f"u must be {want} float32, got {tuple(u.shape)} "
                         f"{u.dtype}")
    if (vert_meta.dim() != 2 or vert_meta.shape[1] != 2
            or vert_meta.dtype != torch.int32 or ctx_pa.dim() != 2
            or ctx_pa.shape[1] != 4 or ctx_pa.dtype != torch.float32):
        raise ValueError("tables must hold vert_meta (N, 2) int32 and ctx_pa "
                         "(E, 4) float32")
    devs = {t.device for t in (starts, u, vert_meta, ctx_pa)}
    if len(devs) != 1:
        raise ValueError(f"all tensors must share one device, got {devs}")


def random_walk(starts, u, vert_meta, ctx_pa,
                restart_on_deadend: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Walks of ``u.shape[0]`` steps from ``starts``: (walk (B, steps + 1)
    int32, row_mask (B,) float32, 0 where the start has no out-edge), in
    one launch on the current stream. Arguments as ``check`` takes them, on
    a CUDA card. Vertex ids are not bounds-checked on the card."""
    steps = u.shape[0]
    check(starts, steps, u, vert_meta, ctx_pa)
    dev = starts.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    B = starts.shape[0]
    walk = torch.empty((B, steps + 1), dtype=torch.int32, device=dev)
    row_mask = torch.empty((B,), dtype=torch.float32, device=dev)
    if B == 0:  # a grid of no blocks is a launch error
        return walk, row_mask
    # freed on return while the launch may still run: the caching allocator
    # hands their memory only to later work on the same stream
    starts, u = starts.contiguous(), aligned(u, 8)
    meta, ctx = aligned(vert_meta, 8), aligned(ctx_pa, 16)
    KERNEL.launch(dev, starts.data_ptr(), u.data_ptr(), meta.data_ptr(),
                  ctx.data_ptr(), walk.data_ptr(), row_mask.data_ptr(), B,
                  steps, ctx.shape[0], int(bool(restart_on_deadend)))
    return walk, row_mask
