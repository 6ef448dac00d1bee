"""Band row scatter-add: the scatter-only banded route's kernel (K2).

Port of ``smore_tpu/ops/pallas_scatter.py::band_scatter_add``:
``table[start + idx[r]] += delta[r]`` for every row r, duplicates summed.
The JAX kernel took the band slice itself; here the wrapper takes the whole
table and the band START row as a one-element device tensor, so no step
reads a band start back to the host. The TPU summed duplicates in serial
order; the CUDA kernel sums them with atomics, so only the f32 order of a
duplicate's sum differs.

``band_scatter_add`` runs the plain PyTorch twin ``band_scatter_add_ref``
(``index_add_``) for CPU tensors and launches the CUDA kernel
(``csrc/band_scatter_add.cu``) for CUDA tensors, or raises; it never falls
back. ``band_scatter_add.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

_KERNEL = "band_scatter_add"
_lib = None
_P, _I = ctypes.c_void_p, ctypes.c_int
# the launcher's C signature as ctypes passes it (pointers and the stream as
# c_void_p), held to csrc/ by tests/test_torch_sgns_banded.py
LAUNCH_ARGTYPES = {_KERNEL: [_I] + [_P] * 4 + [_I] * 2 + [_P]}


def _load():
    global _lib
    if _lib is None:
        from smore_tpu_torch.ops._build import load_kernel_lib

        lib = load_kernel_lib(_KERNEL)
        lib.band_scatter_add_launch.restype = _I
        lib.band_scatter_add_launch.argtypes = LAUNCH_ARGTYPES[_KERNEL]
        lib.band_scatter_error_string.restype = ctypes.c_char_p
        lib.band_scatter_error_string.argtypes = [_I]
        _lib = lib
    return _lib


def _check(table, start, idx, delta):
    if (delta.dim() != 2 or table.dim() != 2
            or table.shape[1] != delta.shape[1]):
        raise ValueError(f"table (rows, D) and delta (B, D) must share D, "
                         f"got {tuple(table.shape)} / {tuple(delta.shape)}")
    for name, t in (("table", table), ("delta", delta)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    if not table.is_contiguous():
        raise ValueError("table must be contiguous (updated in place)")
    B = delta.shape[0]
    if tuple(idx.shape) != (B,):
        raise ValueError(f"idx must be ({B},), got {tuple(idx.shape)}")
    if start.numel() != 1:
        raise ValueError(f"start must hold one value, got "
                         f"{tuple(start.shape)}")
    # the TPU kernel's asserts (pallas_scatter.py:61-63): 2048-row delta
    # tiles and its 8-row unroll
    tb = min(2048, B)
    if B < 1 or B % tb or tb % 8:
        raise ValueError(f"batch {B} must tile by min(2048, B), a multiple "
                         "of 8")
    devs = {t.device for t in (table, start, idx, delta)}
    if len(devs) != 1:
        raise ValueError(f"all tensors must share one device, got {devs}")


def band_scatter_add_ref(table, start, idx, delta):
    """Plain PyTorch twin of the kernel: ``index_add_`` at global rows."""
    return table.index_add_(0, (start.reshape(()) + idx).long(), delta)


def band_scatter_add(table, start, idx, delta):
    """``table[start + idx] += delta`` in place, duplicates summed.

    table: (rows, D) f32 contiguous; start: one-element int tensor, the
    band's first row; idx: (B,) BAND-LOCAL rows; delta: (B, D) f32, B
    tiling by min(2048, B). Returns ``table``. Indices are not
    bounds-checked on the card (that would synchronise), as on the TPU."""
    _check(table, start, idx, delta)
    if table.device.type == "cpu":
        return band_scatter_add_ref(table, start, idx, delta)
    if table.device.type != "cuda":
        raise ValueError(f"no kernel for device {table.device}")
    lib = _load()
    dev = table.device
    # freed on return while the launch may still run: the caching allocator
    # hands their memory only to later work on the same stream
    start = start.to(torch.int32).reshape(1)
    idx = idx.to(torch.int32).contiguous()
    delta = delta.contiguous()
    B, D = delta.shape
    rc = lib.band_scatter_add_launch(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        table.data_ptr(), start.data_ptr(), idx.data_ptr(), delta.data_ptr(),
        B, D, torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"band_scatter_add launch failed: CUDA error {rc} "
            f"({lib.band_scatter_error_string(rc).decode()})")
    band_scatter_add.launches += 1
    return table


band_scatter_add.launches = 0
