"""Fused shared-negative SGNS gradients: the unbanded LINE path's kernel.

Port of ``smore_tpu/ops/pallas_sgns.py::sgns_shared_grads_pallas``. Given
the gathered rows v, cp (B, D) and the shared negatives cn (Ks, D):

    g_pos = (1 - sigmoid(v . cp)) * alpha                 (B,)
    g_neg = -sigmoid(v cn^T) * alpha * k_equiv / Ks       (B, Ks)
    d_src = g_pos cp + g_neg cn                           (B, D)
    d_pos = g_pos v                                       (B, D)
    d_neg = g_neg^T v                                     (Ks, D)

No gather and no scatter: the caller (``ops.update.sgns_shared_negs_step``)
does both. The TPU kernel summed ``d_neg`` over 1024-row tiles in order;
the CUDA kernel sums it with atomics, so only the f32 summation order
differs.

``sgns_shared_grads`` runs the plain PyTorch twin ``sgns_shared_grads_ref``
for CPU tensors and launches the CUDA kernel (``csrc/sgns_shared_grads.cu``)
for CUDA tensors, or raises; it never falls back. A call is ONE cooperative
launch of a persistent kernel (one block per SM, all co-resident): g_neg
stays in shared memory and the kernel zeroes and sums ``d_neg`` itself.
``sgns_shared_grads.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

_KERNEL = "sgns_shared_grads"
_MAX_SMEM = 232_448  # bytes of shared memory one H100 block may use
_lib = None
_P, _I = ctypes.c_void_p, ctypes.c_int
# the launcher's C signature as ctypes passes it (pointers and the stream as
# c_void_p), held to csrc/ by tests/test_torch_sgns_banded.py
LAUNCH_ARGTYPES = {
    _KERNEL: [_I] + [_P] * 4 + [_I] * 3 + [ctypes.c_float] + [_P] * 4,
}


def _load():
    global _lib
    if _lib is None:
        from smore_tpu_torch.ops._build import load_kernel_lib

        lib = load_kernel_lib(_KERNEL)
        lib.sgns_shared_grads_launch.restype = _I
        lib.sgns_shared_grads_launch.argtypes = LAUNCH_ARGTYPES[_KERNEL]
        lib.sgns_sg_smem_bytes.restype = ctypes.c_size_t
        lib.sgns_sg_smem_bytes.argtypes = [_I, _I]
        lib.sgns_sg_grid_size.restype = _I
        lib.sgns_sg_grid_size.argtypes = [_I] * 4
        lib.sgns_sg_error_string.restype = ctypes.c_char_p
        lib.sgns_sg_error_string.argtypes = [_I]
        _lib = lib
    return _lib


def _check(v, cp, cn, alpha):
    if v.dim() != 2 or cp.shape != v.shape:
        raise ValueError(f"v and cp must be one (B, D) shape, got "
                         f"{tuple(v.shape)} / {tuple(cp.shape)}")
    B, D = v.shape
    if cn.dim() != 2 or cn.shape[1] != D or cn.shape[0] < 1:
        raise ValueError(f"cn must be (Ks, {D}), got {tuple(cn.shape)}")
    for name, t in (("v", v), ("cp", cp), ("cn", cn)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    if B < 1 or B % min(1024, B):
        raise ValueError(f"batch {B} must be a multiple of the 1024-row "
                         "tile")
    devs = {t.device for t in (v, cp, cn)}
    if torch.is_tensor(alpha):
        if alpha.numel() != 1:
            raise ValueError(f"alpha must be a scalar, got "
                             f"{tuple(alpha.shape)}")
        devs.add(alpha.device)
    if len(devs) != 1:
        raise ValueError(f"all tensors must share one device, got {devs}")


def sgns_shared_grads_ref(v, cp, cn, alpha, k_equiv: int = 5):
    """Plain PyTorch twin of the kernel: returns (d_src, d_pos, d_neg)."""
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=v.device)
    scale = alpha * (k_equiv / cn.shape[0])
    g_pos = (1.0 - torch.sigmoid((v * cp).sum(1, keepdim=True))) * alpha
    g_neg = torch.sigmoid(v @ cn.T) * (-scale)
    return g_pos * cp + g_neg @ cn, g_pos * v, g_neg.T @ v


def sgns_shared_grads(v, cp, cn, alpha, k_equiv: int = 5):
    """The fused gradients (see the module docstring).

    v, cp: (B, D) f32, B a multiple of min(1024, B); cn: (Ks, D) f32;
    alpha: a scalar (a one-element tensor on the same device, or a number).
    On the card D must be a multiple of 4 (rows move as 16-byte vectors).
    Returns (d_src (B, D), d_pos (B, D), d_neg (Ks, D)), all f32."""
    _check(v, cp, cn, alpha)
    if v.device.type == "cpu":
        return sgns_shared_grads_ref(v, cp, cn, alpha, k_equiv)
    if v.device.type != "cuda":
        raise ValueError(f"no kernel for device {v.device}")
    lib = _load()
    B, D = v.shape
    Ks = cn.shape[0]
    if lib.sgns_sg_smem_bytes(Ks, D) == 0:
        raise ValueError(f"the kernel takes D a multiple of 4 and (Ks, D) "
                         f"whose buffers fit {_MAX_SMEM} B of shared memory "
                         f"per block, got Ks={Ks}, D={D}")
    dev = v.device
    f32 = dict(dtype=torch.float32, device=dev)
    # Tensors made here are freed when this returns, while the launch may
    # still run: the caching allocator hands their memory only to later work
    # on the same stream, which runs after it. Nothing here launches a
    # kernel of its own when the inputs are contiguous on 16 bytes and alpha
    # is an f32 tensor on the card: the kernel zeroes d_neg itself.
    v, cp, cn = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
                 else t.clone(memory_format=torch.contiguous_format)
                 for t in (v, cp, cn))
    alpha = torch.as_tensor(alpha, **f32).reshape(1).contiguous()
    d_src = torch.empty(B, D, **f32)
    d_pos = torch.empty(B, D, **f32)
    d_neg = torch.empty(Ks, D, **f32)
    rc = lib.sgns_shared_grads_launch(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        v.data_ptr(), cp.data_ptr(), cn.data_ptr(), alpha.data_ptr(),
        B, Ks, D, k_equiv / Ks,
        d_src.data_ptr(), d_pos.data_ptr(), d_neg.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"sgns_shared_grads launch failed: CUDA error {rc} "
            f"({lib.sgns_sg_error_string(rc).decode()})")
    sgns_shared_grads.launches += 1
    return d_src, d_pos, d_neg


sgns_shared_grads.launches = 0
