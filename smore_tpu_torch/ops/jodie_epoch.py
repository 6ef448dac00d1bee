"""One JODIE epoch: the chronological scan over the events.

Port of the ``lax.scan`` body of ``smore_tpu/models/jodie.py``
(``JODIE._epoch_fn``). For each event e = (u, i, neg), in time order:

  1. p_pos = sigmoid(ue[u] . ie[i]), p_neg = sigmoid(ue[u] . ie[neg]); the
     BCE loss -log(p_pos + 1e-10) - log(1 - p_neg + 1e-10) is summed;
  2. BCE step at ``bce_lr``: uvec = ue[u] + du, ivec = ie[i] + di, dn onto
     ie[neg]; written ue[u] = uvec, ie[i] = ivec, THEN ie[neg] += dn (when
     neg == i, dn lands and is overwritten below);
  3. the RNN cells (never trained): new_u = (1 - lr) uvec + lr tanh(Wh_u
     uvec + Wx_u [ivec | f | dt_u] + b_u), new_i alike with [uvec | f |
     dt_i], both from the post-BCE vectors; ue[u] = new_u, ie[i] = new_i;
  4. the statics move toward them: us[u] += 0.1 lr (new_u - us[u]), the
     same for is_[i].

The parts of the RNN input that do not depend on the tables, Wx[:, D:]
[f | dt] + b, are computed for every event before the scan (``cu``,
``ci``: (T, D)), so the scan multiplies only by Wh and Wx[:, :D].

``jodie_epoch`` runs the plain PyTorch loop ``jodie_epoch_ref`` for CPU
tensors and launches the CUDA kernel (``csrc/jodie_epoch.cu``: one block
scans the whole epoch, one launch) for CUDA tensors, or raises; it never
falls back. ``jodie_epoch.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

_KERNEL = "jodie_epoch"
_lib = None
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the launcher's C signature as ctypes passes it, held to csrc/ by
# tests/test_torch_sgns_banded.py
LAUNCH_ARGTYPES = {_KERNEL: [_I] + [_P] * 13 + [_I] * 3 + [_F] * 2
                   + [_P] * 2}
# the kernel keeps Wh and Wx[:, :D] of both cells in shared memory, padded
# rows of D + 1 floats, and runs 4 D threads: D a multiple of 32 up to 96
MAX_DIM = 96


def _load():
    global _lib
    if _lib is None:
        from smore_tpu_torch.ops._build import load_kernel_lib

        lib = load_kernel_lib(_KERNEL)
        lib.jodie_epoch_launch.restype = _I
        lib.jodie_epoch_launch.argtypes = LAUNCH_ARGTYPES[_KERNEL]
        lib.jodie_epoch_error_string.restype = ctypes.c_char_p
        lib.jodie_epoch_error_string.argtypes = [_I]
        lib.jodie_epoch_smem_bytes.restype = _I
        lib.jodie_epoch_smem_bytes.argtypes = [_I]
        _lib = lib
    return _lib


def _check(ue, ie, us, is_, uid, iid, negs, cu, ci, up, ip):
    D = ue.shape[1]
    T = uid.shape[0]
    tables = (("ue", ue), ("ie", ie), ("us", us), ("is_", is_),
              ("cu", cu), ("ci", ci))
    for name, t in tables + tuple(
            (f"{c}.{k}", p[k]) for c, p in (("up", up), ("ip", ip))
            for k in ("Wh", "Wx")):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    for name, t in tables:
        if t.dim() != 2 or t.shape[1] != D or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (rows, {D}) "
                             f"table, got {tuple(t.shape)}")
    if us.shape != ue.shape or is_.shape != ie.shape:
        raise ValueError("the static tables must match the dynamic ones")
    for name, t in (("iid", iid), ("negs", negs)):
        if tuple(t.shape) != (T,):
            raise ValueError(f"{name} must be ({T},), got {tuple(t.shape)}")
    if cu.shape[0] != T or ci.shape[0] != T:
        raise ValueError(f"cu and ci must have {T} rows")
    if up["Wx"].shape != ip["Wx"].shape:
        raise ValueError("the user and item cells must take one input "
                         "width")
    for c, p in (("up", up), ("ip", ip)):
        if (tuple(p["Wh"].shape) != (D, D) or p["Wx"].dim() != 2
                or p["Wx"].shape[0] != D or p["Wx"].shape[1] < D):
            raise ValueError(f"{c}: Wh must be ({D}, {D}) and Wx ({D}, >= "
                             f"{D})")
    devs = {t.device for _, t in tables} | {
        t.device for t in (uid, iid, negs, up["Wh"], up["Wx"], ip["Wh"],
                           ip["Wx"])}
    if len(devs) != 1:
        raise ValueError(f"all tensors must share one device, got {devs}")


def jodie_epoch_ref(ue, ie, us, is_, uid, iid, negs, cu, ci,
                    up: Dict[str, torch.Tensor], ip: Dict[str, torch.Tensor],
                    lr: float, bce_lr: float) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: the events one after another,
    the tables updated in place. Returns the summed BCE loss, a () tensor
    on the tables' device."""
    D = ue.shape[1]
    wh_u, wx_u = up["Wh"], up["Wx"][:, :D]
    wh_i, wx_i = ip["Wh"], ip["Wx"][:, :D]
    loss = torch.zeros((), dtype=torch.float32, device=ue.device)
    events = zip(uid.tolist(), iid.tolist(), negs.tolist())
    for e, (u, i, n) in enumerate(events):
        uvec, ivec, nvec = ue[u], ie[i], ie[n]
        p_pos = torch.sigmoid(uvec @ ivec)
        p_neg = torch.sigmoid(uvec @ nvec)
        loss += -torch.log(p_pos + 1e-10) - torch.log(1 - p_neg + 1e-10)
        du = bce_lr * ((1 - p_pos) * ivec - p_neg * nvec)
        di = bce_lr * (1 - p_pos) * uvec
        dn = -bce_lr * p_neg * uvec
        uvec = uvec + du
        ivec = ivec + di
        ue[u] = uvec
        ie[i] = ivec
        ie[n] += dn
        new_u = (1 - lr) * uvec + lr * torch.tanh(
            wh_u @ uvec + wx_u @ ivec + cu[e])
        new_i = (1 - lr) * ivec + lr * torch.tanh(
            wh_i @ ivec + wx_i @ uvec + ci[e])
        ue[u] = new_u
        ie[i] = new_i
        us[u] += 0.1 * lr * (new_u - us[u])
        is_[i] += 0.1 * lr * (new_i - is_[i])
    return loss


def jodie_epoch(ue, ie, us, is_, uid, iid, negs, cu, ci,
                up: Dict[str, torch.Tensor], ip: Dict[str, torch.Tensor],
                lr: float, bce_lr: float) -> torch.Tensor:
    """One epoch's scan, the four tables updated in place.

    ue, ie: (U, D), (I, D) f32 dynamic tables; us, is_: the static ones;
    uid, iid, negs: (T,) event users, items and negative items; cu, ci: (T,
    D) the RNN inputs' table-free parts; up, ip: the user and item cells
    (``Wh`` (D, D), ``Wx`` (D, in)); lr, bce_lr: floats. Returns the summed
    BCE loss, a () tensor. Indices are not bounds-checked on the card (that
    would synchronise)."""
    _check(ue, ie, us, is_, uid, iid, negs, cu, ci, up, ip)
    if ue.device.type == "cpu":
        return jodie_epoch_ref(ue, ie, us, is_, uid, iid, negs, cu, ci, up,
                               ip, lr, bce_lr)
    if ue.device.type != "cuda":
        raise ValueError(f"no kernel for device {ue.device}")
    D = ue.shape[1]
    if D % 32 or D > MAX_DIM:
        raise ValueError(f"the jodie_epoch kernel takes a dim that is a "
                         f"multiple of 32 up to {MAX_DIM}, got {D}")
    lib = _load()
    dev = ue.device
    # freed on return while the launch may still run: the caching allocator
    # hands their memory only to later work on the same stream
    ids = [t.to(torch.int32).contiguous() for t in (uid, iid, negs)]
    ws = [p[k].contiguous() for p in (up, ip) for k in ("Wh", "Wx")]
    # the kernel writes the loss: with int32 indices a call is one launch
    loss = torch.empty((), dtype=torch.float32, device=dev)
    rc = lib.jodie_epoch_launch(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        ue.data_ptr(), ie.data_ptr(), us.data_ptr(), is_.data_ptr(),
        *(t.data_ptr() for t in ids), cu.data_ptr(), ci.data_ptr(),
        *(w.data_ptr() for w in ws), uid.shape[0], D, ws[1].shape[1],
        lr, bce_lr, loss.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"jodie_epoch launch failed: CUDA error {rc} "
            f"({lib.jodie_epoch_error_string(rc).decode()})")
    jodie_epoch.launches += 1
    return loss


jodie_epoch.launches = 0
