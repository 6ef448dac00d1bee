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

An event touches only row u of the user tables and rows i and neg of the
item tables, so the events fall into dependency levels (``scan_levels``:
level = 1 + the last level of any of its rows): the events of a level touch
disjoint rows and every row meets its events in time order. Walking the
levels in order gives every row the sequential scan's operations.

``jodie_epoch`` runs the plain PyTorch loop ``jodie_epoch_ref`` for CPU
tensors and launches the CUDA kernel (``csrc/jodie_epoch.cu``: the levels of
the ``level_schedule`` it is given in order, the events of a level side by
side across the SMs, one launch an epoch) for CUDA tensors, or raises; it
never falls back.
``KERNEL.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from smore_tpu_torch.ops.launches import Kernel

_sched_lib = None
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = Kernel("jodie_epoch", [_I] + [_P] * 17 + [_I] * 5 + [_F] * 2
                + [_P] * 2, {"plan": (_I, [_I] * 3 + [_P])})
# the kernel computes an event on a cluster of up to this many blocks
# (csrc/jodie_epoch.cu kMaxSplit, a portable cluster)
_MAX_SPLIT = 8


def _load_schedule():
    global _sched_lib
    if _sched_lib is None:
        from smore_tpu_torch.ops._build import load_host_lib

        lib = load_host_lib("jodie_schedule")
        ptr = np.ctypeslib.ndpointer
        lib.jodie_scan_levels.restype = ctypes.c_int64
        lib.jodie_scan_levels.argtypes = [ptr(np.int32)] * 3 + [
            ctypes.c_int64] * 3 + [ptr(np.int32)] * 2
        _sched_lib = lib
    return _sched_lib


def _host_ids(*ids) -> Tuple[np.ndarray, ...]:
    return tuple(np.ascontiguousarray(
        (t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)),
        dtype=np.int32) for t in ids)


def scan_levels(uid, iid, negs, n_users: int,
                n_items: int) -> Tuple[np.ndarray, np.ndarray]:
    """The epoch's dependency levels (host C++, ``csrc/jodie_schedule.cpp``):
    ``order`` (T,) int32, the events grouped by level and in time order
    inside a level, and ``level_ptr`` (L + 1,) int32, each level's start in
    ``order``. Event e's level is 1 + the last level of ue[uid[e]],
    ie[iid[e]] and ie[negs[e]]. Raises on a row out of range."""
    u, i, n = _host_ids(uid, iid, negs)
    T = len(u)
    if len(i) != T or len(n) != T:
        raise ValueError("uid, iid and negs must have one length")
    order = np.empty(T, np.int32)
    ptr = np.empty(T + 1, np.int32)
    L = _load_schedule().jodie_scan_levels(u, i, n, T, n_users, n_items,
                                           order, ptr)
    if L < 0:
        raise ValueError(f"event {-1 - L} has a row out of range "
                         f"({n_users} users, {n_items} items)")
    return order, ptr[:L + 1].copy()


def scan_levels_np(uid, iid, negs, n_users: int,
                   n_items: int) -> Tuple[np.ndarray, np.ndarray]:
    """numpy twin of ``scan_levels``."""
    u, i, n = _host_ids(uid, iid, negs)
    last_u = np.zeros(n_users, np.int64)
    last_i = np.zeros(n_items, np.int64)
    level = np.zeros(len(u), np.int64)
    for e in range(len(u)):
        lev = 1 + max(last_u[u[e]], last_i[i[e]], last_i[n[e]])
        level[e] = last_u[u[e]] = last_i[i[e]] = last_i[n[e]] = lev
    L = int(level.max()) if len(level) else 0
    order = np.argsort(level, kind="stable").astype(np.int32)
    counts = np.bincount(level, minlength=L + 1)[1:]
    ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return order, ptr


class LevelSchedule(NamedTuple):
    """``scan_levels``' output on the tables' device, and ``level_ptr``'s
    host copy ``bounds``: the launch reads the level count and the widest
    level (its grid) from it without a copy from the card."""
    order: torch.Tensor  # (T,) int32
    level_ptr: torch.Tensor  # (L + 1,) int32
    bounds: np.ndarray  # (L + 1,) int32

    @property
    def n_levels(self) -> int:
        return len(self.bounds) - 1

    @property
    def max_width(self) -> int:
        return int(np.diff(self.bounds).max()) if self.n_levels else 0


def level_schedule(uid, iid, negs, n_users: int, n_items: int,
                   device) -> LevelSchedule:
    """``scan_levels`` on the host (negs is copied there), moved to
    ``device``."""
    order, ptr = scan_levels(uid, iid, negs, n_users, n_items)
    return LevelSchedule(torch.from_numpy(order).to(device),
                         torch.from_numpy(ptr).to(device), ptr)


def _check_schedule(s: LevelSchedule, T: int, device) -> None:
    b = np.asarray(s.bounds)
    if (s.order.shape != (T,) or s.level_ptr.shape != b.shape
            or s.order.device != device or s.level_ptr.device != device):
        raise ValueError(f"the schedule must order these {T} events on the "
                         "tables' device")
    if b.ndim != 1 or len(b) == 0 or b[0] != 0 or b[-1] != T or (
            np.diff(b) < 0).any():
        raise ValueError(f"the schedule's levels must run from 0 to {T}")


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
                lr: float, bce_lr: float,
                schedule: Optional[LevelSchedule] = None) -> torch.Tensor:
    """One epoch's scan, the four tables updated in place.

    ue, ie: (U, D), (I, D) f32 dynamic tables; us, is_: the static ones;
    uid, iid, negs: (T,) event users, items and negative items; cu, ci: (T,
    D) the RNN inputs' table-free parts; up, ip: the user and item cells
    (``Wh`` (D, D), ``Wx`` (D, in)); lr, bce_lr: floats; any D >= 1.
    Returns the summed BCE loss, a () tensor. ``schedule`` is
    ``level_schedule`` of these very events (negs included): the card needs
    it, the plain loop ignores it; its shape and levels are checked, its
    order is not, and a schedule of other events races on the card. Indices
    are not bounds-checked on the card (``scan_levels`` checks them on the
    host)."""
    _check(ue, ie, us, is_, uid, iid, negs, cu, ci, up, ip)
    dev = ue.device
    D, T = ue.shape[1], uid.shape[0]
    if schedule is not None:
        _check_schedule(schedule, T, dev)
    if dev.type == "cpu":
        return jodie_epoch_ref(ue, ie, us, is_, uid, iid, negs, cu, ci, up,
                               ip, lr, bce_lr)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if schedule is None:
        raise ValueError("the kernel needs the epoch's level_schedule")
    # freed on return while the launch may still run: the caching allocator
    # hands their memory only to later work on the same stream
    ids = [t.to(torch.int32).contiguous()
           for t in (uid, iid, negs, schedule.order, schedule.level_ptr)]
    ws = [p[k].contiguous() for p in (up, ip) for k in ("Wh", "Wx")]
    slots = torch.empty((T, 4), dtype=torch.int32, device=dev)
    partials = torch.empty(_MAX_SPLIT * max(schedule.max_width, 1),
                           dtype=torch.float32, device=dev)
    # the kernel writes the loss: with int32 inputs a call is one launch
    loss = torch.empty((), dtype=torch.float32, device=dev)
    KERNEL.launch(
        dev, ue.data_ptr(), ie.data_ptr(), us.data_ptr(), is_.data_ptr(),
        *(t.data_ptr() for t in ids), cu.data_ptr(), ci.data_ptr(),
        *(w.data_ptr() for w in ws), slots.data_ptr(), partials.data_ptr(),
        T, schedule.n_levels, schedule.max_width, D, ws[1].shape[1], lr,
        bce_lr, loss.data_ptr())
    return loss


def kernel_plan(D: int, max_width: int, device: int = 0) -> dict:
    """The kernel's layout for (D, widest level) on the card: grid blocks,
    blocks an event (split), cached weight rows of a block, shared bytes
    of a block."""
    out = (ctypes.c_int * 4)()
    KERNEL.check(KERNEL.call("plan", device, D, max_width,
                             ctypes.addressof(out)), "plan")
    return dict(grid=out[0], split=out[1], cached_rows=out[2],
                smem_bytes=out[3])
