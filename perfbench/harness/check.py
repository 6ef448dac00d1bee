"""The output check: the numbers that decide ``correct``.

The program's first three updates (``record``) are followed by the plain
reference (``perfbench/reference/sgns.py``) from the tables the program
started from, on the draws the program made; the draws and the tables that
set-up derived from the graph are held to the reference's laws
(``perfbench/reference/laws.py``). The numbers, each against its limit in
``workloads/<cell>.json`` (a reading at or under its limit passes):

- ``loss_gap`` (reported, not compared: neither the control nor a fault
  moves it, PERF.md): the largest relative gap of the three updates'
  losses;
- ``grad_gap``: after the first update, the largest over the two tables of
  the gap between the program's and the reference's norms of the change,
  over the larger of the reference's norm of that table's change and the
  median table's (SGD: the change is the gradient times the rate);
- ``change_gap``: the same after three updates;
- ``step_diff``: the largest over the tables and the two readings (after
  one update, after three) of the norm of the DIFFERENCE of the program's
  and the reference's changes, over the same denominator;
- ``table_err``: the largest total-variation distance of a set-up table's
  law from the reference's;
- ``draw_z``: the largest |z| of the draws against their laws;
- ``miss``: draws and tables that break an exact property (a drawn pair
  that is no edge, a walk step off the graph, an init entry out of its
  range, ...);

and of the window's replays (``replay``: call ``k`` of the last job, a
replay of the captured call, and the same call run again eagerly from the
same tables and generator state with the reference's rates):

- ``replay_gap``: the largest over the two tables of the gap between the
  norms of the replay's change and of the reference's change on the eager
  call's draws, over the larger of that table's reference norm and the
  median table's;
- ``replay_diff``: the same with the norm of the difference of the two
  changes;
- ``replay_rng``: 1 where the generator's state after the eager call
  differs from its state after the replay, else 0;

and, reported and not compared, ``replay_noise``, the norm of the
difference of the reference's change in float32 and in float64 (same
denominator), and ``replay_excess``, the same norm for the replay over
``replay_noise``: how far the round-off of the kept call's steps is
amplified, which decides which call a cell keeps (PERF.md).

``readings(..., as_program=...)`` also gives the readings of the control
(the reference computed in TF32, put in the program's place) and of the
planted faults (an update that leaves the tables unchanged; half of each
batch left out, the mean taken over the rest), which set the limits;
``replay_numbers`` those of the replay's faults (``faults``).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from perfbench.harness.record import N_STEPS
from perfbench.reference import laws, sgns

SETUP = ("grad_gap", "change_gap", "step_diff", "table_err", "draw_z",
         "miss")
REPLAY = ("replay_gap", "replay_diff", "replay_rng")
NAMES = SETUP + REPLAY
LEAVES = ("vertex", "context")


def _apply(W: Dict[str, torch.Tensor], u: dict, half: bool) -> float:
    dev = W["vertex"].device
    src, pos, negs = (u[k].to(dev) for k in ("src", "pos", "negs"))
    if u["kind"] == "superstep":
        alphas = u["alphas"].to(dev).to(torch.float32)
        if half:
            b = src.shape[1] // 2
            src, pos, alphas = src[:, :b], pos[:, :b], alphas * 2
        return sgns.banded_superstep(W["vertex"], W["context"], src, pos,
                                     negs, alphas, u["k_equiv"])
    mask = None if u["mask"] is None else u["mask"].to(dev)
    alpha = u["alpha"]
    if half:
        b = src.shape[0] // 2
        src, pos, alpha = src[:b], pos[:b], alpha * 2
        mask = None if mask is None else mask[:b]
    return sgns.shared_negs_step(W["vertex"], W["context"], src, pos, negs,
                                 alpha, u["k_equiv"], mask)


def follow(rec, dev, tf32: bool = False, half: bool = False):
    """The reference's three updates from the program's starting tables:
    (losses, tables after one, tables after three)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        W = {k: rec.tables[0][k].to(dev).clone() for k in LEAVES}
        losses, w1 = [], None
        for i, u in enumerate(rec.updates[:N_STEPS]):
            losses.append(_apply(W, u, half))
            if i == 0:
                w1 = {k: v.clone() for k, v in W.items()}
        return losses, w1, W
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.to(torch.float64)))


def _gaps(w0, prog, ref):
    """(worst norm gap, worst norm of the difference) over the tables of
    the changes prog - w0 against ref - w0."""
    dp = {k: prog[k].to(torch.float64) - w0[k] for k in LEAVES}
    dr = {k: ref[k].to(torch.float64) - w0[k] for k in LEAVES}
    nr = {k: _norm(dr[k]) for k in LEAVES}
    med = sorted(nr.values())[len(nr) // 2] if len(nr) % 2 else (
        sum(nr.values()) / len(nr))
    gap = diff = 0.0
    for k in LEAVES:
        den = max(nr[k], med)
        if den == 0:
            continue
        gap = max(gap, abs(_norm(dp[k]) - nr[k]) / den)
        diff = max(diff, _norm(dp[k] - dr[k]) / den)
    return gap, diff


def step_numbers(w0, p_losses: List[float], p1, p3, r_losses, r1, r3):
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30)
                   for p, r in zip(p_losses, r_losses))
    g1, d1 = _gaps(w0, p1, r1)
    g3, d3 = _gaps(w0, p3, r3)
    return {"loss_gap": loss_gap, "grad_gap": g1, "change_gap": g3,
            "step_diff": max(d1, d3)}


def readings(rec, d: dict, L: laws.GraphLaws, fam, cell,
             as_program: str = "program") -> Dict[str, float]:
    """The numbers, with the program's outputs or, for ``as_program`` in
    "control", "unchanged", "half_batch", "faulty_draws", the control's or a
    planted fault's in their place."""
    dev = L.src.device
    if not rec.complete:
        raise RuntimeError(
            f"the output check recorded {len(rec.losses)} of {N_STEPS} "
            "updates: the program's update was not reached at the recorded "
            "boundary")
    w0 = {k: rec.tables[0][k].to(dev).to(torch.float64) for k in LEAVES}
    r_losses, r1, r3 = follow(rec, dev)

    def tables(i):
        return {k: rec.tables[i][k].to(dev) for k in LEAVES}

    if as_program == "control":
        p = follow(rec, dev, tf32=True)
    elif as_program == "half_batch":
        p = follow(rec, dev, half=True)
    elif as_program == "unchanged":
        p = (rec.losses, tables(0), tables(0))
    else:  # the program's own updates ("faulty_draws": its draws faulty)
        p = (rec.losses, tables(1), tables(3))
    out = step_numbers(w0, p[0], p[1], p[2], r_losses, r1, r3)
    miss, zs, tvs = fam.law_checks(rec, d, L, cell,
                                   fault=as_program == "faulty_draws")
    out["table_err"] = max(tvs.values()) if tvs else 0.0
    out["draw_z"] = max(abs(z) for z in zs.values()) if zs else 0.0
    out["miss"] = float(miss)
    out["detail"] = {"z": zs, "tv": tvs, "loss_gap": out["loss_gap"]}
    return out


def _follow_all(start, updates, dev, tf32: bool = False,
                dtype=torch.float32):
    """The reference's tables after ``updates`` from ``start``, computed
    in ``dtype``."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        W = {k: start[k].to(dev).to(dtype, copy=True) for k in LEAVES}
        for u in updates:
            _apply(W, u, False)
        return W
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def replay_numbers(probe, rec, dev,
                   as_program: str = "program") -> Dict[str, float]:
    """The replay's numbers: the reference follows the eager call's
    recorded updates (``rec``) from the tables the replay started from;
    with ``as_program`` "control" the reference in TF32 stands in the
    replay's place, with "unchanged" the tables it started from."""
    w0 = {k: probe.before[k].to(dev).to(torch.float64) for k in LEAVES}
    ref = _follow_all(probe.before, rec.updates, dev)
    if as_program == "control":
        prog = _follow_all(probe.before, rec.updates, dev, tf32=True)
    elif as_program == "unchanged":
        prog = probe.before
    else:
        prog = probe.after
    prog = {k: prog[k].to(dev) for k in LEAVES}
    gap, diff = _gaps(w0, prog, ref)
    exact = _follow_all(probe.before, rec.updates, dev, dtype=torch.float64)
    noise = _gaps(w0, ref, exact)[1]
    off = _gaps(w0, prog, exact)[1]
    excess = off / noise if noise > 0 else (0.0 if off == 0 else math.inf)
    same = torch.equal(probe.gen_eager, probe.gen_after)
    return {"replay_gap": gap, "replay_diff": diff, "replay_excess": excess,
            "replay_noise": noise, "replay_rng": 0.0 if same else 1.0}


def verdict(values: Dict[str, float], limits: Dict[str, float],
            names=NAMES):
    """(correct, [(name, value, limit)]): every number finite and at or
    under its limit."""
    rows = [(k, values[k], limits[k]) for k in names]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
