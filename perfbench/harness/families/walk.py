"""DeepWalk jobs: ``DeepWalk(graph).init(dim)`` then ``train(...)`` with
the configuration's settings, everything else ``DeepWalk.train``'s
defaults (batches of 128 walks, a shared pool of 256 negatives, the masked
plain update; epoch-exact starts on graphs of at most 131,072 vertices)."""

from __future__ import annotations

import torch

from perfbench.harness import record
from perfbench.harness.families import line as line_family
from perfbench.harness.flops import sgns_flops
from perfbench.reference import laws

WORK = "walks"


def build(graph, seed: int, cell, device):
    from smore_tpu_torch.models.deepwalk import DeepWalk

    return DeepWalk(graph, seed=seed, device=device)


def job(model, cell, budget: dict) -> None:
    model.init(**cell.config["init"])
    model.train(**cell.config["train"], **budget, verbose=False)


def hooks(rec: record.Recorder) -> None:
    from smore_tpu_torch.models import deepwalk, walk_base

    rec.patch(walk_base, "sgns_shared_negs_step",
              record.shared_negs_wrapper(rec))
    rec.patch(deepwalk, "random_walk", record.walk_wrapper(rec))


def derived(model) -> dict:
    t = model.tables
    return {"route": "walk", "ctx_pa": t.ctx_pa, "vert_meta": t.vert_meta,
            "neg_pa": t.neg_pa}


def _shape(cell):
    tr = cell.config["train"]
    return tr["walk_steps"] + 1, tr["window_size"]


def flops(cell, work: float) -> float:
    """The SGNS operations of ``work`` walks: their expected skip-gram
    pairs, each against the shared pool."""
    pairs = work * laws.window_count_moments(*_shape(cell))[0]
    return sgns_flops(pairs, cell.config["assumed"]["shared_negatives"],
                      cell.config["init"]["dim"])


def law_checks(rec, d: dict, L: laws.GraphLaws, cell, fault: bool = False):
    if fault:
        return line_family.law_faults(rec, L)
    dev = L.src.device
    miss, zs, tvs = line_family.init_checks(rec, L, cell.config["init"]["dim"])
    miss += line_family.table_meta_miss(d["vert_meta"], L)
    tvs["contexts"] = line_family.context_tv(d["ctx_pa"], d["vert_meta"], L)
    tvs["negatives"] = laws.tv(
        laws.alias_implied(d["neg_pa"][:, 0], d["neg_pa"][:, 1])[:L.n],
        L.negative)
    length, window = _shape(cell)
    # the walks: each step along an edge, by the context law
    walks = torch.cat([w.to(dev) for w in rec.walks])
    miss += L.not_edges(walks[:, :-1], walks[:, 1:])
    line_family.put(zs, "walk_steps", L.z_next(walks[:, :-1], walks[:, 1:]))
    if cell.traffic["walk_starts"] == "epoch":
        # the first draw of walks is an epoch: a walk from every vertex
        starts = rec.walks[0][:, 0].to(dev).long()
        miss += L.n - int(torch.unique(starts[starts < L.n]).numel())
    else:
        line_family.put(zs, "starts", L.z_law(walks[:, 0], torch.full(
            (L.n,), 1.0 / L.n, dtype=laws.F64, device=dev)))
    # the pairs: each a pair of one walk inside the window, their number
    # by the U{1..window} window law
    ups = [u for u in rec.updates if not u["repeat"]]
    keys = laws.window_pair_keys(walks, window, L.n)
    mean, var = laws.window_count_moments(length, window)
    count = 0.0
    n_walks = 0
    for u in ups:
        m = u["mask"].to(dev) > 0
        s, p = u["src"].to(dev).long()[m], u["pos"].to(dev).long()[m]
        miss += laws.missing(keys, s * L.n + p)
        count += float(m.sum())
        # the mapper's dense (walks, length, 2 window) grid of slots
        n_walks += m.numel() // (length * 2 * window)
    zs["pairs.count"] = laws.z_score(count - n_walks * mean, n_walks * var)
    negs = torch.cat([u["negs"].reshape(-1) for u in ups]).to(dev)
    line_family.put(zs, "negatives", L.z_law(negs, L.negative))
    return miss, zs, tvs
