"""LINE jobs: ``LINE(graph).init(...)`` then ``train(...)`` with the
configuration's settings, everything else ``LINE.train``'s defaults (which
route the graph: the banded multiblock route, kernel K4, from 262,144
vertices on the card; the unbanded route below)."""

from __future__ import annotations

import torch

from perfbench.harness import record
from perfbench.harness.flops import sgns_flops
from perfbench.reference import laws

WORK = "samples"


def build(graph, seed: int, cell, device):
    from smore_tpu_torch.models.line import LINE

    return LINE(graph, seed=seed, device=device)


def job(model, cell, budget: dict) -> None:
    model.init(**cell.config["init"])
    model.train(**cell.config["train"], **budget, verbose=False)


def hooks(rec: record.Recorder) -> None:
    from smore_tpu_torch.models import line

    rec.patch(line, "multiblock_apply", record.multiblock_wrapper(rec))
    rec.patch(line, "sgns_shared_negs_step", record.shared_negs_wrapper(rec))


def derived(model) -> dict:
    """What set-up derived from the graph and the draws read, as the
    route that trained used it."""
    bt = model.banded_tables
    if bt is not None:
        return {"route": "banded", "band_pa": bt.band_pa,
                "neg_pa": bt.neg_pa, "stream": bt.stream,
                "stream_meta": bt.stream_meta, "band_size": bt.band_size,
                "n_bands": bt.n_bands}
    t = model.tables
    return {"route": "unbanded", "edge_pa": t.edge_pa, "ctx_pa": t.ctx_pa,
            "vert_meta": t.vert_meta, "neg_pa": t.neg_pa}


def flops(cell, work: float) -> float:
    return sgns_flops(work, cell.config["assumed"]["shared_negatives"],
                      cell.config["init"]["dim"])


def law_checks(rec, d: dict, L: laws.GraphLaws, cell, fault: bool = False):
    """(exact misses, z-scores, table distances) of the set-up's tables
    and the recorded draws; ``fault``: the readings of the planted faults
    instead (uniform negatives, a negative table of power 1)."""
    if fault:
        return law_faults(rec, L)
    miss, zs, tvs = init_checks(rec, L, cell.config["init"]["dim"])
    ups = [u for u in rec.updates if not u["repeat"]]
    tvs["negatives"] = laws.tv(
        laws.alias_implied(d["neg_pa"][:, 0], d["neg_pa"][:, 1])[:L.n],
        L.negative)
    negs = torch.cat([u["negs"].reshape(-1) for u in ups]).to(L.src.device)
    put(zs, "negatives", L.z_law(negs, L.negative))
    src = torch.cat([u["src"].reshape(-1) for u in ups]).to(L.src.device)
    pos = torch.cat([u["pos"].reshape(-1) for u in ups]).to(L.src.device)
    miss += L.not_edges(src, pos)
    if d["route"] == "banded":
        m, z, t = stream_checks(d, L)
        miss += m
        zs.update(z)
        tvs.update(t)
    else:
        miss += table_meta_miss(d["vert_meta"], L)
        tvs["contexts"] = context_tv(d["ctx_pa"], d["vert_meta"], L)
        tvs["pairs"] = edge_table_tv(d["edge_pa"], L)
        g = ups[0]["src_group"]
        sg = src.reshape(-1, g)
        miss += int((sg != sg[:, :1]).sum())
        put(zs, "sources", L.z_law(sg[:, 0], L.source))
        put(zs, "contexts", L.z_next(src, pos))
    return miss, zs, tvs


def put(zs: dict, name: str, by_probe: dict) -> None:
    zs.update({f"{name}.{k}": v for k, v in by_probe.items()})


def law_faults(rec, L: laws.GraphLaws):
    """The law numbers of two planted faults: the recorded count of
    negatives drawn by the law restricted to the first half of the vertex
    ids (a draw that reaches half the table), and a negative table of the
    law at power 1 in place of 0.75."""
    n_negs = sum(u["negs"].numel() for u in rec.updates if not u["repeat"])
    g = torch.Generator(device=L.src.device)
    g.manual_seed(1)
    half = torch.multinomial(L.negative[:L.n // 2], n_negs, replacement=True,
                             generator=g)
    zs = {}
    put(zs, "negatives", L.z_law(half, L.negative))
    wrong = laws.law(L.out_w + L.in_w)
    return 0, zs, {"negatives": laws.tv(wrong, L.negative)}


def init_checks(rec, L: laws.GraphLaws, dim: int):
    """The start: the vertex table U(-0.5, 0.5) / dim on the graph's rows
    (zero on padding rows), the context table zero."""
    t0 = rec.tables[0]
    v = t0["vertex"].to(L.src.device)
    real = v[:L.n].to(laws.F64)
    h = 0.5 / dim
    miss = int(((real < -h) | (real >= h)).sum())
    miss += int((v[L.n:] != 0).sum()) + int((t0["context"] != 0).sum())
    mean, var = laws.init_moments(dim)
    z = laws.z_score(float((real - mean).sum()), real.numel() * var)
    return miss, {"init.mean": z}, {}


def table_meta_miss(vert_meta, L: laws.GraphLaws) -> int:
    """[indptr, degree] of every vertex against the graph's slot counts."""
    deg = L.out_slots
    indptr = torch.cumsum(deg, 0) - deg
    vm = vert_meta.to(L.src.device).long()
    return int((vm[:, 1] != deg).sum()) + int((vm[:, 0] != indptr).sum())


def context_tv(ctx_pa, vert_meta, L: laws.GraphLaws) -> float:
    """The largest distance, over source vertices, of the context law that
    the per-vertex tables draw from the reference's."""
    dev = L.src.device
    ctx = ctx_pa.to(dev).to(laws.F64)
    vm = vert_meta.to(dev).long()
    deg = vm[:, 1]
    owner = torch.repeat_interleave(torch.arange(L.n, device=dev), deg)
    prob = ctx[:, 0]
    d = deg[owner].to(laws.F64)
    keys_a = torch.cat([owner * L.n + ctx[:, 1].long(),
                        owner * L.n + ctx[:, 2].long()])
    mass_a = torch.cat([prob / d, (1.0 - prob) / d])
    seg_a = torch.cat([owner, owner])
    return laws.segment_tv_max(seg_a, keys_a, mass_a, L.src,
                               L.src * L.n + L.dst, L.ctx_mass, L.n)


def edge_table_tv(edge_pa, L: laws.GraphLaws) -> float:
    """Distance of the pair law that the joint edge table draws from the
    reference's."""
    e = edge_pa.to(L.src.device).to(laws.F64)
    n_slots = e.shape[0]
    keys_a = torch.cat([e[:, 1].long() * L.n + e[:, 2].long(),
                        e[:, 3].long() * L.n + e[:, 4].long()])
    mass_a = torch.cat([e[:, 0], 1.0 - e[:, 0]]) / n_slots
    return laws.keyed_tv(keys_a, mass_a, L.src * L.n + L.dst, L.slot_mass)


def stream_checks(d: dict, L: laws.GraphLaws, chunk: int = 1 << 24):
    """The band strata's table and the pre-drawn edge stream: every entry
    an edge of its stratum, its source and context by the stratum's law."""
    dev = L.src.device
    band, nb = d["band_size"], d["n_bands"]
    strat = (L.src // band) * nb + L.dst // band
    n_strata = nb * nb
    mass = torch.zeros(n_strata, dtype=laws.F64, device=dev).index_add_(
        0, strat, L.slot_mass)
    bp = d["band_pa"].to(dev)
    tvs = {"strata": laws.tv(laws.alias_implied(bp[:, 0], bp[:, 1]), mass)}
    safe = torch.where(mass > 0, mass, torch.ones_like(mass))
    moments = {}
    for side, ids in (("src", L.src), ("pos", L.dst)):
        for probe, fp in L.probes.items():
            f = fp[ids]
            m1 = torch.zeros(n_strata, dtype=laws.F64,
                             device=dev).index_add_(
                0, strat, L.slot_mass * f) / safe
            m2 = torch.zeros(n_strata, dtype=laws.F64,
                             device=dev).index_add_(
                0, strat, L.slot_mass * f * f) / safe
            moments[f"stream_{side}.{probe}"] = (
                side, probe, m1, torch.clamp(m2 - m1 * m1, min=0.0))
    stream = d["stream"].to(dev)
    meta = d["stream_meta"].to(dev).long()
    ends = meta[:, 0] + meta[:, 1]
    miss = 0
    dev_sum = dict.fromkeys(moments, 0.0)
    var_sum = dict.fromkeys(moments, 0.0)
    for a in range(0, stream.numel(), chunk):
        idx = torch.arange(a, min(a + chunk, stream.numel()), device=dev)
        sid = torch.searchsorted(ends, idx, right=True)
        e = stream[idx].long()
        ids = {"src": (sid // nb) * band + (e >> 16),
               "pos": (sid % nb) * band + (e & 0xFFFF)}
        miss += L.not_edges(ids["src"], ids["pos"])
        for key, (side, probe, m1, var) in moments.items():
            f = L.probes[probe][ids[side].clamp(max=L.n - 1)]
            dev_sum[key] += float((f - m1[sid]).sum())
            var_sum[key] += float(var[sid].sum())
    zs = {k: laws.z_score(dev_sum[k], var_sum[k]) for k in moments}
    return miss, zs, tvs
