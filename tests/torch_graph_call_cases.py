"""The StepFns that TrainDriver captures as one CUDA graph a call: every
single-device LINE route and the families that train through
``PairModelBase._drive``, each as a small model and the ``train()``
arguments that take that route (a few calls of a few steps), and the
mesh modes' cases (``MESH_CASES``); ``CaptureGuard``, which fails on what
a capture cannot take.

Shared by tests/test_torch_graph_call.py (on the CPU: no host sync and no
data-dependent shape inside a call), tests/torch_parallel_worker.py (the
same for the mesh modes' calls on gloo ranks) and tests/test_torch_gpu.py
(on the card: captured against eager). Imports neither JAX nor smore_tpu.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from smore_tpu_torch import models
from smore_tpu_torch.graph.graph import Graph
from smore_tpu_torch.utils import oracle_data as od


class CaptureGuard(TorchDispatchMode):
    """Fails on an op a CUDA graph cannot capture: a host sync or an
    output whose shape depends on the data."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name.split("::")[-1]
        overload = func._overloadname
        flagged = (name in ("_local_scalar_dense", "nonzero", "masked_select")
                   or name.startswith("unique")
                   or name.startswith("_unique")
                   or (name == "repeat_interleave" and overload == "Tensor"
                       and kwargs.get("output_size") is None)
                   # a boolean index is a nonzero inside the op
                   or (name in ("index", "index_put", "index_put_",
                                "_index_put_impl_")
                       and any(t is not None and t.dtype == torch.bool
                               for t in args[1])))
        if flagged:
            raise AssertionError(f"{func} inside a call cannot be captured")
        return func(*args, **kwargs)


def toy_graph() -> Graph:
    """The 200-vertex 4-community graph of tests/test_torch_line_slice.py."""
    rng = np.random.default_rng(7)
    edges = []
    for _ in range(3000):
        c = rng.integers(0, 4)
        if rng.random() < 0.9:
            a, b = rng.integers(0, 50, 2) + 50 * c
        else:
            a, b = rng.integers(0, 200, 2)
        if a != b:
            edges.append((f"v{a}", f"v{b}", float(rng.integers(1, 4))))
    return Graph.from_edges(edges, undirected=True)


def walk_graph() -> Graph:
    """A weighted directed graph with dead ends (a fifth of the vertices
    have no out-edge)."""
    rng = np.random.default_rng(3)
    edges = [(f"v{a}", f"v{b}", float(rng.uniform(0.5, 3.0)))
             for a, b in rng.integers(0, 500, (4000, 2)) if a != b and a % 5]
    return Graph.from_edges(edges, undirected=False)


def field_graph() -> Graph:
    """A 200 x 300 user-item graph in two taste clusters, users field 0."""
    rng = np.random.default_rng(5)
    edges = [(f"u{u}", f"i{i}", 1.0) for u in range(200)
             for i in rng.choice(np.arange(u % 2, 300, 2), 12, replace=False)]
    g = Graph.from_edges(edges, undirected=True)
    g.fields = np.array([0 if nm[0] == "u" else 1 for nm in g.names],
                        np.int32)
    g.n_fields = 2
    return g


# LINE: (order, train() arguments, the kernel the card runs). Banded routes
# at band 64 on the 200-vertex graph; on the CPU each kernel's wrapper runs
# its plain twin, so the route's Python is the card's.
_BANDED = dict(banded=True, band_size=64)
LINE_ROUTES = {
    "line_multiblock": (2, dict(_BANDED, multiband=True, batch=128,
                                hoist=4), "sgns_banded_multiblock"),
    "line_neg_band": (2, dict(_BANDED, multiband=True, neg_band=True,
                              batch=128, hoist=4),
                      "sgns_banded_multiblock_nb"),
    "line_fused": (2, dict(_BANDED, multiband=False, use_pallas=True,
                           batch=128, hoist=4), "sgns_banded_fused"),
    "line_held_fused": (2, dict(_BANDED, multiband=False, use_pallas=True,
                                band_hold=True, batch=128, hoist=4),
                        "sgns_banded_fused"),
    "line_order1": (1, dict(_BANDED, use_pallas=True, batch=128, hoist=4),
                    "band_scatter_add"),
    # group 2 keeps order 2 off the fused route, on the CPU as on the card
    "line_scatter_o2": (2, dict(_BANDED, multiband=False, use_pallas=True,
                                group=2, batch=128, hoist=4),
                        "band_scatter_add"),
    "line_held_scatter": (2, dict(_BANDED, multiband=False, use_pallas=True,
                                  group=2, band_hold=True, batch=128,
                                  hoist=4), "band_scatter_add"),
    "line_unbanded_g8": (2, dict(banded=False, use_pallas=True, batch=1024,
                                 group=8, hoist=4), "sgns_shared_grads"),
    "line_unbanded_g1": (2, dict(banded=False, use_pallas=True, batch=1024,
                                 group=1), "sgns_shared_grads"),
    "line_unbanded_o1": (1, dict(banded=False, use_pallas=True, batch=1024,
                                 hoist=4), "sgns_shared_grads"),
}

# the families: model class, graph, init() and train() arguments
FAMILIES = {
    "MF": ("MF", walk_graph, {}, dict(sample_times=0.02, batch=256)),
    "BPR": ("BPR", walk_graph, {}, dict(sample_times=0.02, batch=256)),
    "WARP": ("WARP", walk_graph, {}, dict(sample_times=0.02, batch=256)),
    "SkewOPT": ("SkewOPT", walk_graph, {}, dict(sample_times=0.02,
                                                 batch=256)),
    "HOPREC": ("HOPREC", field_graph, {}, dict(sample_times=0.01,
                                               walk_steps=2, batch=256)),
    "HPE": ("HPE", walk_graph, {}, dict(sample_times=0.02, walk_steps=3,
                                        batch=256)),
    "PE": ("PE", walk_graph, {}, dict(sample_times=0.01, batch=256)),
    "NEMF": ("NEMF", field_graph, {}, dict(sample_times=0.01, walk_steps=2,
                                           batch=256)),
    "NERANK": ("NERANK", field_graph, {}, dict(sample_times=0.01,
                                               walk_steps=2, batch=256)),
    "GCN": ("GCN", field_graph, {}, dict(sample_times=0.01, walk_steps=2,
                                         batch=256)),
    "TEXTGCNdev": ("TEXTGCNdev", field_graph, {},
                   dict(sample_times=0.01, num_events=2, num_words=2,
                        batch=256)),
    "ECO": ("ECO", field_graph, {}, dict(sample_times=0.01, batch=256)),
    "FINE": ("FINE", field_graph, {}, dict(sample_times=0.01, walk_steps=2,
                                           batch=256)),
    # the walk family: one epoch a call on these graphs
    "DeepWalk": ("DeepWalk", walk_graph, {},
                 dict(walk_times=3, walk_steps=10)),
    "Node2Vec": ("Node2Vec", walk_graph, {},
                 dict(walk_times=3, walk_steps=8)),
    "APP": ("APP", walk_graph, {}, dict(walk_times=1, sample_times=3)),
}
TYPED = ("SNE", "CPR", "TPR", "Metapath2Vec", "CTDNE")
CASES = sorted(LINE_ROUTES) + sorted(FAMILIES) + list(TYPED)

def build(name: str, device, tmp: str, dim: int = 16):
    """(model with fresh tables on ``device``, train() arguments) of a
    case: several calls of a few steps."""
    run = dict(steps_per_call=4, verbose=False)
    if name in LINE_ROUTES:
        order, kw, _ = LINE_ROUTES[name]
        m = models.LINE(toy_graph(), seed=0, device=device)
        m.init(dim=64, order=order)  # the multiblock route takes dim % 64
        return m, dict(run, sample_times=0.02, steps_per_call=16, **kw)
    if name in FAMILIES:
        cls, graph, init_kw, kw = FAMILIES[name]
        m = getattr(models, cls)(graph(), seed=0, device=device)
        m.init(dim=dim, **init_kw)
        return m, dict(run, **kw)
    cls = getattr(models, name)
    if name == "SNE":
        m = cls.load_edge_list(od.make_signed(f"{tmp}/s.txt", per=60,
                                              pos_e=2000, neg_e=600),
                               undirected=False, device=device)
        kw = dict(epochs=1, batch=128)
    elif name == "CPR":
        od.make_two_domains(f"{tmp}/t.txt", f"{tmp}/s.txt", users=60,
                            items_t=40, items_s=40)
        m = cls.load_domains(f"{tmp}/t.txt", f"{tmp}/s.txt", device=device)
        kw = dict(update_times=0.005)
    elif name == "TPR":
        od.make_text_rec(f"{tmp}/ui.txt", f"{tmp}/iw.txt", users=60,
                         items=48, words=24)
        m = cls.load_graphs(f"{tmp}/ui.txt", f"{tmp}/iw.txt", device=device)
        kw = dict(sample_times=0.005)
    elif name == "CTDNE":
        m = cls.load_edge_list(od.make_temporal(f"{tmp}/t.txt", per=30,
                                                edges=2000),
                               time_window=20.0, device=device)
        kw = dict(walk_times=15, walk_steps=6)  # 64 batches of 8 a step
    else:
        m = cls.load_edge_list(od.make_hetero(f"{tmp}/h.txt", topics=2,
                                              authors_pt=20, papers_pt=30),
                               device=device)
        for mp in od.RUNS["han"]["meta_paths"]:
            m.add_meta_path(mp)
        kw = dict(walk_times=15, walk_steps=6)
    m.init(dim=dim)
    return m, dict(run, **kw)


# the mesh modes: a case of ``build``, its sharding, its train()
# arguments on a mesh ("dp" takes one batch a step; the rec family trains
# "dp" only, and takes no ``sharding``) and the kernel the card runs; each
# several calls at one rank and at two
MESH_CASES = {
    "line_dp": ("line_unbanded_g8", "dp", dict(sharding="dp", hoist=1),
                "sgns_shared_grads"),
    "line_rows": ("line_unbanded_g8", "rows", dict(sharding="rows"),
                  "sgns_shared_grads"),
    "line_hogwild": ("line_multiblock", "hogwild",
                     dict(sharding="hogwild"), "sgns_banded_multiblock"),
    "deepwalk_rows": ("DeepWalk", "rows", dict(sharding="rows",
                                               walk_times=1), None),
    "bpr_dp": ("BPR", "dp", {}, None),
}


def build_mesh(name: str, device, tmp: str, mesh):
    """(model with fresh tables on ``device``, train() arguments) of a
    mesh case on ``mesh``."""
    case, _, kw, _ = MESH_CASES[name]
    m, run = build(case, device, tmp)
    return m, dict(run, mesh=mesh, **kw)


# ------------------------------------------- the models with their own loops
# (KG, HAN, the SASRec family): a few epochs of a few steps each; a call is
# an epoch's steps (steps_per_call None) or, given steps_per_call, calls of
# that many steps and a shorter last one
OWN_LOOP = ("TransE", "RotatE", "ComplEx", "HAN", "SASRec", "GSASRec",
            "RecDenoiser")
SEQ = ("SASRec", "GSASRec", "RecDenoiser")
# calls of this many steps and a shorter last one: KG 4 + 2, HAN 3 + 1,
# the SASRec family 3 + 1
OWN_LOOP_CHUNK = {"TransE": 4, "RotatE": 4, "ComplEx": 4, "HAN": 3,
                  "SASRec": 3, "GSASRec": 3, "RecDenoiser": 3}


def seq_edges(path: str, users: int = 40, items: int = 15) -> str:
    """User -> item edges in file order, 1-13 a user (some users under 2
    items, some cut to the sequence length)."""
    rng = np.random.default_rng(9)
    with open(path, "w") as f:
        f.writelines(f"u{u} i{rng.integers(0, items)} 1\n"
                     for u in range(users)
                     for _ in range(int(rng.integers(1, 14))))
    return path


def build_own_loop(name: str, device, tmp: str, dim: int = 16,
                   steps_per_call=None, epochs: int = 3):
    """(model with fresh tables on ``device``, train() arguments): TransE
    6 steps an epoch, HAN 4, the SASRec family 4."""
    kw = dict(epochs=epochs, verbose=False)
    if name in ("TransE", "RotatE", "ComplEx"):
        m = getattr(models, name).load_triples(
            od.make_kg(f"{tmp}/kg.txt", n_clusters=2, per=20, n_rel=2,
                       triples_per_rel=100), seed=0, device=device)
        m.init(dim=dim)
        kw.update(batch=32, alpha=0.02)
    elif name == "HAN":
        m = models.HAN.load_edge_list(od.make_hetero(
            f"{tmp}/h.txt", topics=2, authors_pt=20, papers_pt=30),
            seed=0, device=device)
        for mp in od.RUNS["han"]["meta_paths"]:
            m.add_meta_path(mp)
        m.init(dim=dim, learning_rate=0.05)
        kw.update(batch=32, walk_times=3, walk_steps=4)
    else:
        m = getattr(models, name).load_edge_list(
            seq_edges(f"{tmp}/seq.txt"), seed=0, negative_samples=3,
            device=device)
        m.init(dim=dim, max_seq_len=8, num_blocks=2, num_heads=2,
               dropout=0.2)
        kw.update(batch_size=8, alpha=0.01)
    m.steps_per_call = steps_per_call
    return m, kw


def own_loop_state(m) -> dict:
    """The trained tables, or the network's parameters and buffers."""
    if hasattr(m, "net"):
        return dict(m.net.state_dict())
    return dict(m.state)


def optax_adam(params: dict, grads: dict, alpha: float, steps: int) -> dict:
    """``optax.adam(alpha)`` (b1 0.9, b2 0.999, eps 1e-8) in float32 numpy:
    ``params`` after ``steps`` updates that each take the same ``grads``
    ({name: array} both). Held to optax.adam itself in
    tests/test_torch_sasrec.py, so that the card's optimiser can be held to
    it where JAX is not installed."""
    f, b1, b2 = np.float32, 0.9, 0.999
    out = {}
    for k, p in params.items():
        p, g = np.asarray(p, f), np.asarray(grads[k], f)
        mu, nu = np.zeros_like(p), np.zeros_like(p)
        for t in range(1, steps + 1):
            mu = f(1 - b1) * g + f(b1) * mu
            nu = f(1 - b2) * (g * g) + f(b2) * nu
            # the bias corrections in float32, as optax computes them
            c1, c2 = f(1) - f(b1) ** f(t), f(1) - f(b2) ** f(t)
            upd = (mu / c1) / (np.sqrt(nu / c2) + f(1e-8))
            p = p + upd * f(-alpha)
        out[k] = p
    return out
