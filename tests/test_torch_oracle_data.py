"""The port's copy of the knowledge-graph and typed-graph quality sets and
evaluations (smore_tpu_torch/utils/oracle_data.py) against
experiments/go_oracle_parity.py: the same files byte for byte from the same
seeds, the same held-out pairs, and the same scores of the same tables
(exactly: the same numpy operations in the same order)."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from smore_tpu_torch.graph.graph import Graph
from smore_tpu_torch.utils import oracle_data as od

# one intra-op thread, as in every port test file: test workers share the
# cores
torch.set_num_threads(1)

EXPERIMENTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "experiments")


@pytest.fixture(scope="module")
def gp():
    """experiments/go_oracle_parity.py as a module."""
    if EXPERIMENTS not in sys.path:
        sys.path.insert(0, EXPERIMENTS)
    spec = importlib.util.spec_from_file_location(
        "_go_oracle_parity", os.path.join(EXPERIMENTS,
                                          "go_oracle_parity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["make_kg", "make_signed", "make_temporal",
                                  "make_hetero", "make_community"])
def test_one_file_sets_byte_equal(gp, name, tmp_path):
    theirs, ours = str(tmp_path / "theirs.txt"), str(tmp_path / "ours.txt")
    getattr(gp, name)(theirs)
    getattr(od, name)(ours)
    assert open(ours, "rb").read() == open(theirs, "rb").read()


@pytest.mark.parametrize("name", ["make_two_domains", "make_text_rec"])
def test_two_file_sets_byte_equal(gp, name, tmp_path):
    theirs = [str(tmp_path / f"theirs{i}.txt") for i in range(2)]
    ours = [str(tmp_path / f"ours{i}.txt") for i in range(2)]
    tu, ti = getattr(gp, name)(*theirs)
    ou, oi = getattr(od, name)(*ours)
    assert np.array_equal(ou, tu) and np.array_equal(oi, ti)
    for a, b in zip(ours, theirs):
        assert open(a, "rb").read() == open(b, "rb").read()


def test_make_community_keeps_an_existing_file(tmp_path):
    p = tmp_path / "c.txt"
    p.write_text("x y 1\n")
    assert od.make_community(str(p)) == str(p)
    assert p.read_text() == "x y 1\n"


def test_kg_rank_eval_and_scorers(gp, tmp_path):
    from smore_tpu_torch.graph.knowledge import KnowledgeGraph

    kg = KnowledgeGraph.load_triples(od.make_kg(str(tmp_path / "kg.txt"),
                                                n_clusters=4, per=20,
                                                n_rel=2, triples_per_rel=300))
    rng = np.random.default_rng(0)
    cd = 4
    for model in ("transe", "rotate", "complex"):
        width = 8 if model != "transe" else 4
        st = {"entity": rng.standard_normal((kg.n_entities, width)),
              "relation": rng.standard_normal((kg.n_relations, 8 if model ==
                                               "complex" else 4))}
        sc = od.kg_scorer(model, st, cd)
        want = gp.kg_rank_eval(sc, kg.heads, kg.relations, kg.tails,
                               kg.n_entities)
        assert od.kg_mrr(model, st, kg, cd) == want
        h, r, t = kg.heads[:5], kg.relations[:5], kg.tails[:5]
        e, rl = st["entity"], st["relation"]
        if model == "transe":
            ref = -np.linalg.norm(e[h] + rl[r] - e[t], axis=-1)
        elif model == "rotate":  # |h o r - t| with r = exp(i phase)
            z = lambda x: x[:, :cd] + 1j * x[:, cd:]  # noqa: E731
            ref = -np.sqrt((np.abs(z(e[h]) * np.exp(1j * rl[r]) - z(e[t]))
                            ** 2).sum(-1))
        else:  # Re<h, r, conj(t)>
            z = lambda x: x[:, :cd] + 1j * x[:, cd:]  # noqa: E731
            ref = (z(e[h]) * z(rl[r]) * np.conj(z(e[t]))).real.sum(-1)
        np.testing.assert_allclose(sc(h, r, t), ref, rtol=1e-10)


def test_auc_and_community_auc(gp):
    rng = np.random.default_rng(1)
    pos, neg = rng.random(300), rng.random(200) - 0.1
    pos[:10] = neg[:10]  # ties count one half
    assert od.auc(pos, neg) == gp.auc(pos, neg)
    emb = rng.standard_normal((120, 8))
    labels = rng.integers(0, 4, 120)
    assert od.community_auc_emb(emb, labels) == gp.community_auc_emb(
        emb, labels)


def test_probes_of_the_runs(gp, tmp_path):
    """The label rules of run_ctdne, run_mp2v / run_han and run_fastrp, and
    run_sne's sign AUC."""
    from smore_tpu_torch.graph.hetero import HeteroGraph
    from smore_tpu_torch.graph.signed import SignedNetwork
    from smore_tpu_torch.graph.temporal import TemporalGraph

    tg = TemporalGraph.load_edge_list(od.make_temporal(str(tmp_path /
                                                           "t.txt")))
    assert np.array_equal(od.temporal_labels(tg.names),
                          np.array([int(nm[1:]) // 150 for nm in tg.names]))
    hg = HeteroGraph.load_edge_list(od.make_hetero(str(tmp_path / "h.txt")))
    labels, rows = od.author_labels(hg.names)
    assert len(rows) == 480 and labels.max() == 5
    assert all(hg.names[v] == f"a{int(hg.names[v][1:])}" and labels[v] ==
               int(hg.names[v][1:]) // 80 for v in rows)
    emb = np.random.default_rng(2).standard_normal((hg.n_vertices, 8))
    assert od.author_auc(hg.names, emb) == gp.community_auc_emb(
        emb[rows], labels[rows])
    g = Graph.load_edge_list(od.make_community(str(tmp_path / "c.txt")))
    assert np.array_equal(od.community_labels(g.names),
                          np.array([int(nm[1:]) // 200 for nm in g.names]))
    net = SignedNetwork.load_edge_list(od.make_signed(str(tmp_path /
                                                          "s.txt")),
                                       undirected=False)
    s, t = (np.random.default_rng(i).standard_normal((net.n_vertices, 4))
            for i in (3, 4))
    assert od.sign_auc(net, s, t) == gp.auc(
        (s[net.pos_src] * t[net.pos_dst]).sum(1),
        (s[net.neg_src] * t[net.neg_dst]).sum(1))


def test_cpr_and_tpr_evals(gp, tmp_path):
    tp, sp = str(tmp_path / "t.txt"), str(tmp_path / "s.txt")
    tu, ti = od.make_two_domains(tp, sp)
    g_t, g_s = Graph.load_edge_list(tp), Graph.load_edge_list(sp)
    rng = np.random.default_rng(5)
    user, tgt = (rng.standard_normal((g_t.n_vertices, 8)) for _ in range(2))
    s_of_t = np.array([g_s.name2id.get(nm, -1) for nm in g_t.names],
                      dtype=np.int64)
    tu_v = np.array([g_t.name2id[f"u{u}"] for u in tu])
    ti_v = np.array([g_t.name2id[f"t{i}"] for i in ti])
    want = gp._cpr_eval(user, tgt, g_t, g_s, s_of_t, tu_v, ti_v)
    assert od.cpr_eval(user, tgt, g_t, g_s, s_of_t, tu_v, ti_v) == want
    # the model's rows are mapped by name: the identity map here
    assert od.cpr_auc(g_t, g_s, tu, ti, user, tgt, g_t.name2id) == want

    up, ip = str(tmp_path / "ui.txt"), str(tmp_path / "iw.txt")
    tu, ti = od.make_text_rec(up, ip)
    g_ui, g_iw = Graph.load_edge_list(up), Graph.load_edge_list(ip)
    user, item = (rng.standard_normal((g_ui.n_vertices, 8))
                  for _ in range(2))
    word = rng.standard_normal((g_iw.n_vertices, 8))
    ui2iw = np.array([g_iw.name2id.get(nm, -1) for nm in g_ui.names],
                     dtype=np.int64)
    tu_v = np.array([g_ui.name2id[f"u{u}"] for u in tu])
    ti_v = np.array([g_ui.name2id[f"i{i}"] for i in ti])
    want = gp._tpr_eval(user, item, word, g_ui, g_iw, ui2iw, tu_v, ti_v, 0.5)
    assert od.tpr_eval(user, item, word, g_ui, g_iw, ui2iw, tu_v, ti_v,
                       0.5) == want
    # run_tpr keeps only the w* rows of the word table
    word_w = np.where(np.array([nm.startswith("w") for nm in g_iw.names])[
        :, None], word, 0.0)
    want_w = gp._tpr_eval(user, item, word_w, g_ui, g_iw, ui2iw, tu_v, ti_v,
                          0.5)
    assert od.tpr_auc(g_ui, g_iw, tu, ti, user, item, word, g_ui.name2id,
                      g_iw.name2id, 0.5) == want_w
