"""The seeded sets, evaluations and run settings of the knowledge-graph and
typed-graph quality gates (numpy only).

The port's own copy of ``experiments/go_oracle_parity.py``'s generators
(``make_kg``, ``make_signed``, ``make_temporal``, ``make_hetero``,
``make_two_domains``, ``make_text_rec``, ``make_community``) and
evaluations (``kg_rank_eval``, ``auc``, ``community_auc_emb``,
``_cpr_eval``, ``_tpr_eval``, and the probes of ``run_sne``,
``run_ctdne``, ``run_mp2v``, ``run_han``, ``run_kg`` and ``run_fastrp``),
so that the port's smoke test depends on nothing of the JAX package. The
copy is held to the originals by tests/test_torch_oracle_data.py: the same
seeds write the same files, the same tables score the same.

``RUNS`` holds the training settings of each ``run_*`` of that script
(its budgets and rates); the gates train at ``DIM`` = 64, the CLIs'
``-dimensions`` default, where the script trains at 32.
"""

from __future__ import annotations

import os

import numpy as np

SEED = 5
DIM = 64  # the CLIs' -dimensions default

# go_oracle_parity's run settings, model by model
RUNS = {
    "kg": dict(epochs=30, batch=1024, alpha=0.01),
    "sne": dict(epochs=8, samples_per_edge=1, alpha=0.025, beta=1.0,
                negative_samples=5),
    "ctdne": dict(walk_times=16, walk_steps=20, window_size=5,
                  negative_samples=5, alpha=0.025, time_window=20.0),
    "metapath2vec": dict(walk_times=200, walk_steps=16, window_size=5,
                         negative_samples=5, alpha=0.025,
                         meta_paths=[["author", "paper", "author"]]),
    "han": dict(walk_times=5, walk_steps=4, epochs=40, learning_rate=0.05,
                meta_paths=[["author", "paper", "author"],
                            ["author", "paper", "venue", "paper",
                             "author"]]),
    "cpr": dict(update_times=0.6, alpha=0.1),
    "tpr": dict(sample_times=0.6, alpha=0.025, text_weight=0.5),
    "fastrp": dict(iterations=3, seeds=(42, 1, 2, 3, 4)),
}
# the members of one group, in the order of their numbered names
TEMPORAL_PER_COMM = 150
AUTHORS_PER_TOPIC = 80
COMMUNITY_PER = 200


# --------------------------------------------------------------------- #
# datasets (seeded synthetics shaped for each family's structure)
# --------------------------------------------------------------------- #
def make_kg(path, n_clusters=12, per=100, n_rel=6, triples_per_rel=3500):
    """Entities in clusters; relation r links cluster c -> (c+r+1)%12.
    A model that learns the relational geometry ranks true tails high."""
    rng = np.random.default_rng(SEED)
    lines = []
    for r in range(n_rel):
        h = rng.integers(0, n_clusters * per, triples_per_rel)
        hc = h // per
        tc = (hc + r + 1) % n_clusters
        t = tc * per + rng.integers(0, per, triples_per_rel)
        for hh, tt in zip(h, t):
            lines.append(f"e{hh} r{r} e{tt}\n")
    with open(path, "w") as f:
        f.writelines(lines)
    return path


def make_signed(path, camps=3, per=400, pos_e=24000, neg_e=8000):
    rng = np.random.default_rng(SEED)
    lines = []
    for _ in range(pos_e):
        c = rng.integers(0, camps)
        a, b = c * per + rng.integers(0, per, 2)
        if a != b:
            lines.append(f"v{a} v{b} +1\n")
    for _ in range(neg_e):
        c1 = rng.integers(0, camps)
        c2 = (c1 + 1 + rng.integers(0, camps - 1)) % camps
        a = c1 * per + rng.integers(0, per)
        b = c2 * per + rng.integers(0, per)
        lines.append(f"v{a} v{b} -1\n")
    with open(path, "w") as f:
        f.writelines(lines)
    return path


def make_temporal(path, comms=4, per=TEMPORAL_PER_COMM, edges=20000,
                  horizon=100.0):
    """Intra-community edges spread over [0, horizon); walks that follow
    time stay inside a community."""
    rng = np.random.default_rng(SEED)
    lines = []
    for _ in range(edges):
        c = rng.integers(0, comms)
        a, b = c * per + rng.integers(0, per, 2)
        if a == b:
            continue
        t = rng.random() * horizon
        lines.append(f"n{a} n{b} {t:.3f}\n")
    with open(path, "w") as f:
        f.writelines(lines)
    return path


def make_hetero(path, topics=6, authors_pt=AUTHORS_PER_TOPIC, papers_pt=120,
                venues_pt=2):
    """Author-paper-venue per topic; APA walks stay intra-topic."""
    rng = np.random.default_rng(SEED)
    lines = []
    for c in range(topics):
        for a in range(authors_pt):
            an = f"a{c * authors_pt + a}"
            for p in rng.choice(papers_pt, 5, replace=False):
                lines.append(
                    f"{an} author p{c * papers_pt + p} paper writes\n"
                )
        for p in range(papers_pt):
            v = c * venues_pt + rng.integers(0, venues_pt)
            lines.append(
                f"p{c * papers_pt + p} paper v{v} venue published_at\n"
            )
    with open(path, "w") as f:
        f.writelines(lines)
    return path


def make_two_domains(t_path, s_path, users=300, items_t=200, items_s=200,
                     clusters=6, per_user=12):
    """Shared users, cluster-consistent tastes in BOTH domains; the last
    2 target interactions per user are held out for eval."""
    rng = np.random.default_rng(SEED)
    test_u, test_i = [], []
    with open(t_path, "w") as ft, open(s_path, "w") as fs:
        for u in range(users):
            c = u % clusters
            own_t = np.arange(c, items_t, clusters)
            own_s = np.arange(c, items_s, clusters)
            picks = rng.choice(own_t, min(per_user, len(own_t)),
                               replace=False)
            for i in picks[:-2]:
                ft.write(f"u{u} t{i} 1\n")
            test_u.extend([u] * 2)
            test_i.extend(picks[-2:].tolist())
            for i in rng.choice(own_s, min(per_user, len(own_s)),
                                replace=False):
                fs.write(f"u{u} s{i} 1\n")
    return np.asarray(test_u), np.asarray(test_i)


def make_text_rec(ui_path, iw_path, users=300, items=240, words=120,
                  clusters=6, per_user=12, words_per_item=5):
    """Clustered user-item edges + topic-consistent item-word edges;
    last 2 interactions per user held out."""
    rng = np.random.default_rng(SEED)
    test_u, test_i = [], []
    with open(ui_path, "w") as fu, open(iw_path, "w") as fw:
        for i in range(items):
            c = i % clusters
            own_w = np.arange(c, words, clusters)
            for w in rng.choice(own_w, min(words_per_item, len(own_w)),
                                replace=False):
                fw.write(f"i{i} w{w} 1\n")
        for u in range(users):
            c = u % clusters
            own = np.arange(c, items, clusters)
            picks = rng.choice(own, min(per_user, len(own)),
                               replace=False)
            for i in picks[:-2]:
                fu.write(f"u{u} i{i} 1\n")
            test_u.extend([u] * 2)
            test_i.extend(picks[-2:].tolist())
    return np.asarray(test_u), np.asarray(test_i)


def make_community(path, comms=4, per=COMMUNITY_PER, intra_deg=12,
                   inter_deg=2, seed=11):
    """Plain undirected community graph for the walk families: each
    vertex draws ``intra_deg`` endpoints inside its community and
    ``inter_deg`` outside. An existing file at ``path`` is kept."""
    if os.path.exists(path):
        return path
    rng = np.random.default_rng(seed)
    n = comms * per
    comm = np.arange(n) // per
    lines = []
    for v in range(n):
        c = comm[v]
        ins = rng.integers(0, per, intra_deg) + c * per
        outs = rng.integers(0, n, inter_deg)
        for u in np.concatenate([ins, outs]):
            if int(u) != v:
                lines.append(f"v{v} v{int(u)} 1\n")
    with open(path, "w") as f:
        f.writelines(lines)
    return path


# --------------------------------------------------------------------- #
# evaluations
# --------------------------------------------------------------------- #
def kg_rank_eval(score_batch, heads, rels, tails, n_entities, n_neg=50,
                 n_test=1000, seed=0):
    """MRR + hits@3 of the true triple vs n_neg uniform corrupted heads.
    score_batch(h, r, t) -> HIGHER = better (arm adapts sign)."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(heads), min(n_test, len(heads)), replace=False)
    h, r, t = heads[idx], rels[idx], tails[idx]
    correct = score_batch(h, r, t)
    better = np.zeros(len(idx))
    for _ in range(n_neg):
        nh = rng.integers(0, n_entities, len(idx))
        better += (correct > score_batch(nh, r, t)).astype(np.float64)
    rank = n_neg - better + 1
    return float((1.0 / rank).mean()), float((rank <= 3).mean())


def auc(pos, neg):
    pos, neg = np.asarray(pos), np.asarray(neg)
    return float((pos[:, None] > neg[None, :]).mean()
                 + 0.5 * (pos[:, None] == neg[None, :]).mean())


def community_auc_emb(emb, labels, n_pairs=20000, seed=0):
    x = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-12)
    rng = np.random.default_rng(seed)
    a = rng.integers(0, len(x), n_pairs * 3)
    b = rng.integers(0, len(x), n_pairs * 3)
    same = labels[a] == labels[b]
    s = (x[a] * x[b]).sum(1)
    return auc(s[same][:n_pairs], s[~same][:n_pairs][:2000])


def kg_scorer(model: str, state, cdim: int):
    """run_kg's higher-is-better score of (h, r, t) id arrays over the
    numpy tables ``state`` ({"entity", "relation"}; RotatE's relations
    are phases, RotatE's and ComplEx's rows re | im halves of ``cdim``)."""
    e, rl = state["entity"], state["relation"]
    if model == "transe":
        return lambda h, r, t: -np.linalg.norm(e[h] + rl[r] - e[t], axis=-1)
    if model == "rotate":
        def usc(h, r, t):
            hr, hi = e[h][:, :cdim], e[h][:, cdim:]
            tr, ti = e[t][:, :cdim], e[t][:, cdim:]
            cr, ci = np.cos(rl[r]), np.sin(rl[r])
            dr = hr * cr - hi * ci - tr
            di = hr * ci + hi * cr - ti
            return -np.sqrt((dr * dr + di * di).sum(-1))

        return usc

    def usc(h, r, t):
        hr, hi = e[h][:, :cdim], e[h][:, cdim:]
        tr, ti = e[t][:, :cdim], e[t][:, cdim:]
        rr, ri = rl[r][:, :cdim], rl[r][:, cdim:]
        return ((hr * rr - hi * ri) * tr + (hr * ri + hi * rr) * ti).sum(-1)

    return usc


def kg_mrr(model: str, state, kg, cdim: int):
    """(MRR, hits@3) of run_kg's probe on a loaded knowledge graph."""
    return kg_rank_eval(kg_scorer(model, state, cdim), kg.heads,
                        kg.relations, kg.tails, kg.n_entities)


def sign_auc(net, source, target):
    """run_sne's sign AUC: dot(source[u], target[v]) of the positive edges
    against the negative ones."""
    return auc((source[net.pos_src] * target[net.pos_dst]).sum(1),
               (source[net.neg_src] * target[net.neg_dst]).sum(1))


def temporal_labels(names):
    """run_ctdne's community of each vid (make_temporal's ``n{i}``)."""
    return np.array([int(nm[1:]) // TEMPORAL_PER_COMM for nm in names])


def author_labels(names):
    """run_mp2v's and run_han's (topic of each vid, the author vids):
    author ``a{i}`` is in topic i // 80."""
    labels = np.zeros(len(names), dtype=np.int64)
    author_rows = []
    for vid, nm in enumerate(names):
        if nm.startswith("a"):
            labels[vid] = int(nm[1:]) // AUTHORS_PER_TOPIC
            author_rows.append(vid)
    return labels, np.asarray(author_rows)


def author_auc(names, emb):
    """The same-topic AUC of the author rows of ``emb``."""
    labels, rows = author_labels(names)
    return community_auc_emb(emb[rows], labels[rows])


def community_labels(names):
    """run_fastrp's community of each vid (make_community's ``v{i}``)."""
    return np.array([int(nm[1:]) // COMMUNITY_PER for nm in names])


def cpr_eval(user, tgt, g_t, g_s, s_of_t, test_u_vid, test_i_vid):
    """AUC of transformed-user . target-item for held-out edges vs
    random items -- the SAME transformUser aggregation for both arms."""
    rng = np.random.default_rng(1)
    scores_p, scores_n = [], []
    for u, i in zip(test_u_vid, test_i_vid):
        lo, hi = g_t.indptr[u], g_t.indptr[u + 1]
        agg = user[u].copy()
        cnt = 1.0
        own_t = g_t.indices[lo:hi]
        agg += tgt[own_t].sum(0)
        cnt += len(own_t)
        uvec = agg / cnt
        scores_p.append(uvec @ tgt[i])
        scores_n.append(uvec @ tgt[rng.integers(0, tgt.shape[0])])
    sp = np.asarray(scores_p)
    sn = np.asarray(scores_n)
    return float((sp[:, None] > sn[None, :]).mean())


def tpr_eval(user, item, word, g_ui, g_iw, ui2iw, test_u_vid,
             test_i_vid, tw=0.5):
    rng = np.random.default_rng(1)

    def enrich(i):
        j = ui2iw[i]
        if j < 0:
            return item[i]
        ws = g_iw.indices[g_iw.indptr[j]:g_iw.indptr[j + 1]]
        if len(ws) == 0:
            return item[i]
        return (1 - tw) * item[i] + tw * word[ws].mean(0)

    sp = np.array([user[u] @ enrich(i)
                   for u, i in zip(test_u_vid, test_i_vid)])
    rand_items = rng.integers(0, item.shape[0], len(test_u_vid))
    sn = np.array([user[u] @ enrich(i)
                   for u, i in zip(test_u_vid, rand_items)])
    return float((sp[:, None] > sn[None, :]).mean())


def cpr_auc(g_t, g_s, test_u, test_i, user, target, names2id):
    """run_cpr's probe: the model's ``user`` / ``target`` rows (indexed by
    its target graph's ids ``names2id``) mapped by name into ``g_t``'s
    ids, scored by ``cpr_eval`` on the held-out (u{u}, t{i}) pairs."""
    dim = user.shape[1]
    s_of_t = np.array([g_s.name2id.get(nm, -1) for nm in g_t.names],
                      dtype=np.int64)
    mu = np.zeros((g_t.n_vertices, dim))
    mt = np.zeros((g_t.n_vertices, dim))
    for nm, vid in names2id.items():
        j = g_t.name2id.get(nm)
        if j is not None:
            mu[j] = user[vid]
            mt[j] = target[vid]
    tu = np.array([g_t.name2id[f"u{u}"] for u in test_u])
    ti = np.array([g_t.name2id[f"t{i}"] for i in test_i])
    return cpr_eval(mu, mt, g_t, g_s, s_of_t, tu, ti)


def tpr_auc(g_ui, g_iw, test_u, test_i, user, item, word, ui_names2id,
            iw_names2id, tw):
    """run_tpr's probe: the model's rows mapped by name into ``g_ui`` /
    ``g_iw`` ids (word rows only for ``w*`` names), scored by
    ``tpr_eval``."""
    dim = user.shape[1]
    ui2iw = np.array([g_iw.name2id.get(nm, -1) for nm in g_ui.names],
                     dtype=np.int64)
    mu = np.zeros((g_ui.n_vertices, dim))
    mi = np.zeros((g_ui.n_vertices, dim))
    mw = np.zeros((g_iw.n_vertices, dim))
    for nm, vid in ui_names2id.items():
        j = g_ui.name2id.get(nm)
        if j is not None:
            mu[j] = user[vid]
            mi[j] = item[vid]
    for nm, vid in iw_names2id.items():
        j = g_iw.name2id.get(nm)
        if j is not None and nm.startswith("w"):
            mw[j] = word[vid]
    tu = np.array([g_ui.name2id[f"u{u}"] for u in test_u])
    ti = np.array([g_ui.name2id[f"i{i}"] for i in test_i])
    return tpr_eval(mu, mi, mw, g_ui, g_iw, ui2iw, tu, ti, tw)
