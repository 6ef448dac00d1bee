"""The port's command line, ``python -m smore_tpu_torch``, on the CPU.

The checks of tests/test_cli.py and tests/test_cli_fidelity.py for the
subcommands (``line``, the walk, rec, community, knowledge-graph and
typed-graph families, ``jodie`` and the SASRec family), run with ``-device
cpu``; the rec family's ``mf``, ``bpr``, ``warp`` and ``skewopt`` load the
graph directed by default; every subcommand of the JAX package's CLI is
ported; ``-checkpoint`` resumes and ``-no_resume`` starts again.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from smore_tpu.cli.main import _REGISTRY as JAX_REGISTRY
from smore_tpu_torch.cli.main import _REGISTRY, NOT_PORTED, main
from smore_tpu_torch.graph.graph import Graph
from smore_tpu_torch.io.embeddings import load_embeddings
from smore_tpu_torch.utils.checkpoint import load_checkpoint

# one intra-op thread: test workers share the cores, and a thread pool
# in each of them oversubscribes the CPU on these tiny shapes
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["-device", "cpu"]  # the CLI defaults to the card


def test_registry_covers_the_jax_cli():
    assert set(_REGISTRY) == set(JAX_REGISTRY)
    assert NOT_PORTED == ()


def test_help_and_unknown(capsys):
    assert main([]) == 0
    assert main(["help"]) == 0
    out = capsys.readouterr().out
    assert "deepwalk" in out and "hpe" in out and "recdenoiser" in out
    assert "Not ported" not in out
    assert main(["nosuchmodel"]) == 1


@pytest.fixture()
def toy_edges(tmp_path):
    """tests/test_cli.py's 24-vertex user-item net."""
    rng = np.random.default_rng(0)
    p = tmp_path / "net.txt"
    p.write_text("".join(f"u{u} i{i} 1\n" for u in range(12)
                         for i in rng.choice(12, 4, replace=False)))
    return str(p)


def _emb(path):
    with open(path) as f:
        header = f.readline().split()
    emb = load_embeddings(path)
    assert all(np.isfinite(v).all() for v in emb.values())
    return header, emb


def test_cli_line_end_to_end(toy_edges, tmp_path):
    out = str(tmp_path / "rep.txt")
    assert main(["line", "-train", toy_edges, "-save", out, "-dimensions",
                 "8", "-sample_times", "0.01", "-batch", "32",
                 "-threads", "4"] + CPU) == 0
    header, emb = _emb(out)
    assert header == ["24", "8"] and len(emb) == 24


WALKS = {
    "deepwalk": ["-walk_times", "2", "-walk_steps", "8", "-window_size", "3"],
    "walklets": ["-walk_times", "2", "-walk_steps", "8", "-window_min", "1",
                 "-window_max", "3"],
    "node2vec": ["-walk_times", "2", "-walk_steps", "8", "-p", "0.5", "-q",
                 "2"],
    "app": ["-walk_times", "4", "-sample_times", "2", "-jump", "0.3"],
}


@pytest.mark.parametrize("cmd", sorted(WALKS))
def test_cli_walk_models_end_to_end(cmd, toy_edges, tmp_path):
    out = str(tmp_path / "rep.txt")
    assert main([cmd, "-train", toy_edges, "-save", out, "-dimensions", "8",
                 "-negative_samples", "2"] + WALKS[cmd] + CPU) == 0
    header, emb = _emb(out)
    assert header == ["24", "8"] and len(emb) == 24


REC = {
    "mf": ["-reg", "0.02", "-negative_samples", "3"],
    "bpr": [],
    "warp": [],
    "skewopt": ["-xi", "0.5", "-omega", "1", "-eta", "3"],
    "hpe": ["-walk_steps", "3", "-reg", "0.02"],
    "pe": [],
    "hoprec": ["-walk_steps", "2", "-margin", "0.5"],
    "nemf": ["-walk_steps", "2", "-reg", "0.02"],
    "nerank": ["-walk_steps", "2"],
}
FIELD_CMDS = ("hoprec", "nemf", "nerank")


def _field_file(tmp_path):
    p = tmp_path / "field.txt"
    p.write_text("".join(f"{k}{i} {k}\n" for k in "ui" for i in range(12)))
    return str(p)


@pytest.mark.parametrize("cmd", sorted(REC))
def test_cli_rec_models_end_to_end(cmd, toy_edges, tmp_path):
    out = str(tmp_path / "rep.txt")
    extra = ["-field", _field_file(tmp_path)] if cmd in FIELD_CMDS else []
    assert main([cmd, "-train", toy_edges, "-save", out, "-dimensions", "8",
                 "-sample_times", "0.004"] + REC[cmd] + extra + CPU) == 0
    header, emb = _emb(out)
    assert header == ["24", "8"] and len(emb) == 24


@pytest.mark.parametrize("cmd", FIELD_CMDS)
def test_cli_field_models_require_field(cmd, toy_edges, tmp_path):
    with pytest.raises(SystemExit):
        main([cmd, "-train", toy_edges, "-save", str(tmp_path / "r.txt")]
             + CPU)


# the community family: rows written (TEXTGCN and TEXTGCNdev skip the
# items, field 1) and columns (FINE and msFINE write both field rows)
COMMUNITY = {
    "gcn": (["-walk_steps", "2", "-reg", "0.02"], 24, 8),
    "textgcn": (["-walk_steps", "2"], 12, 8),
    "textgcndev": (["-num_events", "2", "-num_words", "2", "-reg", "0.02"],
                   12, 8),
    "eco": (["-reg", "0.02"], 24, 8),
    "fine": (["-walk_steps", "2"], 24, 16),
    "msfine": (["-walk_steps", "1"], 24, 16),
}


@pytest.mark.parametrize("cmd", sorted(COMMUNITY))
def test_cli_community_models_end_to_end(cmd, toy_edges, tmp_path):
    out = str(tmp_path / "rep.txt")
    flags, rows, cols = COMMUNITY[cmd]
    assert main([cmd, "-train", toy_edges, "-save", out, "-dimensions", "8",
                 "-sample_times", "0.002", "-field", _field_file(tmp_path)]
                + flags + CPU) == 0
    header, emb = _emb(out)
    assert header == [str(rows), str(cols)] and len(emb) == rows


@pytest.mark.parametrize("cmd", ["gcn", "textgcn", "textgcndev", "fine",
                                 "msfine"])
def test_cli_community_models_require_field(cmd, toy_edges, tmp_path):
    with pytest.raises(SystemExit):
        main([cmd, "-train", toy_edges, "-save", str(tmp_path / "r.txt")]
             + CPU)


@pytest.mark.parametrize("head", ["dchoice", "hop_choice", "recall_rank"])
def test_cli_eco_heads_without_field(head, toy_edges, tmp_path, monkeypatch):
    """-field is optional for eco; -head reaches the model."""
    from smore_tpu_torch.models import ECO

    heads = []
    init = ECO.__init__

    def recording(self, *a, **kw):
        init(self, *a, **kw)
        heads.append(self.head)

    monkeypatch.setattr(ECO, "__init__", recording)
    out = str(tmp_path / "rep.txt")
    assert main(["eco", "-train", toy_edges, "-save", out, "-dimensions", "8",
                 "-sample_times", "0.002", "-head", head] + CPU) == 0
    assert heads == [head]
    header, _ = _emb(out)
    assert header == ["24", "8"]


def test_cli_eco_rejects_unknown_head(toy_edges, tmp_path):
    with pytest.raises(SystemExit):
        main(["eco", "-train", toy_edges, "-save", str(tmp_path / "r.txt"),
              "-head", "nope"] + CPU)


@pytest.mark.parametrize("cmd,directed", [
    ("mf", True), ("bpr", True), ("warp", True), ("skewopt", True),
    ("hpe", False), ("pe", False), ("hoprec", False), ("nemf", False)])
def test_cli_rec_loading_direction(cmd, directed, toy_edges, tmp_path,
                                   monkeypatch):
    """The reference's mf, bpr, warp and skewopt CLIs load the graph
    DIRECTED; -undirected 1 still doubles the edges. The others load it
    undirected, as every other subcommand does."""
    seen = []
    load = Graph.load_edge_list

    def recording(path, undirected=True, **kw):
        seen.append(undirected)
        return load(path, undirected=undirected, **kw)

    monkeypatch.setattr(Graph, "load_edge_list", staticmethod(recording))
    extra = ["-field", _field_file(tmp_path)] if cmd in FIELD_CMDS else []
    base = [cmd, "-train", toy_edges, "-save", str(tmp_path / "rep.txt"),
            "-dimensions", "8", "-sample_times", "0.001"] + extra + CPU
    assert main(base) == 0
    assert main(base + ["-undirected", "1"]) == 0
    assert seen == [not directed, True]


def test_cli_hpe_warm_start(toy_edges, tmp_path):
    """-load_v/-load_c: a zero-budget run (one driver call still runs)
    stays far nearer the warm-start file than a run from a fresh init."""
    first = str(tmp_path / "first.txt")
    base = ["hpe", "-train", toy_edges, "-dimensions", "8", "-walk_steps",
            "2"] + CPU
    assert main(base + ["-save", first, "-sample_times", "0.004"]) == 0
    warm, cold = str(tmp_path / "warm.txt"), str(tmp_path / "cold.txt")
    assert main(base + ["-save", warm, "-sample_times", "0", "-load_v",
                        first, "-load_c", first]) == 0
    assert main(base + ["-save", cold, "-sample_times", "0"]) == 0
    a = load_embeddings(first)

    def gap(path):
        b = load_embeddings(path)
        return np.median([float(np.abs(a[k] - b[k]).max()) for k in a])

    assert gap(warm) < 0.5 * gap(cold)


def test_cli_default_batch_stable_on_readme_toy_net(tmp_path):
    """The README toy net at the default batch gives finite embeddings
    (clamp_batch caps the 32768 default near the vertex count)."""
    net = tmp_path / "toy.txt"
    net.write_text("u1 i1 1\nu1 i2 1\nu2 i2 1\nu2 i3 1\nu3 i3 1\n")
    out = str(tmp_path / "rep.txt")
    assert main(["line", "-train", str(net), "-save", out, "-dimensions",
                 "8", "-sample_times", "0.01"] + CPU) == 0
    header, emb = _emb(out)
    assert header == ["6", "8"] and len(emb) == 6


def _net(tmp_path, n=40, seed=1):
    """tests/test_cli_fidelity.py's 40-vertex graph."""
    rng = np.random.default_rng(seed)
    path = tmp_path / "net.txt"
    with open(path, "w") as f:
        for _ in range(200):
            a, b = rng.integers(0, n, 2)
            if a != b:
                f.write(f"n{a} n{b} 1\n")
    return str(path)


def test_load_v_warm_start_roundtrip(tmp_path):
    """A run warm-started from a saved file with a zero budget (one driver
    call still runs) stays near the file, far from the ~U(-0.5, 0.5)/dim
    init."""
    net = _net(tmp_path)
    first = str(tmp_path / "first.txt")
    assert main(["deepwalk", "-train", net, "-save", first, "-dimensions",
                 "8", "-walk_times", "1", "-walk_steps", "5"] + CPU) == 0
    second = str(tmp_path / "second.txt")
    assert main(["deepwalk", "-train", net, "-save", second, "-dimensions",
                 "8", "-walk_times", "0", "-walk_steps", "5", "-load_v",
                 first] + CPU) == 0
    a, b = load_embeddings(first), load_embeddings(second)
    assert set(a) == set(b)
    assert np.median([float(np.abs(a[k] - b[k]).max()) for k in a]) < 0.05


def test_line_load_flags(tmp_path):
    net = _net(tmp_path)
    first = str(tmp_path / "l1.txt")
    base = ["line", "-train", net, "-dimensions", "8", "-sample_times",
            "0.001", "-batch", "32"] + CPU
    assert main(base + ["-save", first]) == 0
    out = str(tmp_path / "l2.txt")
    assert main(base + ["-save", out, "-load_v", first, "-load_c",
                        first]) == 0
    assert _emb(out)[0] == ["40", "8"]


def test_checkpoint_then_no_resume(tmp_path):
    """-checkpoint saves the run; the same command again resumes the
    finished run and writes the same file; -no_resume trains again and
    overwrites the checkpoint."""
    net = _net(tmp_path)
    ck = str(tmp_path / "ck")

    def run(save, walk_times, *flags):
        assert main(["deepwalk", "-train", net, "-save", save,
                     "-dimensions", "8", "-walk_times", walk_times,
                     "-walk_steps", "5"] + list(flags) + CPU) == 0
        with open(save, "rb") as f:
            return f.read()

    a = run(str(tmp_path / "a.txt"), "2", "-checkpoint", ck)
    saved_a = load_checkpoint(ck)[0]["vertex"]
    assert run(str(tmp_path / "b.txt"), "2", "-checkpoint", ck) == a
    c = run(str(tmp_path / "c.txt"), "3", "-checkpoint", ck, "-no_resume")
    assert c == run(str(tmp_path / "d.txt"), "3")
    assert c != a
    assert not load_checkpoint(ck)[0]["vertex"].equal(saved_a)


def _typed_inputs(d):
    """Toy inputs of the knowledge-graph and typed-graph subcommands:
    {name: path} and the row count of each kind of output file."""
    rng = np.random.default_rng(3)
    files = {
        # 12 people, 6 foods, 2 cuisines, 2 relations
        "kg": "".join([f"f{j} in c{j % 2}\n" for j in range(6)]
                      + [f"p{i} likes f{j}\n" for i in range(12)
                         for j in rng.choice(6, 3, replace=False)]),
        "signed": "".join([f"v{a} v{b} +1\n" for a in range(6)
                           for b in range(a + 1, 6)]
                          + [f"v{a} v{a + 6} -1\n" for a in range(6)]),
        "hetero": "".join([f"a{a} author p{p} paper writes\n"
                           for a in range(6) for p in rng.choice(8, 3,
                                                                 replace=False)]
                          + [f"p{p} paper v{p % 2} venue published_at\n"
                             for p in range(8)]),
        "temporal": "".join(f"n{a} n{b} {t}\n" for a, b, t in zip(
            rng.integers(0, 10, 60), rng.integers(0, 10, 60),
            rng.integers(0, 20, 60))),
        "target": "".join(f"u{u} t{i} 1\n" for u in range(8)
                          for i in rng.choice(6, 3, replace=False)),
        "source": "".join(f"u{u} s{i} 1\n" for u in range(6)
                          for i in rng.choice(5, 2, replace=False)),
        "ui": "".join(f"u{u} i{i} 1\n" for u in range(8)
                      for i in rng.choice(6, 3, replace=False)),
        "iw": "".join(f"i{i} w{w} 1\n" for i in range(6)
                      for w in rng.choice(4, 2, replace=False)),
    }
    paths = {}
    for k, text in files.items():
        paths[k] = str(d / f"{k}.txt")
        with open(paths[k], "w") as f:
            f.write(text)
    return paths


def _vertices(path):
    return Graph.load_edge_list(path).n_vertices


# subcommand -> (argv given the inputs and the output directory, [(output
# flag, rows, columns)])
def _typed_case(cmd, p, out):
    dim = ["-dimensions", "8"]
    if cmd in ("transe", "rotate", "complex"):
        argv = ["-train", p["kg"], "-save_entity", f"{out}/e.txt",
                "-save_relation", f"{out}/r.txt", "-epochs", "2",
                "-batch_size", "16"] + dim
        w = 8 if cmd == "transe" else 16  # complex rows: re | im
        return argv, [("e.txt", 20, w), ("r.txt", 2, w)]
    if cmd == "sne":
        return (["-train", p["signed"], "-save", f"{out}/rep.txt", "-epochs",
                 "2", "-samples_per_edge", "1"] + dim,
                [("rep.txt", 12, 16)])  # [source | target]
    if cmd == "fastrp":
        return (["-train", p["target"], "-save",
                 f"{out}/rep.txt", "-iterations", "2"] + dim,
                [("rep.txt", _vertices(p["target"]), 8)])
    if cmd in ("metapath2vec", "han"):
        argv = ["-train", p["hetero"], "-save", f"{out}/rep.txt",
                "-meta_path", "author,paper,author", "-walk_times", "2",
                "-walk_steps", "4"] + dim
        if cmd == "han":
            argv += ["-meta_path", "author,paper,venue,paper,author",
                     "-epochs", "1"]
        return argv, [("rep.txt", 16, 8)]
    if cmd == "ctdne":
        return (["-train", p["temporal"], "-save", f"{out}/rep.txt",
                 "-walk_times", "2", "-walk_steps", "5", "-window_size",
                 "2"] + dim, [("rep.txt", 10, 8)])
    if cmd == "cpr":
        nt, ns = _vertices(p["target"]), _vertices(p["source"])
        return (["-train_target", p["target"], "-train_source", p["source"],
                 "-save_user", f"{out}/u.txt", "-save_target",
                 f"{out}/t.txt", "-save_source", f"{out}/s.txt",
                 "-update_times", "0.001"] + dim,
                [("u.txt", max(nt, ns), 8), ("t.txt", nt, 8),
                 ("s.txt", ns, 8)])
    nu, nw = _vertices(p["ui"]), _vertices(p["iw"])
    return (["-train_ui", p["ui"], "-train_iw", p["iw"], "-save_user",
             f"{out}/u.txt", "-save_item", f"{out}/i.txt", "-save_word",
             f"{out}/w.txt", "-sample_times", "0.001"] + dim,
            [("u.txt", nu, 8), ("i.txt", nu, 8), ("w.txt", nw, 8)])


TYPED = ["transe", "rotate", "complex", "sne", "fastrp", "cpr", "tpr",
         "metapath2vec", "han", "ctdne"]


@pytest.mark.parametrize("cmd", TYPED)
def test_cli_typed_models_end_to_end(cmd, tmp_path):
    """Each new subcommand on a toy file: every output file with its
    header and row count, finite values."""
    argv, outs = _typed_case(cmd, _typed_inputs(tmp_path), str(tmp_path))
    assert main([cmd] + argv + CPU) == 0
    for name, rows, cols in outs:
        header, emb = _emb(str(tmp_path / name))
        assert header == [str(rows), str(cols)], name
        assert len(emb) == rows and all(len(v) == cols
                                        for v in emb.values())


def test_cli_kg_checkpoint_resumes(tmp_path):
    p = _typed_inputs(tmp_path)
    ck = str(tmp_path / "ck")
    argv, _ = _typed_case("transe", p, str(tmp_path))
    assert main(["transe"] + argv + CPU + ["-checkpoint", ck]) == 0
    state, epochs, extra = load_checkpoint(ck)
    assert epochs == 2 and extra["epochs"] == 2
    assert set(state) == {"entity", "relation"}


def _interactions(d):
    """``user item timestamp`` events: 6 users, 8 items, time ties."""
    rng = np.random.default_rng(3)
    p = d / "events.txt"
    p.write_text("".join(f"u{e % 6} i{rng.integers(0, 8)} {e // 3}\n"
                         for e in range(60)))
    return str(p)


def _sequences(d):
    """user -> item edges in sequence order: 10 users, 12 items."""
    rng = np.random.default_rng(4)
    p = d / "seq.txt"
    p.write_text("".join(f"u{u} i{i} 1\n" for u in range(10)
                         for i in rng.integers(0, 12, 6)))
    return str(p)


# subcommand -> the extra flags of its model
SEQ = {"jodie": [], "sasrec": [], "gsasrec": ["-beta", "0.3"],
       "recdenoiser": ["-lambda_sparsity", "0.05", "-sparsity", "0.2"]}


@pytest.mark.parametrize("cmd", list(SEQ))
def test_cli_seq_models_end_to_end(cmd, tmp_path, capsys):
    """jodie (user and item files of the dynamic tables) and the SASRec
    family (item rows under the graph's names, the pad row dropped) on toy
    files: headers, row counts, finite values; -eval_holdout prints the
    ranking and -checkpoint writes one."""
    dim = ["-dimensions", "8"]
    if cmd == "jodie":
        argv = ["-train", _interactions(tmp_path), "-save_user",
                str(tmp_path / "u.txt"), "-save_item",
                str(tmp_path / "i.txt"), "-epochs", "2", "-batch-size", "4"]
        outs = [("u.txt", 6), ("i.txt", 8)]
    else:
        train = _sequences(tmp_path)
        argv = ["-train", train, "-save", str(tmp_path / "rep.txt"),
                "-max_seq_len", "4", "-num_blocks", "1", "-num_heads", "2",
                "-epochs", "2", "-batch_size", "4", "-negative_samples", "2",
                "-eval_holdout", "1", "-threads", "3"] + SEQ[cmd]
        outs = [("rep.txt", Graph.load_edge_list(
            train, undirected=False).n_vertices)]
    ck = str(tmp_path / "ck")
    assert main([cmd] + argv + dim + CPU + ["-checkpoint", ck]) == 0
    out = capsys.readouterr().out
    assert ("pairwise accuracy" if cmd == "jodie" else "recall@10") in out
    for name, rows in outs:
        header, emb = _emb(str(tmp_path / name))
        assert header == [str(rows), "8"], name
        assert len(emb) == rows
    assert load_checkpoint(ck)[1] == 2  # the epoch counter


def test_cli_sasrec_forward_only_keeps_the_network(tmp_path):
    """-forward_only 1 trains the item rows alone: the saved checkpoint's
    network matches a fresh init everywhere else."""
    from smore_tpu_torch.models import SASRec

    train = _sequences(tmp_path)
    ck = str(tmp_path / "ck")
    assert main(["sasrec", "-train", train, "-save", str(tmp_path / "r.txt"),
                 "-dimensions", "8", "-max_seq_len", "4", "-epochs", "1",
                 "-batch_size", "4", "-forward_only", "1", "-checkpoint",
                 ck] + CPU) == 0
    m = SASRec.load_edge_list(train, device="cpu")
    m.init(dim=8, max_seq_len=4)
    saved = load_checkpoint(ck)[0]["net"]
    for k, v in m.net.state_dict().items():
        assert torch.equal(saved[k], v) != (k == "item.weight"), k


def test_python_m_entry_point(toy_edges, tmp_path):
    """``python -m smore_tpu_torch``: -device cpu trains; with no -device the
    run is on the card, so without one it fails instead of falling back."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = tmp_path / "rep.txt"
    base = [sys.executable, "-m", "smore_tpu_torch", "line", "-train",
            toy_edges, "-save", str(out), "-dimensions", "8",
            "-sample_times", "0.002", "-batch", "32"]
    r = subprocess.run(base + CPU, env=env, cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert out.read_text().split("\n")[0] == "24 8"
    ev = _interactions(tmp_path)
    files = [str(tmp_path / f"{k}.txt") for k in ("user", "item")]
    r = subprocess.run([sys.executable, "-m", "smore_tpu_torch", "jodie",
                        "-train", ev, "-save_user", files[0], "-save_item",
                        files[1], "-dimensions", "8", "-epochs", "1"] + CPU,
                       env=env, cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "pairwise accuracy" in r.stdout
    assert [open(f).readline().split() for f in files] == [["6", "8"],
                                                           ["8", "8"]]
    if not torch.cuda.is_available():
        out.unlink()
        r = subprocess.run(base, env=env, cwd=ROOT, capture_output=True,
                           text=True, timeout=300)
        assert r.returncode != 0 and not out.exists()
