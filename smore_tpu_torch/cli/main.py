"""``python -m smore_tpu_torch``: one entry point, one subcommand per model.

Port of ``smore_tpu/cli/main.py``, every subcommand (``line``, the walk
family ``deepwalk``, ``walklets``, ``node2vec``, ``app``, the rec family
``mf``, ``bpr``, ``warp``, ``skewopt``, ``hpe``, ``pe``, ``hoprec``,
``nemf``, ``nerank``, the community family ``gcn``, ``textgcn``,
``textgcndev``, ``eco``, ``fine``, ``msfine``, the knowledge-graph family
``transe``, ``rotate``, ``complex``, the typed-graph family ``sne``,
``fastrp``, ``cpr``, ``tpr``, ``metapath2vec``, ``han``, ``ctdne``, and
``jodie``, ``sasrec``, ``gsasrec``, ``recdenoiser``), with the same flags,
defaults and output files. The reference CLIs' flag conventions
hold: single-dash long flags, e.g.::

    python -m smore_tpu_torch line -train net.txt -save rep.txt -order 2
    python -m smore_tpu_torch deepwalk -train net.txt -save rep.txt
    python -m smore_tpu_torch hoprec -train net.txt -field meta.txt \
        -save rep.txt
    python -m smore_tpu_torch transe -train triples.txt -save_entity e.txt \
        -save_relation r.txt

One flag is the port's own: ``-device`` (default ``cuda``, the card;
``cpu`` to run on the host). Without a card the default raises at the first
allocation; nothing falls back to the CPU. A subcommand listed in
``NOT_PORTED`` (none now) exits with code 2 and says so.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}

# the JAX package's subcommands not ported yet: none
NOT_PORTED = ()


def _cmd(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def _base_parser(name: str, walk: bool = False) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=f"python -m smore_tpu_torch {name}",
                                allow_abbrev=False, prefix_chars="-")
    p.add_argument("-train", required=True, help="input edge list")
    p.add_argument("-save", required=True, help="output embedding file")
    p.add_argument("-dimensions", type=int, default=64)
    p.add_argument("-undirected", type=int, default=1)
    p.add_argument("-alpha", type=float, default=0.025)
    p.add_argument("-threads", type=int, default=1,
                   help="accepted for compatibility; ignored")
    p.add_argument("-batch", type=int, default=None,
                   help="batch size override (line)")
    p.add_argument("-checkpoint", default=None,
                   help="checkpoint directory: save the full training state "
                        "periodically and resume from it if present")
    p.add_argument("-checkpoint_every", type=int, default=1,
                   help="checkpoint interval, in driver calls")
    p.add_argument("-no_resume", action="store_true",
                   help="with -checkpoint: overwrite instead of resuming")
    p.add_argument("-device", default="cuda",
                   help="torch device to train on: cuda (default) or cpu")
    if walk:
        p.add_argument("-walk_times", type=int, default=10)
        p.add_argument("-walk_steps", type=int, default=40)
        p.add_argument("-window_size", type=int, default=5)
        p.add_argument("-negative_samples", type=int, default=5)
    else:
        p.add_argument("-sample_times", type=float, default=10)
        p.add_argument("-negative_samples", type=int, default=5)
    return p


def _set_ckpt(m, a) -> None:
    """Apply -checkpoint/-checkpoint_every/-no_resume to a model."""
    if a.checkpoint:
        m.set_checkpoint(a.checkpoint, every=a.checkpoint_every,
                         resume=not a.no_resume)


def _warm_start(m, a) -> None:
    """Apply the -load_v/-load_c warm starts after init (the reference's
    Init(dim, load_vertex, load_context))."""
    if getattr(a, "load_v", None):
        m.load_pretrain(a.load_v, table="vertex")
    if getattr(a, "load_c", None) and "context" in m.state:
        m.load_pretrain(a.load_c, table="context")


def _load(cls, a, **kw):
    """The model of class ``cls`` (constructor arguments ``kw``) on
    -train's graph, on -device."""
    return cls.load_edge_list(a.train, undirected=bool(a.undirected),
                              device=a.device, **kw)


@_cmd("line")
def _line(argv):
    p = _base_parser("line")
    p.add_argument("-order", type=int, default=2)
    p.add_argument("-group", type=int, default=0,
                   help="contexts drawn per source per step (0 = auto: 1 on "
                        "the banded large-graph path, 8 elsewhere)")
    p.add_argument("-load_v", default=None, help="pretrained vertex warm start")
    p.add_argument("-load_c", default=None,
                   help="pretrained context warm start")
    a = p.parse_args(argv)
    from smore_tpu_torch.models import LINE

    m = _load(LINE, a)
    m.init(dim=a.dimensions, order=a.order)
    _warm_start(m, a)
    _set_ckpt(m, a)
    kw = {"batch": a.batch} if a.batch else {}
    m.train(sample_times=a.sample_times, negative_samples=a.negative_samples,
            alpha=a.alpha, group=a.group, **kw)
    m.save_weights(a.save)


@_cmd("pe")
def _pe(argv):
    p = _base_parser("pe")
    p.add_argument("-walk_meta", default=None,
                   help="per-vertex walk-steps file (reference "
                        "PE::LoadWalkMeta)")
    a = p.parse_args(argv)
    from smore_tpu_torch.models import PE

    m = _load(PE, a)
    if a.walk_meta:
        m.load_walk_meta(a.walk_meta)
    m.init(dim=a.dimensions)
    _set_ckpt(m, a)
    m.train(sample_times=a.sample_times, negative_samples=a.negative_samples,
            alpha=a.alpha)
    m.save_weights(a.save)


@_cmd("hpe")
def _hpe(argv):
    p = _base_parser("hpe")
    p.add_argument("-walk_steps", type=int, default=5)
    p.add_argument("-reg", type=float, default=0.01)
    p.add_argument("-load_v", default=None, help="pretrained vertex warm start")
    p.add_argument("-load_c", default=None,
                   help="pretrained context warm start")
    a = p.parse_args(argv)
    from smore_tpu_torch.models import HPE

    m = _load(HPE, a)
    m.init(dim=a.dimensions)
    _warm_start(m, a)
    _set_ckpt(m, a)
    m.train(sample_times=a.sample_times, walk_steps=a.walk_steps,
            negative_samples=a.negative_samples, reg=a.reg, alpha=a.alpha)
    m.save_weights(a.save)


def _simple_rec(name, cls_name, extra=()):
    """mf, bpr, warp, skewopt: the reference CLIs load the graph DIRECTED
    (there is no -undirected flag there), so -undirected defaults to 0
    here; mf passes -reg and -negative_samples, skewopt -xi, -omega and
    -eta to the constructor."""

    def run(argv):
        p = _base_parser(name)
        p.set_defaults(undirected=0)
        for flag, typ, dv in extra:
            p.add_argument(flag, type=typ, default=dv)
        a = p.parse_args(argv)
        from smore_tpu_torch import models

        ctor_kw = {}
        if name == "skewopt":
            ctor_kw = {"xi": a.xi, "omega": a.omega, "eta": a.eta}
        elif name == "mf":
            ctor_kw = {"reg": a.reg, "negative_samples": a.negative_samples}
        m = _load(getattr(models, cls_name), a, **ctor_kw)
        m.init(dim=a.dimensions)
        _set_ckpt(m, a)
        kw = {"batch": a.batch} if a.batch else {}
        m.train(sample_times=a.sample_times, alpha=a.alpha, **kw)
        m.save_weights(a.save)

    return run


_REG = ("-reg", float, 0.01)
_REGISTRY["mf"] = _simple_rec("mf", "MF", [_REG])
_REGISTRY["bpr"] = _simple_rec("bpr", "BPR", [_REG])
_REGISTRY["warp"] = _simple_rec("warp", "WARP", [_REG])
_REGISTRY["skewopt"] = _simple_rec(
    "skewopt", "SkewOPT",
    [_REG, ("-xi", float, 10.0), ("-omega", float, 3.0), ("-eta", int, 3)])


@_cmd("hoprec")
def _hoprec(argv):
    p = _base_parser("hoprec")
    p.add_argument("-field", required=True)
    p.add_argument("-walk_steps", type=int, default=5)
    p.add_argument("-margin", type=float, default=1.0)
    a = p.parse_args(argv)
    from smore_tpu_torch.models import HOPREC

    m = _load(HOPREC, a)
    m.graph.load_field_meta(a.field)
    m.init(dim=a.dimensions)
    _set_ckpt(m, a)
    m.train(sample_times=a.sample_times, walk_steps=a.walk_steps,
            margin=a.margin, alpha=a.alpha)
    m.save_weights(a.save)


def _field_model(name, cls_name):
    """gcn, textgcn, fine, msfine, nemf, nerank: -field is required; -reg
    reaches GCN and TEXTGCN only, and the others accept it as the JAX CLI
    does (the CSE heads fix their L2 at 0.025, FINE has none)."""

    def run(argv):
        p = _base_parser(name)
        p.add_argument("-field", required=True)
        p.add_argument("-walk_steps", type=int, default=5)
        p.add_argument("-reg", type=float, default=0.01)
        a = p.parse_args(argv)
        from smore_tpu_torch import models

        m = _load(getattr(models, cls_name), a)
        m.graph.load_field_meta(a.field)
        m.init(dim=a.dimensions)
        _set_ckpt(m, a)
        kw = {"reg": a.reg} if cls_name in ("GCN", "TEXTGCN") else {}
        m.train(sample_times=a.sample_times, walk_steps=a.walk_steps,
                negative_samples=a.negative_samples, alpha=a.alpha, **kw)
        m.save_weights(a.save)

    return run


for _name, _cls in (("gcn", "GCN"), ("textgcn", "TEXTGCN"), ("fine", "FINE"),
                    ("msfine", "MSFINE"), ("nemf", "NEMF"),
                    ("nerank", "NERANK")):
    _REGISTRY[_name] = _field_model(_name, _cls)


@_cmd("textgcndev")
def _textgcndev(argv):
    p = _base_parser("textgcndev")
    p.add_argument("-field", required=True)
    p.add_argument("-num_events", type=int, default=5)
    p.add_argument("-num_words", type=int, default=5)
    p.add_argument("-reg", type=float, default=0.01)
    a = p.parse_args(argv)
    from smore_tpu_torch.models import TEXTGCNdev

    m = _load(TEXTGCNdev, a)
    m.graph.load_field_meta(a.field)
    m.init(dim=a.dimensions)
    # no checkpoint flags are wired in here, as in the JAX CLI
    m.train(sample_times=a.sample_times, num_events=a.num_events,
            num_words=a.num_words, negative_samples=a.negative_samples,
            reg=a.reg, alpha=a.alpha)
    m.save_weights(a.save)


@_cmd("eco")
def _eco(argv):
    from smore_tpu_torch.models.eco import ECO, HEADS

    p = _base_parser("eco")
    p.add_argument("-field", default=None)
    p.add_argument("-reg", type=float, default=0.01)
    p.add_argument("-head", default="dchoice", choices=HEADS,
                   help="dchoice = the reference's live branch; the others "
                        "are its commented-out alternates, selectable here")
    a = p.parse_args(argv)

    m = _load(ECO, a, head=a.head)
    if a.field:
        m.graph.load_field_meta(a.field)
    m.init(dim=a.dimensions)
    _set_ckpt(m, a)
    m.train(sample_times=a.sample_times, reg=a.reg,
            negative_samples=a.negative_samples, alpha=a.alpha)
    m.save_weights(a.save)


@_cmd("deepwalk")
def _deepwalk(argv):
    p = _base_parser("deepwalk", walk=True)
    p.add_argument("-load_v", default=None, help="pretrained vertex warm start")
    p.add_argument("-load_c", default=None,
                   help="pretrained context warm start")
    a = p.parse_args(argv)
    from smore_tpu_torch.models import DeepWalk

    m = _load(DeepWalk, a)
    m.init(dim=a.dimensions)
    _warm_start(m, a)
    _set_ckpt(m, a)
    m.train(walk_times=a.walk_times, walk_steps=a.walk_steps,
            window_size=a.window_size, negative_samples=a.negative_samples,
            alpha=a.alpha)
    m.save_weights(a.save)


@_cmd("walklets")
def _walklets(argv):
    p = _base_parser("walklets", walk=True)
    p.add_argument("-window_min", type=int, default=2)
    p.add_argument("-window_max", type=int, default=5)
    a = p.parse_args(argv)
    from smore_tpu_torch.models import Walklets

    m = _load(Walklets, a)
    m.init(dim=a.dimensions)
    _set_ckpt(m, a)
    m.train(walk_times=a.walk_times, walk_steps=a.walk_steps,
            window_min=a.window_min, window_max=a.window_max,
            negative_samples=a.negative_samples, alpha=a.alpha)
    m.save_weights(a.save)


@_cmd("node2vec")
def _node2vec(argv):
    p = _base_parser("node2vec", walk=True)
    p.add_argument("-p", type=float, default=1.0)
    p.add_argument("-q", type=float, default=1.0)
    a = p.parse_args(argv)
    from smore_tpu_torch.models import Node2Vec

    m = _load(Node2Vec, a)
    m.init(dim=a.dimensions)
    _set_ckpt(m, a)
    m.train(walk_times=a.walk_times, walk_steps=a.walk_steps,
            window_size=a.window_size, p=a.p, q=a.q,
            negative_samples=a.negative_samples, alpha=a.alpha)
    m.save_weights(a.save)


@_cmd("app")
def _app(argv):
    p = _base_parser("app")
    p.add_argument("-walk_times", type=int, default=100)
    p.add_argument("-jump", type=float, default=0.15)
    a = p.parse_args(argv)
    from smore_tpu_torch.models import APP

    m = _load(APP, a)
    m.init(dim=a.dimensions)
    _set_ckpt(m, a)
    m.train(walk_times=a.walk_times, sample_times=int(a.sample_times),
            jump=a.jump, negative_samples=a.negative_samples, alpha=a.alpha)
    m.save_weights(a.save)


@_cmd("fastrp")
def _fastrp(argv):
    p = _base_parser("fastrp")
    p.add_argument("-iterations", type=int, default=3)
    p.add_argument("-normalization", type=float, default=0.0)
    a = p.parse_args(argv)
    from smore_tpu_torch.models import FastRP

    m = _load(FastRP, a, iterations=a.iterations,
              normalization_strength=a.normalization)
    m.generate(dim=a.dimensions)
    m.save_weights(a.save)


def _ckpt_kw(a) -> dict:
    """-checkpoint/-checkpoint_every/-no_resume as train() arguments (the
    typed-graph and KG models take them there, as in the JAX CLI)."""
    return {"checkpoint": a.checkpoint, "checkpoint_every": a.checkpoint_every,
            "resume": not a.no_resume}


def _typed_walk_model(name, cls_name):
    """metapath2vec and han: -meta_path (comma-separated types,
    repeatable) on a ``src srcType dst dstType edgeType`` file; han adds
    -epochs and takes -alpha as its learning rate."""

    def run(argv):
        p = _base_parser(name, walk=True)
        p.add_argument("-meta_path", action="append", required=True,
                       help="comma-separated type sequence; repeatable")
        if name == "han":
            p.add_argument("-epochs", type=int, default=5)
        a = p.parse_args(argv)
        from smore_tpu_torch import models

        m = _load(getattr(models, cls_name), a)
        for mp in a.meta_path:
            m.add_meta_path(mp.split(","))
        if name == "han":
            m.init(dim=a.dimensions, learning_rate=a.alpha)
            m.train(walk_times=a.walk_times, walk_steps=a.walk_steps,
                    epochs=a.epochs, **_ckpt_kw(a))
        else:
            m.init(dim=a.dimensions)
            m.train(walk_times=a.walk_times, walk_steps=a.walk_steps,
                    window_size=a.window_size,
                    negative_samples=a.negative_samples, alpha=a.alpha,
                    **_ckpt_kw(a))
        m.save_weights(a.save)

    return run


_REGISTRY["metapath2vec"] = _typed_walk_model("metapath2vec", "Metapath2Vec")
_REGISTRY["han"] = _typed_walk_model("han", "HAN")


@_cmd("ctdne")
def _ctdne(argv):
    p = _base_parser("ctdne", walk=True)
    p.add_argument("-time_window", type=float, default=None)
    a = p.parse_args(argv)
    from smore_tpu_torch.models import CTDNE

    # ``src dst timestamp`` lines, directed (-undirected is not read)
    m = CTDNE.load_edge_list(a.train, time_window=a.time_window,
                             device=a.device)
    m.init(dim=a.dimensions)
    m.train(walk_times=a.walk_times, walk_steps=a.walk_steps,
            window_size=a.window_size, negative_samples=a.negative_samples,
            alpha=a.alpha, **_ckpt_kw(a))
    m.save_weights(a.save)


@_cmd("sne")
def _sne(argv):
    p = _base_parser("sne")
    p.add_argument("-epochs", type=int, default=10)
    p.add_argument("-beta", type=float, default=1.0)
    p.add_argument("-samples_per_edge", type=int, default=5,
                   help="samples per edge per epoch")
    a = p.parse_args(argv)
    from smore_tpu_torch.models import SNE

    m = _load(SNE, a, beta=a.beta, negative_samples=a.negative_samples)
    m.init(dim=a.dimensions)
    m.train(epochs=a.epochs, samples_per_edge=a.samples_per_edge,
            alpha=a.alpha, **_ckpt_kw(a))
    m.save_weights(a.save)


def _own_parser(name: str) -> argparse.ArgumentParser:
    """The parser of a subcommand with its own input and output flags:
    -threads (ignored), the checkpoint flags and -device."""
    p = argparse.ArgumentParser(prog=f"python -m smore_tpu_torch {name}",
                                allow_abbrev=False)
    p.add_argument("-threads", type=int, default=1,
                   help="accepted for compatibility; ignored")
    p.add_argument("-checkpoint", default=None,
                   help="checkpoint directory: save the full training state "
                        "periodically and resume from it if present")
    p.add_argument("-checkpoint_every", type=int, default=1)
    p.add_argument("-no_resume", action="store_true")
    p.add_argument("-device", default="cuda",
                   help="torch device to train on: cuda (default) or cpu")
    return p


def _kg_model(name, cls_name, extra=()):
    """transe, rotate, complex: ``head relation tail [weight]`` triples,
    entity and relation files; -checkpoint_every counts epochs."""

    def run(argv):
        p = _own_parser(name)
        p.add_argument("-train", required=True)
        p.add_argument("-save_entity", required=True)
        p.add_argument("-save_relation", required=True)
        p.add_argument("-dimensions", type=int, default=64)
        p.add_argument("-epochs", type=int, default=100)
        p.add_argument("-batch_size", type=int, default=1024)
        p.add_argument("-alpha", type=float, default=0.01)
        p.add_argument("-margin", type=float, default=1.0)
        for flag, typ, dv in extra:
            p.add_argument(flag, type=typ, default=dv)
        a = p.parse_args(argv)
        from smore_tpu_torch import models

        kw = {"margin": a.margin, "device": a.device}
        if cls_name == "TransE":
            kw["norm"] = a.norm
        if cls_name == "RotatE":
            kw["adversarial_temp"] = a.adversarial_temp
        m = getattr(models, cls_name).load_triples(a.train, **kw)
        m.init(dim=a.dimensions)
        m.train(epochs=a.epochs, batch=a.batch_size, alpha=a.alpha,
                **_ckpt_kw(a))
        m.save_embeddings(a.save_entity, a.save_relation)

    return run


_REGISTRY["transe"] = _kg_model("transe", "TransE", [("-norm", int, 2)])
_REGISTRY["rotate"] = _kg_model("rotate", "RotatE",
                                [("-adversarial_temp", float, 1.0)])
_REGISTRY["complex"] = _kg_model("complex", "ComplEx")


@_cmd("cpr")
def _cpr(argv):
    p = _own_parser("cpr")
    p.add_argument("-train_target", required=True)
    p.add_argument("-train_source", required=True)
    p.add_argument("-save_user", required=True)
    p.add_argument("-save_target", required=True)
    p.add_argument("-save_source", required=True)
    p.add_argument("-dimensions", type=int, default=64)
    p.add_argument("-update_times", type=float, default=10)
    p.add_argument("-alpha", type=float, default=0.025)
    p.add_argument("-margin", type=float, default=1.0)
    p.add_argument("-user_reg", type=float, default=0.01)
    p.add_argument("-item_reg", type=float, default=0.01)
    p.add_argument("-negative_samples", type=int, default=5,
                   help="accepted for parity; print-only in the reference")
    p.add_argument("-undirected", type=int, default=1)
    a = p.parse_args(argv)
    from smore_tpu_torch.models import CPR

    m = CPR.load_domains(a.train_target, a.train_source, margin=a.margin,
                         undirected=bool(a.undirected), user_reg=a.user_reg,
                         item_reg=a.item_reg, device=a.device)
    m.init(dim=a.dimensions)
    m.train(update_times=a.update_times, alpha=a.alpha, **_ckpt_kw(a))
    m.save_weights(a.save_user, a.save_target, a.save_source)


@_cmd("tpr")
def _tpr(argv):
    p = _own_parser("tpr")
    p.add_argument("-train_ui", required=True)
    p.add_argument("-train_iw", required=True)
    p.add_argument("-save_user", required=True)
    p.add_argument("-save_item", required=True)
    p.add_argument("-save_word", required=True)
    p.add_argument("-dimensions", type=int, default=64)
    p.add_argument("-sample_times", type=float, default=10)
    p.add_argument("-alpha", type=float, default=0.025)
    p.add_argument("-text_weight", type=float, default=0.3)
    p.add_argument("-lambda", type=float, default=0.025, dest="lam",
                   help="L2 regularization")
    p.add_argument("-undirected", type=int, default=1)
    a = p.parse_args(argv)
    from smore_tpu_torch.models import TPR

    m = TPR.load_graphs(a.train_ui, a.train_iw, text_weight=a.text_weight,
                        undirected=bool(a.undirected), lam=a.lam,
                        device=a.device)
    m.init(dim=a.dimensions)
    m.train(sample_times=a.sample_times, alpha=a.alpha, **_ckpt_kw(a))
    m.save_weights(a.save_user, a.save_item, a.save_word)


@_cmd("jodie")
def _jodie(argv):
    p = _own_parser("jodie")
    p.add_argument("-train", required=True,
                   help="user item timestamp [features...] lines")
    p.add_argument("-save_user", required=True)
    p.add_argument("-save_item", required=True)
    p.add_argument("-dimensions", type=int, default=64)
    p.add_argument("-epochs", type=int, default=5)
    p.add_argument("-alpha", type=float, default=0.01)
    p.add_argument("-batch-size", type=int, default=128, dest="batch_size",
                   help="accepted for compatibility; the reference prints "
                        "it and trains chronologically")
    a = p.parse_args(argv)
    from smore_tpu_torch.models import JODIE

    m = JODIE.load_interactions(a.train, device=a.device)
    m.init(dim=a.dimensions)
    m.train(epochs=a.epochs, learning_rate=a.alpha, **_ckpt_kw(a))
    print(f"\tpairwise accuracy: {m.evaluate_predictions():.4f}")
    m.save_weights(a.save_user, a.save_item)


def _seq_model(name, cls_name, extra=()):
    """sasrec, gsasrec, recdenoiser: user -> item edges whose file order is
    each user's sequence; the item rows are saved. -checkpoint_every
    counts epochs."""

    def run(argv):
        p = _own_parser(name)
        p.add_argument("-train", required=True)
        p.add_argument("-save", required=True)
        p.add_argument("-dimensions", type=int, default=64)
        p.add_argument("-max_seq_len", type=int, default=50)
        p.add_argument("-num_blocks", type=int, default=2)
        p.add_argument("-num_heads", type=int, default=1)
        p.add_argument("-dropout", type=float, default=0.2)
        p.add_argument("-epochs", type=int, default=10)
        p.add_argument("-batch_size", type=int, default=128)
        p.add_argument("-alpha", type=float, default=0.001)
        p.add_argument("-negative_samples", type=int, default=1,
                       help="negatives per position, summed")
        p.add_argument("-eval_holdout", type=int, default=0,
                       help="1 = withhold each user's last item, train on "
                            "the prefix, and print recall@10 / NDCG@10 "
                            "(leave-one-out next-item ranking)")
        p.add_argument("-forward_only", type=int, default=0,
                       help="1 = train ONLY the item embeddings (the "
                            "reference's semantics); 0 = full autodiff "
                            "(default)")
        for flag, typ, dv in extra:
            p.add_argument(flag, type=typ, default=dv)
        a = p.parse_args(argv)
        from smore_tpu_torch import models

        kw = {"negative_samples": a.negative_samples, "device": a.device}
        if cls_name == "GSASRec":
            kw["beta"] = a.beta
        if cls_name == "RecDenoiser":
            kw["lambda_sparsity"] = a.lambda_sparsity
            kw["sparsity"] = a.sparsity
        m = getattr(models, cls_name).load_edge_list(a.train, **kw)
        m.init(dim=a.dimensions, max_seq_len=a.max_seq_len,
               num_blocks=a.num_blocks, num_heads=a.num_heads,
               dropout=a.dropout)
        m.train(epochs=a.epochs, batch_size=a.batch_size, alpha=a.alpha,
                holdout=bool(a.eval_holdout),
                forward_only=bool(a.forward_only), **_ckpt_kw(a))
        if a.eval_holdout:
            r = m.evaluate_ranking(ks=(10,))
            print(f"\trecall@10: {r['recall@10']:.4f}  "
                  f"NDCG@10: {r['ndcg@10']:.4f}")
        m.save_weights(a.save)

    return run


_REGISTRY["sasrec"] = _seq_model("sasrec", "SASRec")
_REGISTRY["gsasrec"] = _seq_model("gsasrec", "GSASRec",
                                  [("-beta", float, 0.5)])
_REGISTRY["recdenoiser"] = _seq_model(
    "recdenoiser", "RecDenoiser",
    [("-lambda_sparsity", float, 0.01), ("-sparsity", float, 0.3)])


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help", "help"):
        print("smore_tpu_torch: SMORe on PyTorch and CUDA. Subcommands:\n  "
              + ", ".join(sorted(_REGISTRY)))
        if NOT_PORTED:
            print("Not ported yet (run them with python -m smore_tpu):\n  "
                  + ", ".join(sorted(NOT_PORTED)))
        print("\nRun `python -m smore_tpu_torch <model>` with no flags for "
              "that model's options.")
        return 0
    cmd = argv[0]
    if cmd in NOT_PORTED:
        print(f"{cmd!r} is not ported to smore_tpu_torch yet (ROADMAP.md, "
              "Queue 1); the JAX package runs it: python -m smore_tpu "
              f"{cmd} ...", file=sys.stderr)
        return 2
    if cmd not in _REGISTRY:
        print(f"unknown model {cmd!r}; run `python -m smore_tpu_torch help` "
              "for the list")
        return 1
    _REGISTRY[cmd](argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
