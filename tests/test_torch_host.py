"""Host layer of the PyTorch port against smore_tpu: bit-equal.

CSR and names, alias tables, the negative table, every array of the banded
tables, of the pre-sampled edge stream and of the banded negative law, and
the embedding text are all host numpy in both packages and must agree
exactly."""

import os

import numpy as np
import pytest
import torch

from smore_tpu.graph.graph import Graph as JGraph
from smore_tpu.io.embeddings import save_embeddings as j_save
from smore_tpu.sampling import alias as j_alias
from smore_tpu.sampling.banded import BandedTables as JBanded
from smore_tpu.sampling.tables import SamplerTables
from smore_tpu_torch.graph.graph import Graph as TGraph
from smore_tpu_torch.io.embeddings import load_embeddings
from smore_tpu_torch.native import fastgraph
from smore_tpu_torch.io.embeddings import save_embeddings as t_save
from smore_tpu_torch.sampling import alias as t_alias
from smore_tpu_torch.sampling.banded import BandedTables as TBanded
from smore_tpu_torch.sampling.tables import build_negative_table

from conftest import TOY_EDGES

# one intra-op thread: test workers share the cores, and a thread pool
# in each of them oversubscribes the CPU on these tiny shapes
torch.set_num_threads(1)

CPU = torch.device("cpu")  # the port defaults to the card


def _comm_edges():
    """The 200-vertex 4-community graph of test_pallas_sgns_banded.py."""
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
    return edges


GRAPHS = {"toy": TOY_EDGES, "comm": _comm_edges()}


def _pair(name, undirected=True):
    e = GRAPHS[name]
    return (JGraph.from_edges(e, undirected=undirected),
            TGraph.from_edges(e, undirected=undirected))


def _same_graph(jg, tg):
    for f in ("indptr", "indices", "weights", "out_degree", "in_degree"):
        a, b = getattr(jg, f), getattr(tg, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert jg.names == tg.names and jg.name2id == tg.name2id


@pytest.mark.parametrize("name", ["toy", "comm"])
@pytest.mark.parametrize("undirected", [True, False])
def test_from_edges_bit_equal(name, undirected):
    _same_graph(*_pair(name, undirected))


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("undirected", [True, False])
def test_load_edge_list_bit_equal(tmp_path, use_native, undirected):
    p = tmp_path / "net.txt"
    lines = [f"{a} {b} {w:g}" for a, b, w in GRAPHS["comm"][:500]]
    lines += ["", "lonely", "x y notanumber", "p q"]  # blank, malformed, no w
    p.write_text("\n".join(lines) + "\n")
    jg = JGraph.load_edge_list(str(p), undirected, use_native=use_native)
    tg = TGraph.load_edge_list(str(p), undirected, use_native=use_native)
    _same_graph(jg, tg)
    # the port builds its own copy of the loader, never the JAX package's
    port = os.path.dirname(os.path.dirname(os.path.abspath(
        fastgraph.__file__)))
    assert os.path.basename(port) == "smore_tpu_torch"
    src = os.path.abspath(fastgraph._SRC)
    assert os.path.commonpath([src, port]) == port and os.path.exists(src)


@pytest.mark.parametrize("n,power", [(7, 0.75), (300, 1.0), (5000, 0.75)])
def test_build_alias_bit_equal(n, power):
    w = np.random.default_rng(n).random(n) * 3
    w[::11] = 0.0
    for a, b in zip(j_alias.build_alias(w, power=power),
                    t_alias.build_alias(w, power=power)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("n_seg", [5, 900])
def test_build_alias_segmented_bit_equal(n_seg):
    rng = np.random.default_rng(n_seg)
    deg = rng.integers(0, 12, n_seg)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    w = rng.random(int(indptr[-1])) + 0.1
    for a, b in zip(j_alias.build_alias_segmented(w, indptr),
                    t_alias.build_alias_segmented(w, indptr)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name", ["toy", "comm"])
def test_negative_table_bit_equal(name):
    jg, tg = _pair(name)
    a = np.asarray(SamplerTables.build_negative_table(jg))
    b = build_negative_table(tg, device=CPU).numpy()
    assert a.dtype == b.dtype and np.array_equal(a, b)


_BANDED_ARRAYS = ("band_pa", "band_meta", "edge_pa", "edge_seg", "ctx_pa",
                  "neg_pa")


@pytest.mark.parametrize("two_d", [True, False])
def test_banded_tables_bit_equal(two_d):
    jg, tg = _pair("comm")
    jb = JBanded.build(jg, band_size=64, two_d=two_d)
    tb = TBanded.build(tg, band_size=64, two_d=two_d, device=CPU)
    for f in _BANDED_ARRAYS:
        a, b = np.asarray(getattr(jb, f)), getattr(tb, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("band_size", "n_rows_padded", "n_bands", "two_d"):
        assert getattr(jb, f) == getattr(tb, f), f


@pytest.mark.parametrize("two_d", [True, False])
def test_edge_stream_bit_equal(two_d):
    jg, tg = _pair("comm")
    jb = JBanded.build(jg, band_size=64, two_d=two_d).build_stream(
        mult=4, seed=0)
    tb = TBanded.build(tg, band_size=64, two_d=two_d,
                       device=CPU).build_stream(mult=4, seed=0)
    for f in ("stream", "stream_meta"):
        a, b = np.asarray(getattr(jb, f)), getattr(tb, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("method", ["degrees", "in_degrees"])
@pytest.mark.parametrize("nb2", [16, 64])
def test_neg_bands_bit_equal(nb2, method):
    """The window and window-local negative alias tables, whole-band (64)
    and finer (16) windows, padded rows included."""
    jg, tg = _pair("comm")
    jb = JBanded.build(jg, band_size=64).build_neg_bands(
        jg, negative_method=method, nb2=nb2)
    tb = TBanded.build(tg, band_size=64, device=CPU).build_neg_bands(
        tg, negative_method=method, nb2=nb2)
    assert jb.nb2 == tb.nb2 == nb2
    for f in ("neg_band_pa", "neg_local_pa"):
        a, b = np.asarray(getattr(jb, f)), getattr(tb, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert tb.neg_band_pa.shape == (tb.n_rows_padded // nb2, 2)


def test_neg_bands_reject_bad_window():
    _, tg = _pair("comm")
    tb = TBanded.build(tg, band_size=64, device=CPU)
    for nb2 in (24, 8):  # does not divide the band / not a multiple of 16
        with pytest.raises(ValueError, match="nb2"):
            tb.build_neg_bands(tg, nb2=nb2)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_save_embeddings_text_equal(tmp_path, dtype):
    names = [f"n{i}" for i in range(17)]
    table = (np.random.default_rng(1).standard_normal((17, 8)) * 3).astype(
        dtype)
    pj, pt = tmp_path / "j.txt", tmp_path / "t.txt"
    j_save(str(pj), names, table)
    t_save(str(pt), names, table)
    assert pj.read_text() == pt.read_text()
    back = load_embeddings(str(pt))
    assert list(back) == names
    np.testing.assert_allclose(np.stack(list(back.values())), table,
                               rtol=1e-5, atol=1e-6)
