"""Field and walk metadata and the field-constrained tables of the port
against smore_tpu's.

- ``Graph.load_field_meta`` / ``load_walk_meta``: the arrays, field count
  and names bit-equal to the JAX package's on files with unknown names,
  short lines, a bad step count, a vertex named twice and a directory of
  files.
- ``FieldTables.build``: the flat tables bit-equal, for the default and the
  models' weights, with an empty field and a field past the native alias
  build's 4096 entries.
- ``negative_field_sample``: bit-equal given the JAX draw's uniforms; by
  counts, every draw lies in the requested field and follows the field's
  weight^0.75 law.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smore_tpu.graph.graph import Graph as JGraph
from smore_tpu.sampling.fields import FieldTables as JFieldTables
from smore_tpu_torch.graph.graph import Graph
from smore_tpu_torch.sampling.fields import FieldTables

# one intra-op thread: test workers share the cores, and a thread pool
# in each of them oversubscribes the CPU on these tiny shapes
torch.set_num_threads(1)

CPU = torch.device("cpu")  # the port defaults to the card


def _edges(n_users=40, n_items=60, seed=0):
    rng = np.random.default_rng(seed)
    return [(f"u{u}", f"i{i}", float(rng.integers(1, 4)))
            for u in range(n_users)
            for i in rng.choice(n_items, 5, replace=False)]


@pytest.fixture(scope="module")
def graphs():
    e = _edges()
    return JGraph.from_edges(e, undirected=True), Graph.from_edges(
        e, undirected=True)


def _meta_file(path, names):
    """Fields by name prefix; an unknown name, a short line, a blank line,
    a third field given to one vertex and then taken back (an empty field),
    and one vertex in a fourth field."""
    lines = ["nobody x", "lonely", ""]
    lines.append(f"{names[3]} ghost")
    lines += [f"{nm} {'user' if nm[0] == 'u' else 'item'}" for nm in names]
    lines.append(f"{names[5]} odd")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _check_same_meta(jg, tg):
    np.testing.assert_array_equal(tg.fields, jg.fields)
    assert tg.fields.dtype == jg.fields.dtype == np.int32
    assert tg.n_fields == jg.n_fields
    assert tg.field_names == jg.field_names


def test_load_field_meta_bit_equal(graphs, tmp_path):
    jg, tg = graphs
    path = _meta_file(tmp_path / "field.txt", tg.names)
    jg.load_field_meta(path)
    tg.load_field_meta(path)
    _check_same_meta(jg, tg)
    assert tg.field_names == ["ghost", "user", "item", "odd"]
    assert not (tg.fields == 0).any()  # field 0 ("ghost") is empty


def test_load_field_meta_directory(graphs, tmp_path):
    jg, tg = graphs
    d = tmp_path / "fields"
    d.mkdir()
    half = len(tg.names) // 2
    (d / "a.txt").write_text("".join(f"{nm} {nm[0]}\n"
                                     for nm in tg.names[half:]))
    (d / "b.txt").write_text("".join(f"{nm} {nm[0]}\n"
                                     for nm in tg.names[:half]))
    jg.load_field_meta(str(d))
    tg.load_field_meta(str(d))
    _check_same_meta(jg, tg)


def test_load_walk_meta_bit_equal(graphs, tmp_path):
    jg, tg = graphs
    rng = np.random.default_rng(1)
    lines = ["nobody 4", "short", f"{tg.names[0]} two", f"{tg.names[1]} 7"]
    lines += [f"{nm} {rng.integers(1, 9)}" for nm in tg.names[2::3]]
    p = tmp_path / "walk.txt"
    p.write_text("\n".join(lines) + "\n")
    for g in (jg, tg):
        g.load_walk_meta(str(p))
    np.testing.assert_array_equal(tg.walk_steps, jg.walk_steps)
    assert tg.walk_steps.dtype == np.int32
    assert tg.walk_steps[0] == 3 and tg.walk_steps[1] == 7  # default 3
    jg.load_walk_meta(str(p), default_steps=5)
    tg.load_walk_meta(str(p), default_steps=5)
    np.testing.assert_array_equal(tg.walk_steps, jg.walk_steps)


def _weights(g, kind):
    return {"default": None, "out_degree": g.out_degree,
            "has_in_edges": (g.in_degree > 0).astype(np.float64),
            "uniform": np.ones(g.n_vertices)}[kind]


def _tables_equal(jt, tt):
    for name in ("field_indptr", "field_pa", "field_vid", "field_of"):
        a, b = np.asarray(getattr(jt, name)), getattr(tt, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("kind", ["default", "out_degree", "has_in_edges",
                                  "uniform"])
def test_field_tables_build_bit_equal(graphs, tmp_path, kind):
    jg, tg = graphs
    path = _meta_file(tmp_path / "field.txt", tg.names)
    jg.load_field_meta(path)
    tg.load_field_meta(path)
    _tables_equal(JFieldTables.build(jg, weights=_weights(jg, kind)),
                  FieldTables.build(tg, weights=_weights(tg, kind),
                                    device=CPU))


def test_field_tables_without_fields_and_large_field(tmp_path):
    """No field metadata: one field. 5,000 users in one field: the native
    alias build (above 4096 entries), as in the JAX package."""
    e = _edges(n_users=5000, n_items=300, seed=2)
    jg, tg = JGraph.from_edges(e), Graph.from_edges(e)
    _tables_equal(JFieldTables.build(jg), FieldTables.build(tg, device=CPU))
    p = tmp_path / "f.txt"
    p.write_text("".join(f"{nm} {nm[0]}\n" for nm in tg.names))
    jg.load_field_meta(str(p))
    tg.load_field_meta(str(p))
    _tables_equal(JFieldTables.build(jg, weights=jg.out_degree),
                  FieldTables.build(tg, weights=tg.out_degree, device=CPU))


@pytest.mark.parametrize("shape", [(512,), (64, 16)])
def test_negative_field_sample_bit_equal_given_u2(graphs, tmp_path, shape):
    jg, tg = graphs
    path = _meta_file(tmp_path / "field.txt", tg.names)
    jg.load_field_meta(path)
    tg.load_field_meta(path)
    jt = JFieldTables.build(jg, weights=jg.out_degree)
    tt = FieldTables.build(tg, weights=tg.out_degree, device=CPU)
    rng = np.random.default_rng(3)
    # fields 1-3, and the empty field 0 (its size guard reads its first
    # slot, as in the JAX package)
    fids = rng.integers(0, 4, shape).astype(np.int32)
    key = jax.random.PRNGKey(0)
    want = jt.negative_field_sample(key, jnp.asarray(fids))
    u2 = jax.random.uniform(key, shape + (2,))
    got = tt.negative_field_sample(None, torch.from_numpy(fids),
                                   u2=torch.from_numpy(np.array(u2)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    vids = torch.from_numpy(np.array(want))
    np.testing.assert_array_equal(tt.field_of_v(vids).numpy(),
                                  np.asarray(jt.field_of_v(jnp.asarray(
                                      np.asarray(want)))))


def test_field_matched_law_by_counts(graphs, tmp_path):
    """Draws for field f lie in f, and their frequencies follow the field's
    weight^0.75 law (out-degree)."""
    _, tg = graphs
    tg.load_field_meta(_meta_file(tmp_path / "field.txt", tg.names))
    tt = FieldTables.build(tg, weights=tg.out_degree, device=CPU)
    gen = torch.Generator().manual_seed(0)
    n = 200_000
    for f in (1, 2):
        draws = tt.negative_field_sample(
            gen, torch.full((n,), f, dtype=torch.int32)).numpy()
        assert (tg.fields[draws] == f).all()
        w = np.where(tg.fields == f, tg.out_degree, 0.0) ** 0.75
        emp = np.bincount(draws, minlength=tg.n_vertices) / n
        np.testing.assert_allclose(emp, w / w.sum(), atol=4e-3)
    draws = tt.negative_field_sample(
        gen, torch.full((1000,), 3, dtype=torch.int32)).numpy()
    assert (draws == tg.name2id[tg.names[5]]).all()  # the one-vertex field
