"""The node2vec cells' own checks: the second-order law check fails a walk
of the wrong law (p and q swapped; the bias ignored, p = q = 1) by a clear
margin while the program's walk passes it, at each cell's tiny sizes on the
CPU; the node2vec readers read nothing in a cell of another family."""

import types

import pytest
import torch

from perfbench.harness import main, spec

import tiny

CELLS = ["node2vec.youtube", "node2vec.flickr"]
CPU = torch.device("cpu")


def _law_fault(monkeypatch, swap: bool):
    """The model's walk drawn at p and q swapped, or at p = q = 1, where
    the configuration says otherwise; planted before the harness's hooks,
    so that they record the broken walk."""
    from smore_tpu_torch.models import node2vec

    orig = node2vec.node2vec_walk

    def broken(tables, nbr, gen, starts, steps, p=1.0, q=1.0, *a, **kw):
        p, q = (q, p) if swap else (1.0, 1.0)
        return orig(tables, nbr, gen, starts, steps, p, q, *a, **kw)

    monkeypatch.setattr(node2vec, "node2vec_walk", broken)


def _readings(name: str, seed: int = 2**31 + 5):
    c = tiny.cell(name)
    st = main.set_up(c, seed, CPU)
    return c, main.output_check(st, c, CPU)["program"]


@pytest.mark.parametrize("name", CELLS)
def test_the_program_walk_passes_the_second_order_check(name):
    c, r = _readings(name)
    z = {k: v for k, v in r["detail"]["z"].items()
         if k.startswith("second_order.")}
    assert set(z) == {"second_order.return", "second_order.near",
                      "second_order.far"}
    assert max(abs(v) for v in z.values()) < c.limits["draw_z"] / 3, z
    assert r["miss"] == 0


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("swap", [True, False], ids=["p_q_swapped",
                                                      "bias_ignored"])
def test_a_walk_of_the_wrong_law_fails_the_second_order_check(
        monkeypatch, name, swap):
    _law_fault(monkeypatch, swap)
    c, r = _readings(name)
    z = max(abs(v) for k, v in r["detail"]["z"].items()
            if k.startswith("second_order."))
    assert z > 2 * c.limits["draw_z"], r["detail"]["z"]
    assert r["draw_z"] > c.limits["draw_z"]
    # the exact check sees it too: the reference walks at the configured
    # p and q
    assert r["miss"] > 0


@pytest.mark.parametrize("metric", ["n2v_walk_pct", "n2v_walk_roofline_pct"])
def test_the_readers_read_nothing_in_another_family(metric):
    reader = spec.metric_reader(metric)
    walk = spec.family("walk")
    n2v = spec.family("node2vec")
    trace = types.SimpleNamespace(
        busy_s=2.0, kernels={"random_walk_steps": (0.5, 10),
                             "elementwise": (1.5, 100)})
    rec = types.SimpleNamespace()
    for fam, tr in ((walk, trace), (walk, None), (n2v, None)):
        ctx = types.SimpleNamespace(trace=tr, family=fam, recorder=rec,
                                    cell=None)
        assert reader.read(ctx) is None
    # a node2vec trace: the kernel's share, and its roofline share once
    # the output check has counted a launch's bytes
    trace.kernels["_anon::node2vec_walk_steps(int*)"] = (0.5, 10)
    rec.n2v_launch_bytes = 3.35e6  # 1 us at 3.35 TB/s
    got = reader.read(types.SimpleNamespace(trace=trace, family=n2v,
                                            recorder=rec, cell=None))
    want = 25.0 if metric == "n2v_walk_pct" else 100.0 * 1e-3 / 50.0
    assert got == pytest.approx(want)
