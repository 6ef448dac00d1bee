"""The harness finds a cell, a configuration, a traffic mix, a family and a
metric as files by the names in BENCHMARK.json: adding one file under
``perfbench/workloads/``, ``configs/``, ``traffic/``, ``harness/families/``
or ``metrics/`` (and its entry, and the cell's name in the ``workloads``
lists of the metrics it reports) adds it, with no edit to a file already
there. Every metric of BENCHMARK.json has a reader that declares what the
entry says, and no reader keeps a list of cells of its own."""

import json
import os
import shutil
import time

import pytest
import torch

from perfbench.harness import main, spec

import tiny
from conftest import ROOT

# what main, replay, check and the readers use of a family's module
FAMILY_INTERFACE = ("WORK", "build", "job", "hooks", "derived", "flops",
                    "law_checks")


def _copy(tmp_path) -> str:
    root = str(tmp_path / "checkout")
    shutil.copytree(os.path.join(ROOT, "perfbench"),
                    os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    return root


def _files(root: str) -> dict:
    """Every file of the checkout at ``root`` (bytecode caches aside) and
    its bytes."""
    out = {}
    for d, dirs, names in os.walk(root):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _write(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        if isinstance(obj, str):
            f.write(obj)
        else:
            json.dump(obj, f)


def _bench(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _append(bench: dict, cell: str, names) -> None:
    """The cell's name appended to the ``workloads`` lists of the metrics
    ``names`` (a metric without one applies to every cell already)."""
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in names and "workloads" in m:
            m["workloads"].append(cell)


def test_adding_files_adds_a_cell_and_a_metric(tmp_path):
    root = _copy(tmp_path)
    before = _files(root)
    pb = os.path.join(root, "perfbench")
    _write(os.path.join(pb, "configs", "line_o1.json"),
           {"name": "line_o1", "family": "line", "init": {"dim": 64,
                                                          "order": 1},
            "train": {"negative_samples": 5, "alpha": 0.025},
            "assumed": {"shared_negatives": 128}, "reduced": []})
    _write(os.path.join(pb, "traffic", "tiny.json"),
           {"graph": {"law": "community", "n": 500, "e": 4000,
                      "n_comm": 5},
            "jobs": {"line": {"sample_times": 0.1}},
            "warm": {"line": {"sample_times": 0.05}}})
    _write(os.path.join(pb, "workloads", "line_o1.tiny.json"),
           {"limits": {"miss": 0}})
    _write(os.path.join(pb, "metrics", "jobs_run.py"),
           'NAME = "jobs_run"\nUNIT = "jobs"\nBETTER = "higher"\n'
           'SOURCE = "program_counter"\nLAYER = "harness"\n'
           'MOVES = "samples_per_s"\n\n'
           'def read(ctx):\n    return len(ctx.jobs)\n')
    bench = _bench(root)
    bench["configs"].append({"name": "line_o1", "source": "x",
                             "file": "perfbench/configs/line_o1.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "line_o1.tiny", "config": "line_o1",
                               "traffic": "tiny", "chips": 1, "why": "x"})
    _append(bench, "line_o1.tiny", ("samples_per_s", "auc", "setup_s"))
    bench["per_layer"].append({"name": "jobs_run", "unit": "jobs",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "harness", "moves": "samples_per_s",
                               "workloads": ["line_o1.tiny"]})
    _write(os.path.join(root, "BENCHMARK.json"), bench)

    c = spec.cell("line_o1.tiny", root=root)
    assert c.family == "line" and c.config["init"]["order"] == 1
    assert c.traffic["graph"]["n"] == 500 and c.limits == {"miss": 0}
    # no budget of its own: the traffic's for the family
    assert (c.budget, c.warm) == ({"sample_times": 0.1},
                                  {"sample_times": 0.05})
    assert [m["name"] for m in c.per_layer] == ["jobs_run"]
    assert {m["name"] for m in c.end_to_end} == {"samples_per_s", "auc",
                                                 "setup_s"}
    reader = spec.metric_reader("jobs_run", root=root)
    assert reader.read(type("ctx", (), {"jobs": [1, 2]})) == 2
    after = _files(root)
    for p, data in before.items():
        if p != "BENCHMARK.json":
            assert after[p] == data, p


def test_a_cell_of_a_new_family_runs_from_new_files(tmp_path):
    """A family file of a new name (driving DeepWalk), its configuration,
    a cell with a budget and tiny sizes of its own on an existing traffic
    mix, and a per-layer reader: new files, new entries and the cell's
    name appended to ``walks_per_s``'s list. The cell runs to a correct
    result line on the CPU, untraced and traced, and every file that was
    in the checkout is unchanged."""
    root = _copy(tmp_path)
    before = _files(root)
    pb = os.path.join(root, "perfbench")
    _write(os.path.join(pb, "harness", "families", "walk_twin.py"),
           '"""DeepWalk jobs under a family name of their own."""\n\n'
           "from perfbench.harness.families.walk import (  # noqa: F401\n"
           "    WORK, build, derived, flops, hooks, job, law_checks)\n")
    with open(os.path.join(pb, "configs", "deepwalk.json")) as f:
        config = json.load(f)
    _write(os.path.join(pb, "configs", "deepwalk_twin.json"),
           dict(config, name="deepwalk_twin", family="walk_twin"))
    with open(os.path.join(pb, "workloads", "deepwalk.youtube.json")) as f:
        work = json.load(f)
    _write(os.path.join(pb, "workloads", "deepwalk_twin.youtube.json"),
           dict(work, jobs={"walk_times": 0.5}, warm={"walk_times": 0.125}))
    _write(os.path.join(pb, "metrics", "calls_per_job.py"),
           'NAME = "calls_per_job"\nUNIT = "calls"\nBETTER = "lower"\n'
           'SOURCE = "program_counter"\nLAYER = "driver"\n'
           'MOVES = "walks_per_s"\n\n'
           'def read(ctx):\n'
           '    return sum(j["calls"] for j in ctx.jobs) / len(ctx.jobs)\n')
    bench = _bench(root)
    bench["configs"].append({"name": "deepwalk_twin", "source": "x",
                             "file": "perfbench/configs/deepwalk_twin.json",
                             "reduced": [], "why": "x"})
    name = "deepwalk_twin.youtube"
    bench["workloads"].append({"name": name, "config": "deepwalk_twin",
                               "traffic": "youtube", "chips": 1, "why": "x"})
    _append(bench, name, ("walks_per_s", "auc", "setup_s"))
    bench["per_layer"].append({"name": "calls_per_job", "unit": "calls",
                               "better": "lower",
                               "source": "program_counter",
                               "layer": "driver", "moves": "walks_per_s",
                               "workloads": [name]})
    _write(os.path.join(root, "BENCHMARK.json"), bench)

    c = spec.cell(name, root=root)
    assert c.family == "walk_twin" and c.root == root
    assert (c.budget, c.warm) == ({"walk_times": 0.5}, {"walk_times": 0.125})
    assert name in tiny.names(root)
    assert {m["name"] for m in c.end_to_end} == {"walks_per_s", "auc",
                                                 "setup_s"}
    assert [m["name"] for m in c.per_layer] == ["calls_per_job"]
    lines = {}
    for traced in (False, True):
        r = main.run_cell(tiny.cell(name, root), 2**31 + 77, 0.1, traced,
                          torch.device("cpu"), time.perf_counter())
        assert r["correct"] is True, r["checks"]
        lines[traced] = r
    assert set(lines[False]["metrics"]) == {"walks_per_s", "auc", "setup_s"}
    assert set(lines[True]["metrics"]) == {"calls_per_job"}
    after = _files(root)
    for p, data in before.items():
        if p != "BENCHMARK.json":
            assert after[p] == data, p


def _metrics():
    b = spec.benchmark()
    return ([(m, False) for m in b["end_to_end"]]
            + [(m, True) for m in b["per_layer"]])


@pytest.mark.parametrize("entry,layer", _metrics(),
                         ids=lambda x: x["name"] if isinstance(x, dict)
                         else str(x))
def test_every_metric_has_its_reader(entry, layer):
    r = spec.metric_reader(entry["name"])
    assert (r.NAME, r.UNIT, r.BETTER, r.SOURCE) == (
        entry["name"], entry["unit"], entry["better"], entry["source"])
    # the cells a metric applies to are BENCHMARK.json's alone
    assert not hasattr(r, "WORKLOADS")
    if layer:
        assert (r.LAYER, r.MOVES) == (entry["layer"], entry["moves"])


def test_every_cell_loads():
    b = spec.benchmark()
    for w in b["workloads"]:
        c = spec.cell(w["name"])
        assert os.path.isfile(spec.family_path(c.family)), c.family
        fam = spec.family(c.family)
        assert all(hasattr(fam, k) for k in FAMILY_INTERFACE), c.family
        assert set(c.limits) == set(main.check.NAMES)
        assert c.budget and c.warm
        reported = {m["name"] for m in c.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert c.per_layer
        assert all(m["moves"] in reported for m in c.per_layer)


@pytest.mark.parametrize("name", tiny.names())
def test_every_cell_has_tiny_sizes(name):
    """The CPU tests (control, faults) run every cell at its ``tiny``
    sizes; a cell without them fails here."""
    small = spec.cell(name).work.get("tiny")
    assert small is not None, f"{name} has no tiny sizes"
    assert {"graph", "jobs", "warm"} <= set(small) <= {"graph", "jobs",
                                                       "warm", "train"}


def _limits(grad, change, step, rgap, rdiff):
    return {"grad_gap": grad, "change_gap": change, "step_diff": step,
            "table_err": 1e-4, "draw_z": 15.0, "miss": 0.0,
            "replay_gap": rgap, "replay_diff": rdiff, "replay_rng": 0.0}


# the four first cells as they read before budgets moved into cell files
PINNED = {
    "line_o2.youtube": ({"sample_times": 400}, {"sample_times": 1},
                        _limits(3e-7, 1e-7, 1e-5, 2e-7, 1e-5), {}),
    "deepwalk.youtube": ({"walk_times": 1}, {"walk_times": 0.25},
                         _limits(4e-7, 2e-6, 2e-5, 1e-5, 1.5e-5),
                         {"from_end": 8}),
    "line_o2.flickr": ({"sample_times": 100}, {"sample_times": 12},
                       _limits(1e-7, 4e-6, 4e-5, 2e-7, 5e-6), {}),
    "deepwalk.flickr": ({"walk_times": 10}, {"walk_times": 3},
                        _limits(2e-8, 4e-7, 1e-5, 2e-7, 1e-5), {}),
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_the_first_cells_read_as_before(name):
    c = spec.cell(name)
    assert (c.budget, c.warm, c.limits, c.replay) == PINNED[name]


def test_every_pair_of_config_and_traffic_is_one_cell():
    pairs = [(w["config"], w["traffic"])
             for w in spec.benchmark()["workloads"]]
    assert len(pairs) == len(set(pairs)), pairs


def test_the_10m_cell_runs_10m_jobs_on_the_youtube_graph():
    # the same graph and warm-up as line_o2.youtube; only the job is shorter
    short, full = spec.cell("line_o2.youtube.10m"), spec.cell("line_o2.youtube")
    assert short.traffic["graph"] == full.traffic["graph"]
    assert short.traffic["source"] == full.traffic["source"]
    assert short.config == full.config and short.warm == full.warm
    assert short.budget == {"sample_times": 10}
