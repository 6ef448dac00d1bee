"""The harness finds a cell, a configuration, a traffic mix and a metric as
files by the names in BENCHMARK.json: adding one file under
``perfbench/workloads/``, ``configs/``, ``traffic/`` or ``metrics/`` (and
its entry) adds it, with no edit to a file already there. And every
metric of BENCHMARK.json has a reader that declares what the entry says."""

import filecmp
import json
import os
import shutil

import pytest

from perfbench.harness import main, spec

from conftest import ROOT


def _copy(tmp_path) -> str:
    root = str(tmp_path / "checkout")
    shutil.copytree(os.path.join(ROOT, "perfbench"),
                    os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    return root


def _write(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def test_adding_files_adds_a_cell_and_a_metric(tmp_path):
    root = _copy(tmp_path)
    before = {p: open(os.path.join(root, "perfbench", p), "rb").read()
              for p in ("configs/line_o2.json", "traffic/youtube.json")}
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
    with open(os.path.join(pb, "metrics", "jobs_run.py"), "w") as f:
        f.write('NAME = "jobs_run"\nUNIT = "jobs"\nBETTER = "higher"\n'
                'SOURCE = "program_counter"\nLAYER = "harness"\n'
                'MOVES = "samples_per_s"\nWORKLOADS = ["line_o1.tiny"]\n\n'
                'def read(ctx):\n    return len(ctx.jobs)\n')
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["configs"].append({"name": "line_o1", "source": "x",
                             "file": "perfbench/configs/line_o1.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "line_o1.tiny", "config": "line_o1",
                               "traffic": "tiny", "chips": 1, "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] in ("samples_per_s", "auc", "setup_s") and \
                "workloads" in m:
            m["workloads"].append("line_o1.tiny")
    bench["per_layer"].append({"name": "jobs_run", "unit": "jobs",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "harness", "moves": "samples_per_s",
                               "workloads": ["line_o1.tiny"]})
    _write(os.path.join(root, "BENCHMARK.json"), bench)

    c = spec.cell("line_o1.tiny", root=root)
    assert c.family == "line" and c.config["init"]["order"] == 1
    assert c.traffic["graph"]["n"] == 500 and c.limits == {"miss": 0}
    assert [m["name"] for m in c.per_layer] == ["jobs_run"]
    assert {m["name"] for m in c.end_to_end} == {"samples_per_s", "auc",
                                                 "setup_s"}
    reader = spec.metric_reader("jobs_run", root=root)
    assert reader.read(type("ctx", (), {"jobs": [1, 2]})) == 2
    # nothing that was there changed
    for p, data in before.items():
        assert open(os.path.join(pb, p), "rb").read() == data
    for name in os.listdir(os.path.join(ROOT, "perfbench", "harness")):
        a = os.path.join(ROOT, "perfbench", "harness", name)
        if os.path.isfile(a):
            assert filecmp.cmp(a, os.path.join(pb, "harness", name),
                               shallow=False)


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
    assert getattr(r, "WORKLOADS", None) == entry.get("workloads")
    if layer:
        assert (r.LAYER, r.MOVES) == (entry["layer"], entry["moves"])


def test_every_cell_loads():
    b = spec.benchmark()
    for w in b["workloads"]:
        c = spec.cell(w["name"])
        assert c.family in ("line", "walk")
        assert set(c.limits) == set(main.check.NAMES)
        assert c.traffic["jobs"][c.family] and c.traffic["warm"][c.family]
        reported = {m["name"] for m in c.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert c.per_layer
        assert all(m["moves"] in reported for m in c.per_layer)
