"""The benchmark's data, found by name.

``BENCHMARK.json`` at the checkout's root names the cells, the
configurations and the metrics; each is a file of its own under
``perfbench/``:

- a cell: ``workloads/<cell>.json``: the limits of its output check, the
  call its replay check keeps (``replay``, optional), its own job and
  warm-up budgets (``jobs``, ``warm``: ``job()`` keyword arguments,
  optional: the traffic's budgets for the family where absent) and its
  sizes for the CPU tests (``tiny``, which a run on the card never reads);
- a configuration: the ``file`` that BENCHMARK.json gives it (the model's
  published settings and the family that drives it);
- a traffic mix: ``traffic/<traffic>.json`` (the graph's law and sizes,
  the job's and the warm-up's budgets per family);
- a metric: ``metrics/<name>.py``, a reader with its declarations; the
  cells it applies to are the ``workloads`` of its BENCHMARK.json entry,
  and only there;
- a family of models: ``harness/families/<family>.py``.

Adding a cell, a configuration, a traffic mix, a family or a metric adds
files and entries, and appends the cell's name to the ``workloads`` lists
of the metrics it reports; no file already there changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from types import ModuleType
from typing import List

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str) -> ModuleType:
    """A module from a file whose name may hold dots (``metrics/x.y.py``)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    entry: dict  # the workloads entry of BENCHMARK.json
    config: dict  # the configuration's file
    traffic: dict  # traffic/<traffic>.json
    work: dict  # workloads/<cell>.json
    end_to_end: List[dict]  # the cell's end-to-end metrics
    per_layer: List[dict]  # the cell's per-layer metrics
    root: str  # the checkout the cell was read from

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    @property
    def family(self) -> str:
        return self.config["family"]

    @property
    def limits(self) -> dict:
        return self.work["limits"]

    @property
    def replay(self) -> dict:
        """The call the replay check keeps (``from_end``), or {}."""
        return self.work.get("replay", {})

    @property
    def budget(self) -> dict:
        """A job's ``job()`` keyword arguments: the cell's own, else the
        traffic's for the family."""
        return self._budget("jobs")

    @property
    def warm(self) -> dict:
        """Set-up's warm ``train()``'s, the same way."""
        return self._budget("warm")

    def _budget(self, key: str) -> dict:
        if key in self.work:
            return self.work[key]
        return self.traffic[key][self.family]


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: dict, cell: str, reported: set) -> bool:
    """A metric with ``workloads`` applies to those cells; one without, to
    every cell that reports the end-to-end metric it moves (or, for an
    end-to-end metric, to every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def cell(name: str, root: str = ROOT) -> Cell:
    bench = benchmark(root)
    here = os.path.join(root, "perfbench")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(entries)})")
    entry = entries[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    work = _json(os.path.join(here, "workloads", f"{name}.json"))
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, name, reported)]
    return Cell(
        name=name,
        entry=entry,
        config=_json(os.path.join(root, cfg_entry["file"])),
        traffic=_json(os.path.join(here, "traffic",
                                   f"{entry['traffic']}.json")),
        work=work,
        end_to_end=e2e,
        per_layer=per_layer,
        root=root,
    )


def metric_reader(name: str, root: str = ROOT) -> ModuleType:
    return load_module(os.path.join(root, "perfbench", "metrics",
                                    f"{name}.py"),
                       f"perfbench_metric_{name.replace('.', '_')}")


def family_path(name: str, root: str = ROOT) -> str:
    return os.path.join(root, "perfbench", "harness", "families",
                        f"{name}.py")


def family(name: str, root: str = ROOT) -> ModuleType:
    """The family's module, from its file in the checkout at ``root``."""
    return load_module(family_path(name, root), f"perfbench_family_{name}")
