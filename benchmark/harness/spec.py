"""What a run is made of, found by name from ``BENCHMARK.json``: the cell's
configuration file, its traffic file, its limits, its metrics' readers
and the kernel-name tables of each layer.

Layout under ``benchmark/`` (each a file of its own, so that a later cell,
metric or kernel is a new file and no edit):

* ``configs/<config>.yaml``: the program's config plus ``source``,
  ``reduced`` and ``assumed``;
* ``traffic/<traffic>.json``: the generator's parameters and the loop;
* ``limits/<workload>.json``: each compared number's limit;
* ``metrics/<metric>.py``: ``read(run)`` → a number or None;
* ``kernels/<layer>.<implementation>.json``: ``{"patterns": [regex, ...]}``
  naming the device kernels that make up the layer.
"""

from __future__ import annotations

import glob
import importlib.util
import json
import os
import re

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(ROOT)


def _json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(path=None) -> dict:
    return _json(path or os.path.join(CHECKOUT, "BENCHMARK.json"))


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, name: str, bench: dict):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(there are {sorted(cells)})")
        self.name = name
        self.workload = cells[name]
        config = {c["name"]: c for c in bench["configs"]}[
            self.workload["config"]]
        self.config_path = os.path.join(CHECKOUT, config["file"])
        self.traffic = _json(os.path.join(
            ROOT, "traffic", self.workload["traffic"] + ".json"))
        self.limits = _json(os.path.join(ROOT, "limits", name + ".json"))
        self.end_to_end = _metrics(bench["end_to_end"], name)
        self.per_layer = _metrics(bench["per_layer"], name)


def _metrics(entries, cell):
    return [m for m in entries if cell in m.get("workloads", [cell])]


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = os.path.join(ROOT, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + re.sub(r"\W", "_", metric), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def kernel_patterns(layer: str):
    """The compiled name patterns of every table of ``layer``."""
    out = []
    for path in sorted(glob.glob(os.path.join(ROOT, "kernels",
                                              layer + ".*.json"))):
        out += [re.compile(p) for p in _json(path)["patterns"]]
    return out
