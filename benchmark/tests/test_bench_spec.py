"""BENCHMARK.json against the contract's rules on names, units and shape,
and every file it names present."""

import os
import re

import pytest

from benchmark.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = spec.benchmark()


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(spec.CHECKOUT,
                                        "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert all(PATH.match(p) for p in BENCH["paths"])


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda e: e["name"])
def test_names_units_and_lines(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert _line(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in SOURCES
    for key in entry.get("reduced", []):
        assert NAME.match(key)


def test_names_unique_and_references_hold():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in BENCH[k]]
    assert len(names) == len(set(names))
    configs = {c["name"] for c in BENCH["configs"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert configs == {w["config"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells)
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4)
        c = spec.Cell(w["name"], BENCH)
        reported = {m["name"] for m in c.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert c.per_layer


def test_files_named_exist_and_readers_load():
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/")
        assert os.path.isfile(os.path.join(spec.CHECKOUT, c["file"]))
    for w in BENCH["workloads"]:
        cell = spec.Cell(w["name"], BENCH)
        assert cell.traffic["loop"] in ("stream", "eval", "train")
        assert set(cell.limits)
    for m in BENCH["per_layer"]:
        assert callable(spec.reader(m["name"]))
    assert spec.kernel_patterns("attention")
    assert spec.kernel_patterns("knn")


def test_rooflines_and_mfu_are_named_so():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"]:
            assert re.match(r"^\w+_roofline(\.|$)", m["name"])
            assert m["unit"] == "%"
        if "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_config_files_state_source_and_cuts():
    import yaml
    for c in BENCH["configs"]:
        with open(os.path.join(spec.CHECKOUT, c["file"])) as f:
            raw = yaml.safe_load(f)
        assert raw["source"] == c["source"]
        assert raw["reduced"] == c["reduced"]
        assert all(k in raw["assumed"] for k in c["reduced"])
