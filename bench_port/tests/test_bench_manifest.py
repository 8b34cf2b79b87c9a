"""BENCHMARK.json against the contract's shape, and every file it names."""

import json
import math
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
HERE = os.path.join(ROOT, "bench_port")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
METRIC_KEYS = {"name", "unit", "better", "source"}


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level(manifest):
    assert set(manifest) == KEYS
    assert manifest["paths"] == ["bench_port"]
    assert 1 <= manifest["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w
               for w in manifest["command"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_names_units_and_lines(manifest):
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in manifest[group]:
            assert NAME.match(e["name"]), e["name"]
            assert (group, e["name"]) not in seen
            seen.add((group, e["name"]))
            for key in ("why", "layer", "source"):
                if key in e and group != "end_to_end":
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                        and "\t" not in e[key]
    for e in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


def test_end_to_end(manifest):
    names = {m["name"] for m in manifest["end_to_end"]}
    assert "setup_s" in names
    for m in manifest["end_to_end"]:
        assert set(m) <= METRIC_KEYS | {"bound", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert os.path.isfile(os.path.join(HERE, "metrics",
                                           m["name"] + ".py"))


def test_every_layer_metric_moves_a_metric_of_its_cells(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells))
           for m in manifest["end_to_end"]}
    layers = {}
    for m in manifest["per_layer"]:
        assert set(m) <= METRIC_KEYS | {"layer", "moves", "workloads"}
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells and cell in e2e[m["moves"]]
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], set()).add(m["name"])
        assert os.path.isfile(os.path.join(HERE, "metrics",
                                           m["name"] + ".py"))
    for cell in cells:
        reported = [m for m in manifest["per_layer"]
                    if cell in m.get("workloads", cells)]
        assert reported, cell
        assert any(m["name"] != "setup_s" and cell in cs
                   for m, cs in ((m, e2e[m["name"]])
                                 for m in manifest["end_to_end"]))


def test_configs_and_cells(manifest):
    used = {w["config"] for w in manifest["workloads"]}
    files = set()
    for c in manifest["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("bench_port/") and c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as f:
            doc = json.load(f)
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in doc and key in doc["reduced"]
            assert not key.endswith(("_dim", "_rank", "_size"))
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = [w for w in manifest["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, math.floor(0.25 * len(pairs)))
    for w in manifest["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        for sub, name in (("traffic", w["traffic"]), ("limits", w["name"])):
            assert os.path.isfile(os.path.join(HERE, sub, name + ".json"))


def test_every_cell_holds_its_numbers_to_limits(manifest):
    for w in manifest["workloads"]:
        with open(os.path.join(HERE, "limits", w["name"] + ".json")) as f:
            lim = json.load(f)["numbers"]
        assert lim
        for name, d in lim.items():
            assert NAME.match(name)
            assert d["limit"] is not None and d["limit"] >= 0
            assert d["lower"] <= d["limit"] < d["upper"]
