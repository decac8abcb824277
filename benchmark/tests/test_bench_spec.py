"""BENCHMARK.json against the contract's shape, and every cell's files
found by name: configuration, traffic, limits, metric readers."""

import json
import os
import re

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_budget():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    rs = SPEC["run_seconds"]
    assert 1 <= rs <= 51
    # a full check of 24 cells fits the driver's 43,200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entries():
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[group]:
            assert NAME.match(e["name"]) and e["name"] not in names
            names.add(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"])
                assert e["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    cfg = next(c for c in SPEC["configs"] if c["name"] == w["config"])
    assert os.path.exists(os.path.join(ROOT, cfg["file"]))
    assert json.load(open(os.path.join(ROOT, cfg["file"])))["name"] == \
        cfg["name"]
    assert os.path.exists(os.path.join(BENCH, "traffic",
                                       f"{w['traffic']}.json"))
    limits = json.load(open(os.path.join(BENCH, "limits",
                                         f"{w['name']}.json")))["limits"]
    assert {"missing", "dp_wrong", "records_wrong", "misplaced"} <= set(
        limits)
    assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in SPEC["per_layer"]:
        if w["name"] in m.get("workloads", [w["name"]]):
            assert os.path.exists(os.path.join(BENCH, "metrics",
                                               f"{m['name']}.py"))
