"""The RNA cell's rehearsal on the CPU (tiny_rna, the same traffic mix as
chr22_rna_pe100 on a small graph, transcript-aware genome): correct in
every number, records_wrong included; and a traced run reads the splice
layer's per-layer metrics, BENCHMARK.json's entries for them added to the
tests' bench_tiny.json. ops.anchor_roofline needs the card's trace and
is absent here."""

import json
import os

import pytest

from harness import cell

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
TESTS = os.path.join(BENCH, "tests")
SEED = 2**33 + 19019
SPLICE = ("splice.stage_us_per_read", "splice.fin_us_per_read",
          "splice.rescue_us_per_read")
NEW = SPLICE + ("ops.anchor_roofline",)


@pytest.fixture(scope="module")
def bench_json(tmp_path_factory):
    spec = json.load(open(os.path.join(TESTS, "bench_tiny.json")))
    full = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    spec["per_layer"] += [{k: v for k, v in m.items() if k != "workloads"}
                          for m in full["per_layer"] if m["name"] in NEW]
    p = tmp_path_factory.mktemp("spec") / "bench.json"
    p.write_text(json.dumps(spec))
    return str(p)


def test_new_entries_name_the_rna_cell():
    full = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cell_ = next(w for w in full["workloads"]
                 if w["name"] == "chr22_rna_pe100")
    assert (cell_["config"], cell_["traffic"], cell_["chips"]) == (
        "chr22_snp_tran", "rna_pe100", 1)
    got = {m["name"]: m for m in full["per_layer"] if m["name"] in NEW}
    assert set(got) == set(NEW)
    for m in got.values():
        assert m["workloads"] == ["chr22_rna_pe100"]
        assert m["moves"] == "reads_per_s"


@pytest.mark.parametrize("trace", [False, True], ids=["plain", "traced"])
def test_tiny_rna_correct_and_traced(bench_json, tiny_cache, trace):
    res, checks = cell.run("tiny_rna", SEED + trace, 1.0, trace, "cpu",
                           None, bench_json=bench_json, cache=tiny_cache,
                           data=TESTS)
    assert res["correct"], checks
    assert checks["records_wrong"]["value"] == 0
    assert res["info"]["compared"]["records_checked"] > 0
    assert res["info"]["compared"]["anchor_compared"] > 0
    m = res["metrics"]
    if not trace:
        assert set(m) == {"reads_per_s", "setup_s"}
        return
    for k in SPLICE:
        assert m[k]["value"] > 0 and m[k]["unit"] == "us/read", k
    assert "ops.anchor_roofline" not in m       # no device trace here
