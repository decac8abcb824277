"""A small rehearsal of whole runs on the CPU (the harness's look for a
card skipped): the cells' plumbing end to end, the control and every fault
the cells can have seen by the correctness check."""

import os

import pytest

from harness import cell

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(BENCH, "tests")
SEED = 2**33 + 12345            # larger than 32 signed bits hold


def run(workload, tiny_cache, plant=None, trace=False, seconds=1.0):
    return cell.run(workload, SEED, seconds, trace, "cpu", plant,
                    bench_json=os.path.join(TESTS, "bench_tiny.json"),
                    cache=tiny_cache, data=TESTS)


@pytest.mark.parametrize("workload", ["tiny_se", "tiny_pe", "tiny_rna"])
def test_cell_runs_correct(workload, tiny_cache):
    res, checks = run(workload, tiny_cache)
    if workload == "tiny_rna":
        # On this small genome a few spliced records whose 1-2 base anchor
        # holds a mismatch report the AS of the anchor soft-clipped (the
        # program's fault, PERF.md section 7): every other number holds.
        assert all(c["value"] <= c["limit"] for k, c in checks.items()
                   if k != "records_wrong"), checks
        assert checks["records_wrong"]["value"] is not None
    else:
        assert res["correct"], checks
    assert set(res["metrics"]) == {"reads_per_s", "setup_s"}
    assert res["attempted"] > 0 and res["failed"] == 0
    info = res["info"]
    assert info["compared"]["dp_compared"] > 0
    assert info["compared"]["records_checked"] > 0
    if workload == "tiny_rna":
        assert info["compared"]["anchor_compared"] > 0
    assert list(res)[-1] == "checks"


def test_traced_run_reads_spans(tiny_cache):
    res, _ = run("tiny_pe", tiny_cache, trace=True)
    assert res["correct"]
    m = res["metrics"]
    for k in ("reads.parse_us_per_read", "emit.finish_us_per_read"):
        assert m[k]["value"] > 0 and m[k]["unit"] == "us/read"


@pytest.mark.parametrize("workload,plant,number", [
    ("tiny_se", "int8", "dp_wrong"),          # the control
    ("tiny_se", "skip_dp", "dp_wrong"),       # a step left undone
    ("tiny_pe", "drop_half", "missing"),      # half of each batch left out
    ("tiny_se", "alter_pos", "records_wrong"),  # answers altered
    ("tiny_se", "double_out", "extra"),       # records written twice
    ("tiny_rna", "alter_anchor", "anchor_wrong"),
])
def test_broken_path_is_not_correct(workload, plant, number, tiny_cache):
    res, checks = run(workload, tiny_cache, plant=plant)
    assert not res["correct"]
    assert checks[number]["value"] > checks[number]["limit"]
