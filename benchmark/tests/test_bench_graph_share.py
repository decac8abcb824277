"""pipeline.graph_share, the share of the SE fast step's reads replayed
from CUDA graphs: read in a small traced rehearsal on the CPU (gzipped
FASTQ, BENCHMARK.json's entry for it added to the tests' bench_tiny.json),
where the step runs eagerly and the share is 0; absent where the program
counts no SE fast step, as a program without the counters does."""

import importlib.util
import json
import os
import types

import numpy as np
import pytest

from harness import cell

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
TESTS = os.path.join(BENCH, "tests")
SEED = 2**33 + 4647
NAME = "pipeline.graph_share"


@pytest.fixture(scope="module")
def bench_json(tmp_path_factory):
    spec = json.load(open(os.path.join(TESTS, "bench_tiny.json")))
    full = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    spec["per_layer"] += [{k: v for k, v in m.items() if k != "workloads"}
                          for m in full["per_layer"] if m["name"] == NAME]
    p = tmp_path_factory.mktemp("spec") / "bench.json"
    p.write_text(json.dumps(spec))
    return str(p)


def test_graph_share_se(bench_json, tiny_cache):
    res, _ = cell.run("tiny_se", SEED, 1.0, True, "cpu", None,
                      bench_json=bench_json, cache=tiny_cache, data=TESTS)
    assert res["correct"]
    got = res["metrics"][NAME]
    assert got["unit"] == "share"
    assert 0.0 <= got["value"] <= 1.0
    assert got["value"] == 0.0          # the CPU runs the step eagerly


def test_graph_share_absent_without_the_counters(tmp_path):
    """cli.align.main under the tracer on pairs, which never take the SE
    fast step: the spans are there, the counters are not, and the
    metric's own reader gives nothing."""
    from hisat2_tpu_torch.cli import align as cli_align
    from hisat2_tpu_torch.cli import build as cli_build
    from hisat2_tpu_torch.utils import metrics
    g = "".join(np.random.default_rng(4).choice(list("ACGT"), 20000))
    (tmp_path / "g.fa").write_text(f">c\n{g}\n")
    idx = str(tmp_path / "idx")
    assert cli_build.main([str(tmp_path / "g.fa"), idx, "--quiet"]) == 0
    comp = str.maketrans("ACGT", "TGCA")
    (tmp_path / "r1.fa").write_text("".join(
        f">p{i}\n{g[i * 300:i * 300 + 100]}\n" for i in range(40)))
    (tmp_path / "r2.fa").write_text("".join(
        f">p{i}\n{g[i * 300 + 200:i * 300 + 300][::-1].translate(comp)}\n"
        for i in range(40)))
    spec = importlib.util.spec_from_file_location(
        "graph_share", os.path.join(BENCH, "metrics", NAME + ".py"))
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    metrics.start_trace()
    assert cli_align.main(["-x", idx, "-f", "-1", str(tmp_path / "r1.fa"),
                           "-2", str(tmp_path / "r2.fa"),
                           "-S", str(tmp_path / "o.sam"),
                           "--no-spliced-alignment", "--device", "cpu"]) == 0
    ctx = types.SimpleNamespace(reads=80, spans=[])
    assert reader.read(ctx) is None
    # the trace was there: the reader found spans but no step_reads
    from harness import program
    p = program.collect(ctx)
    assert p is not None and p.spans
    assert "step_reads" not in p.counters
