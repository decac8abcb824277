"""reads.block_share, the read layer's share of reads that the native FASTQ
block parser put into their batch: 1 in a small traced rehearsal on the
CPU (gzipped FASTQ, BENCHMARK.json's entry for it added to the tests'
bench_tiny.json); on FASTA input, which goes read by read, absent or
below 1."""

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
SEED = 2**33 + 4243
NAME = "reads.block_share"


@pytest.fixture(scope="module")
def bench_json(tmp_path_factory):
    spec = json.load(open(os.path.join(TESTS, "bench_tiny.json")))
    full = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    spec["per_layer"] += [{k: v for k, v in m.items() if k != "workloads"}
                          for m in full["per_layer"] if m["name"] == NAME]
    p = tmp_path_factory.mktemp("spec") / "bench.json"
    p.write_text(json.dumps(spec))
    return str(p)


def test_block_share_fastq(bench_json, tiny_cache):
    res, _ = cell.run("tiny_se", SEED, 1.0, True, "cpu", None,
                      bench_json=bench_json, cache=tiny_cache, data=TESTS)
    assert res["correct"]
    assert res["metrics"][NAME]["value"] == 1.0
    assert res["metrics"][NAME]["unit"] == "share"


def test_block_share_fasta(tmp_path):
    """cli.align.main under the tracer on FASTA reads, read by the
    metric's own reader."""
    from hisat2_tpu_torch.cli import align as cli_align
    from hisat2_tpu_torch.cli import build as cli_build
    from hisat2_tpu_torch.utils import metrics
    g = "".join(np.random.default_rng(3).choice(list("ACGT"), 20000))
    (tmp_path / "g.fa").write_text(f">c\n{g}\n")
    idx = str(tmp_path / "idx")
    assert cli_build.main([str(tmp_path / "g.fa"), idx, "--quiet"]) == 0
    (tmp_path / "r.fa").write_text("".join(
        f">r{i}\n{g[i * 150:i * 150 + 100]}\n" for i in range(40)))
    spec = importlib.util.spec_from_file_location(
        "block_share", os.path.join(BENCH, "metrics", NAME + ".py"))
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    metrics.start_trace()
    assert cli_align.main(["-x", idx, "-f", "-U", str(tmp_path / "r.fa"),
                           "-S", str(tmp_path / "o.sam"),
                           "--no-spliced-alignment", "--device", "cpu"]) == 0
    share = reader.read(types.SimpleNamespace(reads=40, spans=[]))
    assert share is None or share < 1
