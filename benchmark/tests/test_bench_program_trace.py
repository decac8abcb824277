"""The metrics that read the program's own tracer (harness/program.py), in
a small traced rehearsal on the CPU: BENCHMARK.json's entries for them
added to the tests' bench_tiny.json, the readings' bounds against the
harness's wrapper metrics, the breakdown's idle gaps labelled with
program spans, and a program without a tracer (an older checkout) leaving
them out; and the window's opening cutting the read layer's first step."""

import json
import os

import pytest

from harness import cell, program, trace

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
TESTS = os.path.join(BENCH, "tests")
SEED = 2**33 + 4242
NEW = ("reads.offcpu_us_per_read", "pipeline.submit_offcpu_us_per_read",
       "stream.wait_us_per_read", "emit.fetch_us_per_read",
       "emit.slow_read_share", "setup.kernel_build_s",
       "reads.source_us_per_read", "pipeline.pack_us_per_read",
       "pipeline.step_us_per_read", "pipeline.d2h_us_per_read",
       "stream.write_us_per_read", "emit.native_us_per_read",
       "emit.ladder_us_per_read")


@pytest.fixture(scope="module")
def bench_json(tmp_path_factory):
    spec = json.load(open(os.path.join(TESTS, "bench_tiny.json")))
    full = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for m in full["per_layer"]:
        if m["name"] in NEW:
            spec["per_layer"].append({k: v for k, v in m.items()
                                      if k != "workloads"})
    p = tmp_path_factory.mktemp("spec") / "bench.json"
    p.write_text(json.dumps(spec))
    return str(p)


def run(bench_json, tiny_cache):
    return cell.run("tiny_se", SEED, 1.0, True, "cpu", None,
                    bench_json=bench_json, cache=tiny_cache, data=TESTS)


def test_program_metrics_in_traced_run(bench_json, tiny_cache):
    res, _ = run(bench_json, tiny_cache)
    assert res["correct"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(NEW) <= set(m)
    assert 0 <= m["reads.offcpu_us_per_read"] < m["reads.parse_us_per_read"]
    assert (0 <= m["pipeline.submit_offcpu_us_per_read"]
            < m["pipeline.submit_us_per_read"])
    assert m["stream.wait_us_per_read"] >= 0
    assert 0 <= m["emit.fetch_us_per_read"] < m["emit.finish_us_per_read"]
    assert 0 <= m["emit.slow_read_share"] <= 1
    assert m["setup.kernel_build_s"] == 0        # nothing built on the CPU
    # the parts of the wrapper metrics' calls, each inside its whole
    assert 0 < m["reads.source_us_per_read"] < m["reads.parse_us_per_read"]
    parts = [m[f"pipeline.{k}_us_per_read"] for k in ("pack", "step", "d2h")]
    assert min(parts) > 0
    assert sum(parts) < m["pipeline.submit_us_per_read"]
    parts = [m[f"emit.{k}_us_per_read"] for k in ("fetch", "native", "ladder")]
    assert m["emit.native_us_per_read"] > 0 and min(parts) >= 0
    assert sum(parts) < m["emit.finish_us_per_read"]
    assert m["stream.write_us_per_read"] > 0
    for k in NEW:
        want = "us/read" if k.endswith("per_read") else (
            "s" if k.endswith("_s") else "share")
        assert res["metrics"][k]["unit"] == want

    # the breakdown labels a gap with the innermost span of the harness's
    # and the program's together: a gap inside a program span named there
    ctx, prog = program._last[0]
    inner = [s for s in prog.spans if s.main and s.name in (
        "submit.pack", "submit.step", "submit.d2h", "stream.wait")][:10]
    assert inner
    lo = min(s[2] for s in ctx.spans)
    hi = max(s[3] for s in ctx.spans)
    mids = sorted((s.t0 + s.t1) // 2 for s in inner)
    edges = [lo] + [x for t in mids for x in (t, t + 1)] + [hi]
    tr = trace.Trace(ops=[("k", edges[i], edges[i + 1], "kernel")
                          for i in range(0, len(edges), 2)],
                     window=(lo, hi), offset=0)
    labels = [k for k, _ in trace.breakdown(tr, ctx.spans)["idle_gaps"]]
    assert sorted(labels) == sorted(s.name for s in inner)


def test_program_without_tracer_is_left_out(bench_json, tiny_cache,
                                            monkeypatch):
    from hisat2_tpu_torch.utils import metrics
    monkeypatch.delattr(metrics, "start_trace")
    monkeypatch.delattr(metrics, "stop_trace")
    res, _ = run(bench_json, tiny_cache)
    assert res["correct"]
    assert not set(NEW) & set(res["metrics"])
    assert {"reads.parse_us_per_read", "pipeline.submit_us_per_read",
            "emit.finish_us_per_read"} <= set(res["metrics"])


def test_window_opens_at_the_first_reads_open():
    """Spans that end before the read layer's first opening of a reads
    file are left out; the step that holds the opening counts from it on,
    wall and thread CPU."""
    from hisat2_tpu_torch.utils.metrics import Span

    def sp(name, i, parent, t0, t1, cpu0, cpu_ns, main=True):
        return Span(name, None, i, parent, 1, main, t0, t1, cpu0, cpu_ns)
    got = {"spans": [
        sp("submit", 0, None, 0, 50, 0, 40),           # before the window
        sp("input.open", 2, 1, 400, 410, 300, 5),
        sp("reads", 1, None, 100, 1000, 200, 600),
        sp("finish", 3, None, 380, 900, 0, 100, main=False),
        sp("reads", 4, None, 1000, 1500, 800, 400)],
        "counters": {"reads_finished": 10}}
    p = program.Program(got, reads=10)
    by = {s.id: s for s in p.spans}
    assert set(by) == {1, 2, 3, 4}
    assert (by[1].t0, by[1].t1, by[1].cpu_ns) == (400, 1000, 500)
    assert p.offcpu_ns("reads") == (600 - 500) + (500 - 400)
    assert p.wall_ns("finish") == 520
    assert p.per_read_us(p.wall_ns("reads", main=True)) == 1100 / 1e3 / 10


def test_trace_check_figures(bench_json, tiny_cache, tmp_path):
    """benchmark/trace_check.py's line on a traced rehearsal: the program's
    calls counted whole agree with the wrappers that time them from
    outside, the main thread's top-level spans cover most of the window,
    and a span's cost is read."""
    import trace_check
    out = tmp_path / "trace.jsonl"
    line = trace_check.run_one("tiny_se", SEED, 1.0, True, str(out), "cpu",
                               bench_json=bench_json, cache=tiny_cache,
                               data=TESTS)
    assert json.loads(out.read_text())["seed"] == SEED
    assert line["result"]["correct"]
    p = line["program"]
    for name, (inside, outside) in p["agree"].items():
        assert 0.5 * outside < inside <= outside, (name, inside, outside)
    assert 0.5 < p["coverage"] <= 1, p["coverage"]
    assert p["counters"]["reads_finished"] == p["reads"], p["counters"]
    # the ladder's spans are there only if some read fell to it
    assert {"reads@main", "submit.step@main", "stream.write@main",
            "finish@workers"} <= set(p["per"]), sorted(p["per"])
    cost = trace_check.span_cost(1000)
    assert 0 < cost["span_off"] < cost["span_on"], cost


def test_first_step_counts_from_the_window(bench_json, tiny_cache,
                                           monkeypatch):
    """On the card the harness starts the profiler inside its wrapper on
    io.reads._open_text, before the window opens; here a sleep stands in
    its place. The wrapper metric carries it, the program's `reads` spans
    start at the window's opening and leave it out."""
    import time
    from harness import probes
    orig = probes.Probes.install_open

    def install_open(self):
        orig(self)
        self.on_open = lambda: time.sleep(0.5)
    monkeypatch.setattr(probes.Probes, "install_open", install_open)
    res, _ = run(bench_json, tiny_cache)
    assert res["correct"]
    ctx, prog = program._last[0]
    wrapped = res["metrics"]["reads.parse_us_per_read"]["value"] * ctx.reads
    assert wrapped > 0.5e6
    first = min((s for s in prog.spans if s.name == "reads"),
                key=lambda s: s.t0)
    assert first.t1 - first.t0 < 0.25e9
    assert res["metrics"]["reads.offcpu_us_per_read"]["value"] * ctx.reads \
        < 0.25e6
