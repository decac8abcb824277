"""The port's tracer (hisat2_tpu_torch/utils/metrics.py) through
hisat2_tpu_torch.cli.align.main on the CPU: SE and PE, DNA and spliced,
the packed steps and the per-base-quality PE path. Tracing off records
nothing; on, it leaves the SAM as it was and keeps one reads, submit and
finish span a batch, children inside their parents on their threads, the
finish counters, and the --met-file table's timing columns as a split of
the finish spans' time."""

import gzip

import numpy as np
import pytest
import torch

from hisat2_tpu_torch.cli import align as cli_align
from hisat2_tpu_torch.cli import build as cli_build
from hisat2_tpu_torch.utils import alphabet, metrics

torch.set_num_threads(1)

BATCH = 64
N_SE, N_PE = 300, 150
# the parent each span has when it has one (finish.gather: the ladder's
# waits, or the spliced finishes' gathers around their rescue)
PARENT = {"input.open": {"reads"}, "submit.pack": {"submit"},
          "submit.step": {"submit"}, "submit.d2h": {"submit"},
          "submit.splice": {"submit.step"},
          "finish.fetch": {"finish"}, "finish.native": {"finish"},
          "finish.ladder": {"finish"}, "finish.rescue": {"finish"},
          "finish.splice": {"finish"},
          "finish.gather": {"finish.ladder", "finish", "finish.rescue"}}
TOP = {"reads", "submit", "finish", "stream.wait", "stream.write"}
MODES = {
    "se": ["-U", "r.fq.gz", "--no-spliced-alignment"],
    "se_rna": ["-U", "r.fq.gz"],
    "pe": ["-1", "p1.fq", "-2", "p2.fq", "--no-spliced-alignment"],
    "pe_quals": ["-1", "q1.fq", "-2", "q2.fq", "--no-spliced-alignment"],
    "pe_rna": ["-1", "p1.fq", "-2", "p2.fq"],
}


def _fastq(recs) -> str:
    return "".join(f"@{n}\n{s}\n+\n{q}\n" for n, s, q in recs)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A 40 kb genome and its index (the port's cli.build); 300 SE reads
    of 100 bp, gzipped, with per-base qualities, a tenth with a 2 bp
    deletion and some with a mismatch; 150 pairs from 250-400 bp
    fragments, with constant qualities and with per-base ones."""
    d = tmp_path_factory.mktemp("trace")
    rng = np.random.default_rng(11)
    g = rng.integers(0, 4, 40000).astype(np.uint8)
    s = alphabet.decode(g)
    (d / "g.fa").write_text(
        ">chrT\n" + "".join(s[i:i + 70] + "\n" for i in range(0, 40000, 70)))
    assert cli_build.main([str(d / "g.fa"), str(d / "idx"), "--quiet"]) == 0

    def rc(c):
        return 3 - c[::-1]

    def quals(n):
        return "".join("I?5"[int(x)] for x in rng.integers(0, 3, n))

    se = []
    for i in range(N_SE):
        p = int(rng.integers(0, 39800))
        r = g[p:p + 100].copy()
        if i % 10 == 3:
            r = np.concatenate([r[:50], r[52:], g[p + 100:p + 102]])
        if i % 7 == 1:
            r[int(rng.integers(100))] ^= 1
        if i % 2:
            r = rc(r)
        se.append((f"s{i}_{p}", alphabet.decode(r), quals(100)))
    with gzip.open(d / "r.fq.gz", "wt") as fh:
        fh.write(_fastq(se))
    m1, m2 = [], []
    for i in range(N_PE):
        f = int(rng.integers(250, 400))
        p = int(rng.integers(0, 40000 - f))
        a, b = g[p:p + 100].copy(), rc(g[p + f - 100:p + f])
        if i % 5 == 2:
            b[int(rng.integers(100))] ^= 2
        m1.append((f"p{i}_{p}", alphabet.decode(a)))
        m2.append((f"p{i}_{p}", alphabet.decode(b)))
    for tag, q in (("p", lambda: "I" * 100), ("q", lambda: quals(100))):
        (d / f"{tag}1.fq").write_text(_fastq((n, x, q()) for n, x in m1))
        (d / f"{tag}2.fq").write_text(_fastq((n, x, q()) for n, x in m2))
    return d


def _align(d, mode):
    argv = ["-x", str(d / "idx")]
    for a in MODES[mode]:
        argv.append(str(d / a) if a[0] != "-" else a)
    argv += ["-S", str(d / f"{mode}.sam"), "--batch-size", str(BATCH),
             "--quiet", "--met-file", str(d / f"{mode}.met"),
             "--device", "cpu"]
    assert cli_align.main(argv) == 0
    return (d / f"{mode}.sam").read_bytes()


@pytest.fixture(scope="module", params=sorted(MODES))
def run(request, data):
    """One mode run untraced, then traced: (mode, SAM untraced, SAM
    traced, the trace, the traced run's --met-file header and last
    row)."""
    mode = request.param
    metrics.stop_trace()
    plain = _align(data, mode)
    untraced = metrics.stop_trace()
    metrics.start_trace()
    try:
        traced = _align(data, mode)
    finally:
        tr = metrics.stop_trace()
    lines = (data / f"{mode}.met").read_text().splitlines()
    return dict(mode=mode, plain=plain, traced=traced, untraced=untraced,
                trace=tr, met_head=lines[0],
                met=dict(zip(lines[0].split("\t"), lines[-1].split("\t"))))


def test_off_records_nothing_and_on_keeps_the_sam(run):
    assert run["untraced"] is None
    assert metrics.stop_trace() is None      # left off
    assert run["traced"] == run["plain"]
    assert run["trace"]["spans"]


def test_one_reads_submit_finish_a_batch(run):
    spans = run["trace"]["spans"]
    n_reads = N_SE if run["mode"].startswith("se") else N_PE
    nb = -(-n_reads // BATCH)
    by = {}
    for s in spans:
        if s.name in ("reads", "submit", "finish"):
            by.setdefault(s.name, []).append(s.batch)
    # the read layer's last step meets the end of the input: no batch
    assert by["reads"].count(None) == 1
    for name in ("reads", "submit", "finish"):
        got = sorted(b for b in by[name] if b is not None)
        assert got == list(range(nb)), (name, got)
    # a batch's other spans carry its number
    assert all(s.batch is not None for s in spans
               if s.name not in ("reads", "input.open"))


def test_children_inside_parents(run):
    spans = run["trace"]["spans"]
    ids = {s.id: s for s in spans}
    names = {s.name for s in spans}
    assert {"reads", "input.open", "submit", "finish"} <= names
    if run["mode"] != "pe_quals":        # the fused step's finish has none
        assert "finish.native" in names
    if run["mode"] in ("se", "pe"):
        assert {"submit.pack", "submit.step", "submit.d2h",
                "finish.fetch", "stream.wait"} <= names
    if run["mode"] == "pe_rna":
        assert "finish.rescue" in names
    if run["mode"].endswith("_rna"):   # the spliced step's splice pass
        assert "submit.splice" in names
    for s in spans:
        assert s.t0 <= s.t1 and s.cpu_ns >= 0
        if s.parent is None:
            assert s.name in TOP, s
            continue
        p = ids[s.parent]
        assert s.name in PARENT and p.name in PARENT[s.name], (s, p)
        assert p.thread == s.thread and p.main == s.main
        assert p.t0 <= s.t0 and s.t1 <= p.t1
        assert s.batch == p.batch or p.name == "reads"
    # the main thread's top-level spans follow one another
    top = sorted((s.t0, s.t1) for s in spans if s.main and s.parent is None)
    assert all(a[1] <= b[0] for a, b in zip(top, top[1:]))
    # threaded finishes run off the main thread, serial ones on it
    fin = [s.main for s in spans if s.name == "finish"]
    threaded = run["mode"] in ("se", "pe")
    assert not any(fin) if threaded else all(fin)


def test_counters(run):
    c = run["trace"]["counters"]
    recs = [ln.split("\t") for ln in run["traced"].decode().splitlines()
            if not ln.startswith("@")]
    primary = sum(1 for f in recs if not int(f[1]) & 0x900)
    assert c["reads_finished"] == primary
    assert 0 <= c.get("slow_reads", 0) <= primary
    if run["mode"] == "pe_quals":        # every batch takes the fused step
        assert c["slow_reads"] == primary
    if run["mode"].startswith("se"):     # the gzipped input's raw reads
        assert c["input.source_ns"] > 0
    else:
        assert "input.source_ns" not in c


def test_met_file_timing_columns(run):
    """The table's header is hisat2_tpu's; t_fetch, t_gather, t_host and
    t_rescue split the time of the finish spans that feed them (to the
    table's two decimals), so t_fetch + t_host + t_rescue is the finish
    time less the gathers."""
    from hisat2_tpu.utils.metrics import Metrics as JaxMetrics
    assert run["met_head"] == "\t".join(JaxMetrics.COLUMNS)
    spans = run["trace"]["spans"]
    if run["mode"] == "pe_quals":      # the fused step feeds none of them
        fed = []
    else:
        fed = [s for s in spans if s.name == "finish"]
    fin_s = sum(s.t1 - s.t0 for s in fed) / 1e9
    gather_s = sum(s.t1 - s.t0 for s in spans
                   if s.name == "finish.gather") / 1e9
    m = {k: float(run["met"][k])
         for k in ("t_pack", "t_fetch", "t_gather", "t_host", "t_rescue")}
    assert abs(m["t_fetch"] + m["t_gather"] + m["t_host"] + m["t_rescue"]
               - fin_s) <= 0.02
    assert abs(m["t_fetch"] + m["t_host"] + m["t_rescue"] - fin_s) \
        <= 0.02 + gather_s
    pack_s = sum(s.t1 - s.t0 for s in spans if s.name in (
        "submit.pack", "submit.step", "submit.d2h")) / 1e9
    assert abs(m["t_pack"] - pack_s) <= 0.01
    resc_s = sum(s.t1 - s.t0 for s in spans
                 if s.name == "finish.rescue") / 1e9
    assert abs(m["t_rescue"] - resc_s) <= 0.01


def test_span_fields_partition_time():
    """A span that names a Metrics field adds its time less that of the
    field spans nested in it, tracing on or off; off, only such spans
    are objects, and the counters stay empty."""
    for on in (False, True):
        m = metrics.Metrics()
        if on:
            metrics.start_trace()
        with metrics.span("finish", None, m, "t_host"):
            with metrics.span("finish.fetch", None, m, "t_fetch"):
                sum(range(20000))
            with metrics.span("finish.ladder") as lad:
                with metrics.span("finish.gather", None, m, "t_gather"):
                    sum(range(20000))
                sum(range(20000))
        metrics.count("slow_reads", 3)
        tr = metrics.stop_trace()
        assert m.t_fetch > 0 and m.t_gather > 0 and m.t_host > 0
        if not on:
            assert tr is None and lad is metrics.span("x")
            continue
        total = {s.name: (s.t1 - s.t0) / 1e9 for s in tr["spans"]}
        assert m.t_fetch + m.t_gather + m.t_host == pytest.approx(
            total["finish"], abs=1e-6)
        assert m.t_gather == pytest.approx(total["finish.gather"], abs=1e-6)
        assert tr["counters"]["slow_reads"] == 3


def test_gzip_input_one_path(tmp_path):
    """A gzipped text input reads the same text through io.reads'
    counting source, tracing on or off, and closes its file; each opening
    is an `input.open` span."""
    from hisat2_tpu_torch.io import reads as rd
    text = "".join(f"line {i}\n" for i in range(50000))
    p = tmp_path / "t.txt.gz"
    with gzip.open(p, "wt") as fh:
        fh.write(text)
    fq = tmp_path / "r.fq.gz"
    with gzip.open(fq, "wt") as fh:
        fh.write(_fastq([("a", "ACGT" * 25, "I" * 100)]))
    for on in (False, True):
        if on:
            metrics.start_trace()
        with rd._open_text(p) as fh:
            assert fh.read() == text
            raw = fh.buffer._raw
        assert raw.closed
        assert len(list(rd.read_fastq(fq))) == 1
        tr = metrics.stop_trace()
        if not on:
            assert tr is None
            continue
        assert tr["counters"]["input.source_ns"] > 0
        assert [s.name for s in tr["spans"]] == ["input.open"] * 2


# ---- the splice layer: spans and the anchor scan's window tests ----

@pytest.fixture(scope="module")
def rna(tmp_path_factory):
    """Transcripts planted in a 120 kb genome (chip_smoke's gene model),
    its index with their splice sites and exons, 256 RNA reads and 128
    pairs cut along them."""
    import chip_smoke
    d = tmp_path_factory.mktemp("trace_rna")
    rng = np.random.default_rng(5)
    g = rng.integers(0, 4, 120_000).astype(np.uint8)
    txs = chip_smoke.simulate_gene_model(g, 6, n_tx=16)
    (d / "g.fa").write_text(f">chrR\n{alphabet.decode(g)}\n")
    with open(d / "g.ss", "w") as ss, open(d / "g.exon", "w") as ex:
        for strand, exons in txs:
            for (_, e), (a, _) in zip(exons, exons[1:]):
                ss.write(f"chrR\t{e - 1}\t{a}\t{strand}\n")
            for a, e in exons:
                ex.write(f"chrR\t{a}\t{e - 1}\t{strand}\n")
    assert cli_build.main([str(d / "g.fa"), str(d / "idx"), "--ss",
                           str(d / "g.ss"), "--exon", str(d / "g.exon"),
                           "--quiet"]) == 0
    se, _ = chip_smoke.simulate_rna_reads(g, txs, 256, 7)
    p1, p2, _ = chip_smoke.simulate_rna_pairs(g, txs, 128, 8)
    for name, reads in (("s.fq", se), ("p1.fq", p1), ("p2.fq", p2)):
        (d / name).write_text(_fastq(
            (f"r{i}", alphabet.decode(r), "I" * r.size)
            for i, r in enumerate(reads)))
    return d


def _align_rna(d, pe):
    reads = ["-1", str(d / "p1.fq"), "-2", str(d / "p2.fq")] if pe else \
        ["-U", str(d / "s.fq")]
    out = d / ("pe.sam" if pe else "se.sam")
    assert cli_align.main(["-x", str(d / "idx"), *reads, "-S", str(out),
                           "--batch-size", str(BATCH), "--quiet",
                           "--device", "cpu"]) == 0
    return out.read_bytes()


@pytest.mark.parametrize("pe", [False, True], ids=["se", "pe"])
def test_splice_spans_and_window_tests(rna, pe, monkeypatch):
    """A traced RNA run: one submit.splice a batch inside its submit.step,
    finish.splice inside the finishes, on the main thread (the spliced
    stream's finishes run there); anchor.window_tests equals the plain
    count of chip_smoke.anchor_need's rule over the calls of the plain
    core, captured; the SAM is the untraced run's."""
    import chip_smoke
    from hisat2_tpu_torch.ops import splice
    calls = []
    core = splice.anchor_scan_plain_core

    def capture(*args, **kw):
        calls.append((args, kw))
        return core(*args, **kw)
    plain = _align_rna(rna, pe)
    monkeypatch.setattr(splice, "anchor_scan_plain_core", capture)
    metrics.start_trace()
    try:
        traced = _align_rna(rna, pe)
    finally:
        tr = metrics.stop_trace()
    assert traced == plain
    spans = tr["spans"]
    ids = {s.id: s for s in spans}
    sub = [s for s in spans if s.name == "submit.splice"]
    fin = [s for s in spans if s.name == "finish.splice"]
    n_batches = -(-(128 if pe else 256) // BATCH)
    assert sorted(s.batch for s in sub) == list(range(n_batches))
    assert fin
    for s in sub:
        assert ids[s.parent].name == "submit.step" and s.main
    for s in fin:
        assert ids[s.parent].name == "finish" and s.main
        assert ids[s.parent].batch == s.batch
    want = 0
    assert calls
    for (rows, pos, down, rdl, acode, has_n, live, mi), kw in calls:
        kv, _ = splice.anchor_scan_plain_keys(rows, pos, down, rdl, acode,
                                              has_n, live, mi, **kw)
        need, _ = chip_smoke.anchor_need(
            (rows, pos, down, rdl, acode, has_n, live, mi), kv, kw["W"],
            kw["NC"], kw["tiles"])
        want += 16 * int(need.sum())
    assert want > 0
    assert tr["counters"]["anchor.window_tests"] == want


def test_splice_sites_off_leave_nothing(rna, monkeypatch):
    """With the tracer off the splice sites keep nothing: the anchor
    scan's count is never worked out and the spans are the shared no-op."""
    from hisat2_tpu_torch.ops import anchor_cuda

    def refuse(*a, **k):
        raise AssertionError("window tests counted with the tracer off")
    monkeypatch.setattr(anchor_cuda, "window_tests", refuse)
    metrics.stop_trace()
    _align_rna(rna, True)
    assert metrics.stop_trace() is None
    assert metrics.span("submit.splice") is metrics.span("finish.splice")
