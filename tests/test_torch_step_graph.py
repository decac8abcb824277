"""The packed SE step in three parts (segment A, the eager DP call,
segment B) and its CUDA graphs (pipeline.StepGraphs, _StepGraph).

On the CPU: the three parts give exactly what the JAX package's packed
step gives (fastpack, merged grid, every extra), over full and partial
batches, binned and constant qualities, --nofw/--norc, and a graph
(SNV-overlay) index; the graph cache's choice of replay, capture or eager;
the hoisted minimum-score constants. The JAX package is imported by the
CPU cases' fixture only.

On the card (marked gpu, skipped without CUDA): SAM bytes from graph
replays equal the eager step's over a stream of 100 bp reads with a read
length change in the middle, and on a graph (SNV-overlay) index; a
slow-row gather of a batch after four later replays reads that batch's
own merged rows; a wrapper on ops.dp_cuda.dp_score sees one call a batch
with its real shape while the graphs replay."""

import io
import sys

import numpy as np
import pytest
import torch

from hisat2_tpu_torch.align import pipeline as tpipe
from hisat2_tpu_torch.align.emit import align_and_emit_stream
from hisat2_tpu_torch.align.pipeline import Aligner as TAligner
from hisat2_tpu_torch.align.pipeline import AlignerOpts as TOpts
from hisat2_tpu_torch.align.scoring import Scoring
from hisat2_tpu_torch.index.fm_index import FMIndex, build_fm_index
from hisat2_tpu_torch.io import sam as tsam
from hisat2_tpu_torch.io.reads import Read as TRead, batchify as tbatchify
from hisat2_tpu_torch.io.reference import reference_from_seqs
from hisat2_tpu_torch.utils import alphabet as talphabet
from hisat2_tpu_torch.utils import metrics

torch.set_num_threads(1)

BINS = np.array([2, 12, 23, 37], np.int8)       # NovaSeq's quality bins


def sim_reads(codes, rng, n, ln, tag=""):
    """(name, codes, binned quals) of n reads of ln bases from `codes`:
    1% mismatches, a 1-3 bp indel in one read of 20, an N in one of 10,
    half reverse-complemented."""
    out = []
    for i in range(n):
        s = int(rng.integers(0, codes.size - ln - 8))
        seq = codes[s:s + ln + 4].copy()
        if i % 20 == 7:
            d, p = int(rng.integers(1, 4)), int(rng.integers(20, ln - 20))
            seq = (np.concatenate([seq[:p], seq[p + d:]]) if i % 40 == 7
                   else np.concatenate([seq[:p], rng.integers(
                       0, 4, d).astype(np.uint8), seq[p:]]))
        seq = seq[:ln]
        m = rng.random(ln) < 0.01
        seq[m] = (seq[m] + rng.integers(1, 4, int(m.sum()))) % 4
        if i % 10 == 3:
            seq[int(rng.integers(0, ln))] = 4
        if rng.random() < 0.5:
            seq = talphabet.revcomp(seq)
        q = BINS[np.where(rng.random(ln) < 0.85, 3,
                          rng.integers(0, 3, ln))]
        out.append((f"{tag}r{i}", seq.astype(np.uint8), q))
    return out


def tbatch(triples, pad, first_id=0):
    return tbatchify([TRead(n, s, q, first_id + i)
                      for i, (n, s, q) in enumerate(triples)], pad_to=pad)


# ---------------------------------------------------------------------------
# CPU: the three parts against the JAX package's step
# ---------------------------------------------------------------------------

CASES = {
    # id: (index, reads in the batch, qualities, options)
    "linear-full-binned": ("linear", 256, "binned", {}),
    "linear-partial-const": ("linear", 200, "const", {}),
    "linear-full-const-nofw": ("linear", 256, "const", {"nofw": True}),
    "linear-partial-binned-norc": ("linear", 200, "binned", {"norc": True}),
    "graph-full-binned": ("graph", 192, "binned", {}),
    "graph-partial-const-nofw": ("graph", 150, "const", {"nofw": True}),
}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """A linear index (a 40 kb genome) and a graph index (the graph
    pipeline tests' genome and variants), each as the JAX package's and
    the port's, and 256 reads on each."""
    import test_torch_native_cache  # noqa: F401  (JAX native libs)
    import test_torch_graph_pipeline as gp
    from hisat2_tpu.index.fm_index import build_fm_index as jbuild
    from hisat2_tpu.io.reference import reference_from_seqs as jref
    rng = np.random.default_rng(2020)
    codes = rng.integers(0, 4, 40000).astype(np.uint8)
    jlin = jbuild(jref({"chrL": talphabet.decode(codes[:25000]),
                        "chrM": talphabet.decode(codes[25000:])}))
    prefix = str(tmp_path_factory.mktemp("lin") / "lin")
    jlin.save(prefix)
    lin_reads = [(n, s) for n, s, _ in sim_reads(jlin.ref.joined, rng, 256,
                                                  100)]
    gw = gp.graph_world(tmp_path_factory.mktemp("graph"))
    g_reads = gp.se_reads(gw["codes"], gw["snps"], rng, 256)
    return {"linear": (jlin, FMIndex.load(prefix), lin_reads),
            "graph": (gw["jfm"], FMIndex.from_object(gw["jfm"]), g_reads)}


def _ref_step(jfm, opts, triples):
    from hisat2_tpu.align.pipeline import Aligner as JAligner
    from hisat2_tpu.align.pipeline import AlignerOpts as JOpts
    from hisat2_tpu.io.reads import Read as JRead, batchify as jbatchify
    jal = JAligner(jfm, opts=JOpts(**opts))
    jb = jbatchify([JRead(n, s, q, i) for i, (n, s, q) in enumerate(triples)],
                   pad_to=104)
    return jal.device_align_fast(jb)


def _segments(al, batch):
    """Segment A, the module's dp_score, segment B, called one by one."""
    a_kw, b_kw = al._step_args(len(batch), batch.seqs.shape[1])
    seq_w, n_w, quals, qconst, lens = batch.packed()
    up = al._up
    core = tpipe._packed_a(
        al.idx, al.sctab, up(seq_w.astype(np.int64), torch.int64),
        up(n_w.astype(np.int64), torch.int64),
        None if quals is None else up(quals), qconst, up(lens), *al._minsc,
        **a_kw)
    dp = core["dp"]
    out = tpipe.dp_score(*dp["args"], ov=dp["ov"], **al.sc_const)
    return core, tpipe._packed_b(al.idx, al.sctab, core, out, *al._minsc,
                                 **b_kw)


@pytest.mark.parametrize("case", list(CASES))
def test_segments_match_the_reference_step(worlds, case):
    which, B, qual, opts = CASES[case]
    jfm, tfm, reads = worlds[which]
    rng = np.random.default_rng(len(case))
    triples = [(n, s, (np.full(s.size, 40, np.int8) if qual == "const"
                       else BINS[rng.integers(0, 4, s.size)]))
               for n, s in reads[:B]]
    jfp, jmerged, jex = _ref_step(jfm, opts, triples)
    al = TAligner(tfm, opts=TOpts(**opts), device="cpu")
    batch = tbatch(triples, 104)
    core, (fp, merged, ex) = _segments(al, batch)
    assert (core["dp"]["ov"] is not None) == (which == "graph")
    assert (batch.packed()[2] is None) == (qual == "const")
    np.testing.assert_array_equal(fp.numpy(), np.asarray(jfp))
    np.testing.assert_array_equal(merged.numpy(), np.asarray(jmerged))
    assert sorted(ex) == sorted(jex)
    for k in jex:
        np.testing.assert_array_equal(ex[k].numpy(), np.asarray(jex[k]),
                                      err_msg=k)
    # the stream's entry point runs the same three parts
    fp2, merged2, ex2, ready = al.device_align_fast(batch)
    assert ready is None
    assert torch.equal(fp2, fp) and torch.equal(merged2, merged)
    assert sorted(ex2) == sorted(ex)
    assert all(torch.equal(ex2[k], ex[k]) for k in ex)


def test_stage_align_packed_is_the_three_parts(worlds):
    """mesh.py's entry, _stage_align_packed, composes the same parts."""
    _, tfm, reads = worlds["linear"]
    al = TAligner(tfm, device="cpu")
    rng = np.random.default_rng(5)
    batch = tbatch([(n, s, BINS[rng.integers(0, 4, s.size)])
                    for n, s in reads[:128]], 104)
    _, (fp, merged, ex) = _segments(al, batch)
    a_kw, b_kw = al._step_args(128, 104)
    seq_w, n_w, quals, qconst, lens = batch.packed()
    up = al._up
    sc = al.scoring
    got = tpipe._stage_align_packed(
        al.idx, al.sctab, up(seq_w.astype(np.int64), torch.int64),
        up(n_w.astype(np.int64), torch.int64), up(quals), qconst, up(lens),
        float(sc.score_min.I), float(sc.score_min.S), a_kw["gap1"], 128, 104,
        a_kw["max_seeds"], a_kw["n_seeds"], a_kw["locs_per_seg"],
        a_kw["top_cands"], a_kw["min_seg_len"], a_kw["ftab_k"], b_kw["K2"],
        b_kw["KF"], a_kw["fb_bucket"], a_kw["dp_bucket"], a_kw["dp_pad"],
        False, False, False, a_kw["seeder"], a_kw["fb_seeder"], al.sc_const,
        khits=b_kw["khits"], SB=b_kw["SB"], MB=b_kw["MB"], VC=a_kw["VC"])
    assert torch.equal(got[0], fp) and torch.equal(got[1], merged)
    assert sorted(got[2]) == sorted(ex)
    assert all(torch.equal(got[2][k], ex[k]) for k in ex)


# ---------------------------------------------------------------------------
# CPU: the cache's choice, the counters, the minimum-score constants
# ---------------------------------------------------------------------------

def _key(B, L, quals, qconst):
    return tpipe.StepGraphs.key(B, L, quals, qconst)


CUDA, CPU = torch.device("cuda", 0), torch.device("cpu")
Q = np.zeros((1, 1), np.int8)        # a batch with per-base qualities


@pytest.mark.parametrize("name,calls,want", [
    # (device, spliced, B, L, quals, qual_const) in turn -> choices
    ("cpu never", [(CPU, False, 2048, 104, Q, -1)] * 3, ["eager"] * 3),
    ("spliced never", [(CUDA, True, 2048, 104, Q, -1)] * 3, ["eager"] * 3),
    ("second batch captures", [(CUDA, False, 2048, 104, Q, -1)] * 3,
     ["eager", "capture", "replay"]),
    ("short last batch", [(CUDA, False, 2048, 104, Q, -1)] * 2
     + [(CUDA, False, 777, 104, Q, -1)], ["eager", "capture", "eager"]),
    ("a new length", [(CUDA, False, 2048, 104, Q, -1)] * 2
     + [(CUDA, False, 2048, 128, Q, -1)] * 3 + [(CUDA, False, 2048, 104, Q,
                                                  -1)],
     ["eager", "capture", "eager", "capture", "replay", "replay"]),
    ("qualities are part of the shape",
     [(CUDA, False, 2048, 104, Q, -1), (CUDA, False, 2048, 104, None, 40),
      (CUDA, False, 2048, 104, None, 30), (CUDA, False, 2048, 104, None, 40),
      (CUDA, False, 2048, 104, None, 40)],
     ["eager", "eager", "eager", "capture", "replay"]),
])
def test_graph_choice(name, calls, want):
    g = tpipe.StepGraphs()
    got = []
    for dev, spliced, B, L, quals, qconst in calls:
        key = _key(B, L, quals, qconst)
        how = g.choose(dev, spliced, key)
        if how == "capture":
            g.graphs[key] = object()        # what a capture leaves
        got.append(how)
    assert got == want


def test_graph_choice_keeps_a_few_shapes():
    g = tpipe.StepGraphs()
    keys = [_key(2048, 8 * (13 + i), Q, -1)
            for i in range(tpipe.STEP_GRAPH_SHAPES + 1)]
    for k in keys:
        assert g.choose(CUDA, False, k) == "eager"
        assert g.choose(CUDA, False, k) == ("capture" if k is not keys[-1]
                                              else "eager")
        if k is not keys[-1]:
            g.graphs[k] = object()
    assert len(g.graphs) == tpipe.STEP_GRAPH_SHAPES
    assert g.choose(CUDA, False, keys[0]) == "replay"


def test_step_counters_on_the_cpu(worlds):
    """step_reads counts every read of the SE fast step; the CPU runs it
    eagerly, so step_graph_reads stays unset."""
    _, tfm, reads = worlds["linear"]
    al = TAligner(tfm, device="cpu")
    triples = [(n, s, np.full(s.size, 30, np.int8)) for n, s in reads[:96]]
    metrics.start_trace()
    try:
        al.device_align_fast(tbatch(triples[:64], 104))
        al.device_align_fast(tbatch(triples[64:], 104))
    finally:
        got = metrics.stop_trace()
    assert got["counters"]["step_reads"] == 96
    assert "step_graph_reads" not in got["counters"]
    assert not al._graphs.graphs


@pytest.mark.parametrize("scoring", [Scoring(), Scoring.local_default()],
                         ids=["end-to-end", "local"])
def test_hoisted_min_score_constants(scoring):
    I, S = float(scoring.score_min.I), float(scoring.score_min.S)
    lens = torch.arange(0, 2200, dtype=torch.int32)
    consts = tpipe._min_consts(I, S, "cpu")
    assert all(c.dtype == torch.float32 and c.dim() == 0 for c in consts)
    got = tpipe._min_scores(*consts, lens)
    assert torch.equal(got, tpipe._min_scores(I, S, lens))
    want = np.ceil(np.float32(I) + np.float32(S)
                   * lens.numpy().astype(np.float32)).astype(np.int32)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA graphs are captured on the card")


@pytest.fixture(scope="module")
def card_world():
    rng = np.random.default_rng(1234)
    codes = rng.integers(0, 4, 300000).astype(np.uint8)
    fm = build_fm_index(reference_from_seqs(
        {"chrA": talphabet.decode(codes[:180000]),
         "chrB": talphabet.decode(codes[180000:])}))
    return fm, rng


def _sam(fm, batches, graphs: bool, monkeypatch, workers: int):
    """The stream's SAM text and the tracer's counters."""
    with monkeypatch.context() as mp:
        if not graphs:
            mp.setattr(tpipe, "STEP_GRAPH_SHAPES", 0)
        al = TAligner(fm, device="cuda")
        buf = io.StringIO()
        metrics.start_trace()
        try:
            align_and_emit_stream(al, batches, tsam.SamWriter(
                buf, fm.ref.names, [int(x) for x in fm.ref.tlens],
                no_head=True), depth=4, workers=workers)
        finally:
            got = metrics.stop_trace()
    return buf.getvalue(), got["counters"], al


@pytest.mark.gpu
@pytest.mark.parametrize("workers", [3, 1])
def test_graph_sam_equals_eager_sam(card_world, monkeypatch, workers):
    """24,576 reads of 100 bp in batches of 2,048, with three batches of
    125 bp in the middle: that shape is captured while the finish threads
    run, and the 100 bp graphs replay again after it. Three finish
    threads (the stream's default), and one."""
    _need_card()
    fm, rng = card_world
    joined = fm.ref.joined
    lens = [100] * 6 + [125] * 3 + [100] * 6
    batches, rid = [], 0
    for k, ln in enumerate(lens):
        trip = sim_reads(joined, rng, 2048, ln, tag=f"b{k}")
        batches.append(tbatch(trip, 8 * -(-ln // 8), rid))
        rid += len(trip)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)         # hand the GIL round more often
    try:
        graph_sam, gc, gal = _sam(fm, batches, True, monkeypatch,
                                  workers)
    finally:
        sys.setswitchinterval(interval)
    eager_sam, ec, _ = _sam(fm, batches, False, monkeypatch, workers)
    assert graph_sam.count("\n") >= sum(len(b) for b in batches)
    assert graph_sam == eager_sam
    assert ec["step_reads"] == gc["step_reads"] == rid
    assert "step_graph_reads" not in ec
    # every batch but each shape's first ran from graphs
    assert gc["step_graph_reads"] == rid - 2 * 2048
    assert len(gal._graphs.graphs) == 2


def _snv_graph(codes, every: int):
    """A graph index over `codes` with an SNV every `every` bases, and the
    genome with every SNV's alternative allele applied."""
    from hisat2_tpu_torch.index.graph_index import build_graph_index
    from hisat2_tpu_torch.io.annotations import SNPDB
    pos = np.arange(every // 2, codes.size - every, every, dtype=np.int64)
    alt = ((codes[pos].astype(np.int64) + 1 + pos % 3) % 4).astype(np.int8)
    snps = SNPDB(names=[f"v{i}" for i in range(pos.size)],
                 types=np.zeros(pos.size, np.int8), jpos=pos,
                 lens=np.ones(pos.size, np.int32), alt_codes=alt,
                 chroms=["chrG"] * pos.size, tpos=pos.copy())
    gfm = build_graph_index(reference_from_seqs(
        {"chrG": talphabet.decode(codes)}), snps)
    hap = codes.copy()
    hap[pos] = alt
    return gfm, hap


@pytest.mark.gpu
def test_graph_sam_equals_eager_sam_on_a_graph_index(card_world,
                                                     monkeypatch):
    """The same on a graph (SNV-overlay) index, whose step sends the
    overlay to the DP kernel: 8 batches of 2,048 reads of 100 bp drawn
    from the genome with every SNV's alternative allele, three finish
    threads."""
    _need_card()
    _, rng = card_world
    codes = rng.integers(0, 4, 200000).astype(np.uint8)
    gfm, hap = _snv_graph(codes, 250)
    batches = [tbatch(sim_reads(hap, rng, 2048, 100, tag=f"g{k}"), 104,
                      2048 * k) for k in range(8)]
    graph_sam, gc, gal = _sam(gfm, batches, True, monkeypatch, 3)
    eager_sam, ec, _ = _sam(gfm, batches, False, monkeypatch, 3)
    assert graph_sam == eager_sam
    assert gc["step_graph_reads"] == 7 * 2048
    assert "step_graph_reads" not in ec
    assert len(gal._graphs.graphs) == 1
    assert graph_sam.count("XM:i:0") > 2048


@pytest.mark.gpu
def test_gather_after_later_replays(card_world, monkeypatch):
    """Batch k's merged rows, gathered after batches k+1..k+4 replayed
    the same graphs, are batch k's own."""
    _need_card()
    fm, rng = card_world
    batches = [tbatch(sim_reads(fm.ref.joined, rng, 2048, 100), 104)
               for _ in range(7)]
    with monkeypatch.context() as mp:
        mp.setattr(tpipe, "STEP_GRAPH_SHAPES", 0)
        eager = TAligner(fm, device="cuda")
        want = [eager.device_align_fast(b)[1].cpu() for b in batches]
    al = TAligner(fm, device="cuda")
    got = [al.device_align_fast(b) for b in batches]
    assert len(al._graphs.graphs) == 1
    rows = np.arange(0, 2048, 7)
    for k in (1, 2):        # the capture's batch, then a replay's
        fp, merged, ex, ready = got[k]
        g = al.gather_merged_rows(merged, rows)
        np.testing.assert_array_equal(g, want[k].numpy()[rows])
        assert not np.array_equal(g, want[k + 1].numpy()[rows])
    for k, (fp, merged, ex, ready) in enumerate(got):
        ready.synchronize()
        assert torch.equal(merged.cpu(), want[k])


@pytest.mark.gpu
def test_dp_wrapper_sees_each_batch(card_world, monkeypatch):
    """A wrapper on ops.dp_cuda.dp_score, set in every module of the
    program that holds it (as the benchmark's probes set theirs), sees one
    call a batch with the real (C, L, W) while the graphs replay."""
    _need_card()
    from hisat2_tpu_torch.ops import dp_cuda
    fm, rng = card_world
    real = dp_cuda.dp_score
    calls = []

    def wrapped(rd, pen, rdlens, ref, scp_cum, **kw):
        calls.append((*rd.shape, ref.shape[1]))
        return real(rd, pen, rdlens, ref, scp_cum, **kw)
    for name, mod in list(sys.modules.items()):
        if name.startswith("hisat2_tpu_torch") and mod is not None:
            for attr, val in list(vars(mod).items()):
                if val is real:
                    monkeypatch.setattr(mod, attr, wrapped)
    assert tpipe.dp_score is wrapped
    al = TAligner(fm, device="cuda")
    batches = [tbatch(sim_reads(fm.ref.joined, rng, 2048, 100), 104)
               for _ in range(6)]
    outs = [al.device_align_fast(b) for b in batches]
    torch.cuda.synchronize()
    a_kw, _ = al._step_args(2048, 104)
    C = 2 * a_kw["dp_bucket"] * 2
    assert calls == [(C, 104, 104 + 2 * a_kw["dp_pad"])] * 6
    assert len(al._graphs.graphs) == 1
    monkeypatch.setattr(tpipe, "STEP_GRAPH_SHAPES", 0)
    eager = TAligner(fm, device="cuda")
    for b, (fp, merged, ex, ready) in zip(batches, outs):
        efp = eager.device_align_fast(b)[0]
        torch.cuda.synchronize()
        assert torch.equal(fp, efp)
