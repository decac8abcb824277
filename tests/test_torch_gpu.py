"""The SE path on the card against the same path on the CPU (plain
versions of the kernels): identical SAM bytes, on the table index and on
every FM configuration (no table; sampled SA; seed_mode=False, SE and PE;
the paired-k-mer and stride-sampled table modes), and on a graph index
(SE, PE, FM-seeded, seed_mode=False, Zs:Z tags), and spliced (RNA)
alignment, single-end and paired-end; genome-sharded alignment (SE, PE,
graph, RNA, tmo) and its eviction; RepeatAligner; the DP kernel's overlay
instantiations against the plain version at the edge windows. Skips where
CUDA is absent; the DP kernel's own card tests are in tests/test_torch_dp.py."""

import io

import numpy as np
import pytest
import torch

import chip_smoke
from hisat2_tpu_torch.align.emit import (align_and_emit_pe_stream,
                                         align_and_emit_stream)
from hisat2_tpu_torch.align.paired import align_pairs, pairs_to_sam
from hisat2_tpu_torch.align.pipeline import (Aligner, AlignerOpts,
                                             results_to_sam)
from hisat2_tpu_torch.index.fm_index import build_fm_index
from hisat2_tpu_torch.io import sam as samio
from hisat2_tpu_torch.io.reads import Read, batchify
from hisat2_tpu_torch.io.reference import reference_from_seqs
from hisat2_tpu_torch.ops import dp_cuda
from hisat2_tpu_torch.utils import alphabet


@pytest.mark.gpu
def test_se_sam_on_card_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the SE path on the card needs one")
    rng = np.random.default_rng(9)
    g = rng.integers(0, 4, 60000).astype(np.uint8)
    fm = build_fm_index(reference_from_seqs({"chrG": alphabet.decode(g)}))
    reads = []
    for i in range(512):
        s = int(rng.integers(0, g.size - 110))
        r = g[s:s + 100].copy()
        if i % 10 == 0:                       # a 2 bp deletion
            r = np.concatenate([g[s:s + 50], g[s + 52:s + 102]])
        m = rng.random(100) < 0.02
        r[m] = (r[m] + 1) % 4
        if i % 2:
            r = alphabet.revcomp(r)
        reads.append(Read(f"q{i}", r, rng.integers(5, 41, 100).astype(
            np.int8), i))
    batches = [batchify(reads[:256], pad_to=104),
               batchify(reads[256:], pad_to=104)]

    def sam(device):
        buf = io.StringIO()
        al = Aligner(fm, device=device)
        align_and_emit_stream(al, batches, samio.SamWriter(
            buf, fm.ref.names, [int(x) for x in fm.ref.tlens], no_head=True))
        return buf.getvalue()
    before = dp_cuda.launches["dp_score"]
    on_card = sam("cuda")
    assert dp_cuda.launches["dp_score"] > before
    assert on_card == sam("cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("name,seed_mode,how", [
    ("A", True, "stream"), ("B", True, "stream"), ("pair", True, "stream"),
    ("stride2", True, "stream"), ("A", False, "stream"),
    ("T", False, "stream"), ("A", False, "align_batch"),
    ("B", False, "align_batch"), ("A", True, "pe"), ("A", False, "pe"),
    ("A", False, "align_pairs")])
def test_fm_sam_on_card_equals_cpu(name, seed_mode, how):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the FM paths on the card need one")
    rng = np.random.default_rng(10)
    g = rng.integers(0, 4, 60000).astype(np.uint8)
    fm = build_fm_index(reference_from_seqs({"chrG": alphabet.decode(g)}))
    if name != "T":
        fm = chip_smoke.fm_variants(fm)[name]

    def mk(i, s, rc):
        r = g[s:s + 100].copy()
        if i % 10 == 0:                       # a 2 bp deletion
            r = np.concatenate([g[s:s + 50], g[s + 52:s + 102]])
        m = rng.random(100) < 0.02
        r[m] = (r[m] + 1) % 4
        if i % 13 == 0:
            r[::9] = 4
        return alphabet.revcomp(r) if rc else r
    q = np.full(100, 40, np.int8)
    starts = rng.integers(0, g.size - 700, 256)
    b1 = batchify([Read(f"q{i}", mk(i, int(s), i % 2 == 1), q, i)
                   for i, s in enumerate(starts)], pad_to=104)
    b2 = batchify([Read(f"q{i}", mk(i + 5, int(s) + 250, i % 2 == 0), q, i)
                   for i, s in enumerate(starts)], pad_to=104)

    def sam(device):
        buf = io.StringIO()
        al = Aligner(fm, opts=AlignerOpts(seed_mode=seed_mode),
                     device=device)
        w = samio.SamWriter(buf, fm.ref.names,
                            [int(x) for x in fm.ref.tlens], no_head=True)
        if how == "stream":
            align_and_emit_stream(al, [b1], w)
        elif how == "align_batch":
            results_to_sam(b1, al.align_batch(b1), al, w)
        elif how == "pe":
            align_and_emit_pe_stream(al, [(b1, b2)], w)
        else:
            pairs_to_sam(b1, b2, align_pairs(al, b1, b2), al, w)
        w.flush()
        return buf.getvalue()
    before = dp_cuda.launches["dp_score"]
    on_card = sam("cuda")
    assert dp_cuda.launches["dp_score"] > before
    assert on_card == sam("cpu")


@pytest.mark.gpu
def test_overlay_kernel_matches_plain_at_edge_windows():
    """The overlay instantiations of every kernel against the plain
    version at every window where one of their variants ends (the tiled
    form's tile counts too), with an overlay holding every kind of nibble;
    W = 288 (graph reads of 250 bp) and 1104 among them."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the overlay kernel runs only on one")
    from hisat2_tpu_torch.align.scoring import Scoring
    from hisat2_tpu_torch.ops.sw import dp_fill_plain, dp_inputs
    sc = Scoring()
    sctab = sc.device_tables("cuda")
    consts = sc.dp_consts()

    def case(W):
        rd, quals, lens, ref = chip_smoke.make_dp_case(
            100 + W, *chip_smoke.edge_case_shape(W), W)
        ov = chip_smoke.make_dp_ov(W, rd, ref)
        t = [torch.from_numpy(a).cuda() for a in (rd, quals, lens, ref, ov)]
        pen, scp = (x.contiguous() for x in dp_inputs(sctab, t[1], t[2]))
        return (t[0], pen, t[2], t[3], scp), t[4]
    for W in (chip_smoke.edge_windows("dp_score")
              + chip_smoke.edge_windows("dp_score_wide")
              + chip_smoke.edge_windows("dp_score_tiled")
              + [136, 288, 1104]):
        a, ov = case(W)
        kernel = dp_cuda.dispatch_plan(W).kernel
        before = dict(dp_cuda.launches)
        got = dp_cuda.dp_score(*a, ov=ov, **consts)
        assert dp_cuda.launches["dp_score_ov"] == before["dp_score_ov"] + 1
        assert dp_cuda.launches[kernel] == before[kernel] + 1
        want = dp_fill_plain(*a, ov=ov, **consts)
        assert torch.equal(got, want), W
        assert not torch.equal(want, dp_fill_plain(*a, **consts)), W
        zero = dp_cuda.dp_score(*a, ov=torch.zeros_like(ov), **consts)
        assert torch.equal(zero, dp_cuda.dp_score(*a, **consts)), W
    with pytest.raises(TypeError):
        a, ov = case(136)
        dp_cuda.dp_score(*a, ov=ov.long(), **consts)


@pytest.mark.gpu
@pytest.mark.parametrize("index,opts,how", [
    ("table", {}, "stream"), ("fm", {}, "stream"), ("table", {}, "pe"),
    ("table", {}, "pe_perbase"), ("table", dict(seed_mode=False), "stream"),
    ("table", dict(seed_mode=False), "align_pairs"),
    ("table", dict(zs_tags=True), "stream")])
def test_graph_sam_on_card_equals_cpu(index, opts, how):
    """A graph index on the card against the CPU path: identical SAM bytes
    for the SE stream, both PE steps, the FM-seeded index, seed_mode=False
    and Zs:Z tags; every run launches the overlay kernel."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the graph path on the card needs one")
    import dataclasses
    from hisat2_tpu_torch.index.graph_index import build_graph_index
    g = np.random.default_rng(12).integers(0, 4, 60000).astype(np.uint8)
    ref = reference_from_seqs({"chrG": alphabet.decode(g)})
    snps, haps = chip_smoke.simulate_variants(ref.joined, 31, 250, 12)
    fm = build_graph_index(ref, snps, haplotypes=haps)
    if index == "fm":
        fm = dataclasses.replace(fm, st_starts=None, st_pos=None, st_k=0)
    hap = chip_smoke.apply_haplotype(ref.joined, snps, haps, 32)
    seqs, _ = chip_smoke.simulate_graph_reads(*hap, 256, seed=33)
    r1, r2, _, _ = chip_smoke.simulate_pairs(hap[0], 128, seed=34)
    quals = None
    if how == "pe_perbase":
        quals = np.random.default_rng(35).integers(
            2, 42, (128, 2, 100)).astype(np.int8)
    se = chip_smoke.make_batches(seqs, 0, 256)
    pe = chip_smoke.make_pair_batches(r1, r2, 0, 128, quals)
    run = {"stream": chip_smoke.run_stream,
           "align_pairs": chip_smoke.run_per_pair}.get(
               how, chip_smoke.run_pe_stream)
    items = se if how == "stream" else pe

    def sam(device):
        al = Aligner(fm, opts=AlignerOpts(**opts), device=device)
        return run(al, items, ref)[0]
    before = dp_cuda.launches["dp_score_ov"]
    on_card = sam("cuda")
    assert dp_cuda.launches["dp_score_ov"] > before
    assert on_card == sam("cpu")
    if opts.get("zs_tags"):
        assert "Zs:Z:" in on_card


@pytest.mark.gpu
def test_splice_floats_on_card_equal_cpu():
    """The spliced scorer's float32 pieces give the CPU's bits on the card:
    the intron-length penalty at every length from 20 to 500,000 (and past
    it to the int32 limit at the thresholds), exp and the probscore."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from hisat2_tpu_torch.ops import splice as tsp
    d = torch.cat([torch.arange(-5, 500001),
                   torch.tensor([t + k for t in tsp._ilp_thresholds()
                                 for k in (-1, 0, 1)])]).to(torch.int32)
    assert torch.equal(tsp._intron_len_pen(d.cuda()).cpu(),
                       tsp._intron_len_pen(d))
    x = torch.linspace(-80, 80, 1 << 20)
    assert torch.equal(tsp._exp_f32(x.cuda()).cpu().view(torch.int32),
                       tsp._exp_f32(x).view(torch.int32))
    rng = np.random.default_rng(3)
    dw = torch.from_numpy(rng.integers(0, 4, (1 << 18, 9)).astype(np.int32))
    aw = torch.from_numpy(rng.integers(0, 4, (1 << 18, 15)).astype(np.int32))
    assert torch.equal(tsp._probscore(dw.cuda(), aw.cuda()).cpu()
                       .view(torch.int32),
                       tsp._probscore(dw, aw).view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("opts,known,how", [
    ({}, False, "stream"), ({}, True, "stream"), (dict(dta=True), False,
                                                  "stream"),
    (dict(tmo=True), True, "stream"), (dict(seed_mode=False), True,
                                       "stream"),
    ({}, False, "fm"), ({}, True, "align_batch")])
def test_rna_sam_on_card_equals_cpu(opts, known, how):
    """Spliced SE on the card against the CPU path: identical SAM bytes
    for the stream without and with known sites, dta, tmo, seed_mode=False,
    an FM-seeded index and align_batch + results_to_sam, on a genome with
    chip_smoke's gene model; the DP kernel is launched."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the RNA path on the card needs one")
    codes = np.random.default_rng(21).integers(0, 4, 300000).astype(
        np.uint8)
    txs = chip_smoke.simulate_gene_model(codes, 22, n_tx=100)
    fm = build_fm_index(reference_from_seqs({"chrR": alphabet.decode(
        codes)}))
    if how == "fm":
        fm = chip_smoke.fm_variants(fm)["A"]
    seqs, _ = chip_smoke.simulate_rna_reads(fm.ref.joined, txs, 512, 23)
    items = chip_smoke.make_batches(seqs, 0, 256)
    run = (chip_smoke.run_per_read if how == "align_batch"
           else chip_smoke.run_stream)

    def sam(device):
        al = Aligner(fm, opts=AlignerOpts(spliced=True, **opts),
                     device=device)
        if known:
            for st, ex in txs:
                for (_, e), (a, _) in zip(ex, ex[1:]):
                    al.ssdb.add_known(e - 1, a, st)
        return run(al, items, fm.ref)[0]
    before = dp_cuda.launches["dp_score"]
    on_card = sam("cuda")
    assert dp_cuda.launches["dp_score"] > before
    assert on_card == sam("cpu")
    assert sum("N" in ln.split("\t")[5] for ln in on_card.splitlines()) > 50


@pytest.mark.gpu
@pytest.mark.parametrize("known", [False, True])
def test_rna_pe_sam_on_card_equals_cpu(known):
    """Spliced PE on the card against the CPU path: 256 pairs of
    chip_smoke's RNA pairs (fragments along the spliced transcripts of its
    gene model) in two batches through align_and_emit_pe_stream, without
    and with known sites: identical SAM bytes and stats, and the spliced
    step launched the DP kernel."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the RNA PE path on the card needs one")
    codes = np.random.default_rng(21).integers(0, 4, 300000).astype(
        np.uint8)
    txs = chip_smoke.simulate_gene_model(codes, 22, n_tx=100)
    fm = build_fm_index(reference_from_seqs({"chrR": alphabet.decode(
        codes)}))
    r1, r2, _ = chip_smoke.simulate_rna_pairs(fm.ref.joined, txs, 256, 27)
    items = chip_smoke.make_pair_batches(r1, r2, 0, 128)

    def sam(device):
        al = Aligner(fm, opts=AlignerOpts(spliced=True), device=device)
        if known:
            for st, ex in txs:
                for (_, e), (a, _) in zip(ex, ex[1:]):
                    al.ssdb.add_known(e - 1, a, st)
        return chip_smoke.run_pe_stream(al, items, fm.ref)
    before = dp_cuda.launches["dp_score"]
    on_card = sam("cuda")
    assert dp_cuda.launches["dp_score"] > before
    assert on_card == sam("cpu")
    assert sum("N" in ln.split("\t")[5]
               for ln in on_card[0].splitlines()) > 50


@pytest.mark.gpu
@pytest.mark.parametrize("what", ["long", "graph250"])
def test_wide_windows_sam_on_card_equals_cpu(what):
    """Reads of 2,100 bp (DP window W = 2136: the tiled kernel) and graph
    reads of 250 bp (W = 288 with the overlay: the one-block kernel's
    overlay instantiation): the card's SAM equals the CPU path's."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    g = np.random.default_rng(24).integers(0, 4, 60000).astype(np.uint8)
    ref = reference_from_seqs({"chrW": alphabet.decode(g)})
    if what == "long":
        fm = build_fm_index(ref)
        seqs, _, _ = chip_smoke.simulate_reads(ref.joined, 48, 25, rdlen=2100)
        items = chip_smoke.make_batches(seqs, 0, 48, 2104)
        kernel = "dp_score_tiled"
    else:
        from hisat2_tpu_torch.index.graph_index import build_graph_index
        snps, haps = chip_smoke.simulate_variants(ref.joined, 31, 250, 12)
        fm = build_graph_index(ref, snps, haplotypes=haps)
        hap = chip_smoke.apply_haplotype(ref.joined, snps, haps, 32)
        seqs, _, _ = chip_smoke.simulate_reads(hap[0], 256, 26, rdlen=250)
        items = chip_smoke.make_batches(seqs, 0, 256, 256)
        kernel = "dp_score_wide"

    def sam(device):
        return chip_smoke.run_stream(Aligner(fm, device=device), items,
                                     ref)[0]
    before = dp_cuda.launches[kernel]
    on_card = sam("cuda")
    assert dp_cuda.launches[kernel] > before
    assert on_card == sam("cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("config", [c[0] for c in chip_smoke.SMALL_CONFIGS])
def test_sharded_sam_on_card_equals_cpu(config):
    """ShardedAligner on chip_smoke's small sharded genome (three shards,
    cross-shard copies): SE, PE, a graph sharded index, RNA SE and PE with
    known sites and tmo. The card's SAM and stats equal the CPU path's,
    the DP kernels ran, and for PE the ladder's host-mode mate rescue
    launched the one-block kernel."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    case = chip_smoke.small_sharded_case()
    _, index, reads, opts, known, need = next(
        c for c in chip_smoke.SMALL_CONFIGS if c[0] == config)

    def sam(device):
        sa = chip_smoke.sharded_aligner(case, index, opts, known, device)
        return chip_smoke.run_sharded(sa, case[reads], case["ref"])
    before = dict(dp_cuda.launches)
    with chip_smoke.HostRescue() as hr:
        on_card = sam("cuda")
    for k in need:
        assert dp_cuda.launches[k] > before[k], k
    if reads == "pe":
        assert hr.launches > 0
    assert on_card == sam("cpu")


@pytest.mark.gpu
def test_sharded_eviction_frees_card_memory(monkeypatch):
    """Under a one-shard budget every activation evicts the shard before:
    the card's allocated memory falls before the next bundle is built, and
    the SAM bytes equal those of an aligner that keeps every shard."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from hisat2_tpu_torch.align import sharded as tsharded
    case = chip_smoke.small_sharded_case()
    sh = case["sh"]
    resident = chip_smoke.run_sharded(
        tsharded.ShardedAligner(sh, device="cuda"), case["se"], case["ref"])
    one = max(s.bundle_nbytes() for s in sh.shards)
    monkeypatch.setenv("HISAT2_TPU_HBM_GB", repr(1.5 * one / (1 << 30)))
    sa = tsharded.ShardedAligner(sh, device="cuda")
    sa._activate(0)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    at_build = []
    real = tsharded.Aligner

    def recording(*a, **kw):
        at_build.append(torch.cuda.memory_allocated())
        return real(*a, **kw)
    monkeypatch.setattr(tsharded, "Aligner", recording)
    sa._activate(1)
    monkeypatch.setattr(tsharded, "Aligner", real)
    assert sa.evictions == 1 and list(sa._resident) == [1]
    assert at_build[0] <= held - one
    assert chip_smoke.run_sharded(sa, case["se"], case["ref"]) == resident
    assert sa.evictions > 1


@pytest.mark.gpu
def test_repeat_aligner_on_card_equals_cpu():
    """RepeatAligner.align_repeats on the card (the per-read path on the
    repeat index) gives the CPU path's tuples, and its DP kernel ran."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from hisat2_tpu_torch.align.pipeline import RepeatAligner
    from hisat2_tpu_torch.index.repeats import build_repeats
    rng = np.random.default_rng(123)
    codes = rng.integers(0, 4, 40000).astype(np.uint8)
    for k in range(6):
        unit = rng.integers(0, 4, 150 + 100 * k).astype(np.uint8)
        for c in range(6):
            p = 1000 + 6000 * k + 900 * c
            codes[p:p + unit.size] = unit if c % 3 else alphabet.revcomp(unit)
    ref = reference_from_seqs({"chrR": alphabet.decode(codes)})
    db = build_repeats(ref, repeat_length=100, repeat_count=5)
    rep_fm = build_fm_index(reference_from_seqs(
        {r.name: alphabet.decode(r.seq) for r in db.repeats}))
    seqs, _, _ = chip_smoke.simulate_reads(ref.joined, 1024, 27)
    batch = chip_smoke.make_batches(seqs, 0, 1024)[0]
    before = dp_cuda.launches["dp_score"]
    on_card = RepeatAligner(rep_fm, db, device="cuda").align_repeats(batch)
    assert dp_cuda.launches["dp_score"] > before
    assert on_card == RepeatAligner(rep_fm, db,
                                    device="cpu").align_repeats(batch)
    assert sum(o is not None for o in on_card) >= 100
