"""A spliced candidate whose optimal outer clip takes a whole anchor (a 1-2
base anchor holding a mismatch, or a longer one of all mismatches, at the
read's head or tail) is written as the record its score describes: the
other segment alone, the anchor soft-clipped, unspliced, with the AS, XM,
NM and MD of that form. Every record is held to a plain walk of its CIGAR
over the genome under HISAT2's scoring (benchmark/reference/samcheck.py,
which imports nothing of the program): through _finalize_spliced, the SE
ladder (_finalize_results, where the SE spliced finish sends such rows),
and the spliced PE finish (_fin_mate_records inside pair_finish_rna) with
the per-pair ladder's bytes beside it; and a small RNA PE run through
cli.align.main, every record."""

import importlib.util
import io
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from hisat2_tpu_torch.align import emit as temit
from hisat2_tpu_torch.align import paired as tpaired
from hisat2_tpu_torch.align import paired_rna as tprna
from hisat2_tpu_torch.align.pipeline import NEG_INF, Aligner, AlignerOpts
from hisat2_tpu_torch.align.pipeline import ReadResult
from hisat2_tpu_torch.index.fm_index import build_fm_index
from hisat2_tpu_torch.io.reads import ReadBatch
from hisat2_tpu_torch.io.reference import reference_from_seqs
from hisat2_tpu_torch.utils import alphabet, metrics

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "bench_samcheck", os.path.join(ROOT, "benchmark", "reference",
                                   "samcheck.py"))
samcheck = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(samcheck)

L = 100
K2 = 4
G = 160_000
# (name, anchor side, anchor length, the anchor's mismatched columns
# counted from the junction, intron length); the last is a control whose
# junction stays
CASES = [
    ("head1", "head", 1, [0], 100),
    ("head2", "head", 2, [0], 12_000),
    ("head12", "head", 12, list(range(12)), 100),
    ("tail1", "tail", 1, [0], 12_000),
    ("tail2", "tail", 2, [0], 100),
    ("tail12", "tail", 12, list(range(12)), 100),
    ("spliced", "head", 40, [], 100),
]


def _plant(g, posA, delta, j, strand):
    """Write the intron's motif: [posA + j, posA + delta + j)."""
    dn, ac = ([2, 3], [0, 2]) if strand == "+" else ([1, 3], [0, 1])
    g[posA + j:posA + j + 2] = dn
    g[posA + delta + j - 2:posA + delta + j] = ac


@pytest.fixture(scope="module")
def world():
    """A random genome with one planted intron a case, an aligner in
    spliced mode on the CPU, and for each case the read (in alignment
    orientation, then as sequenced: the odd cases reverse-complemented)
    and its spliced candidate, scored as the device scores it."""
    rng = np.random.default_rng(2219)
    g = rng.integers(0, 4, G).astype(np.uint8)
    rows = []
    for k, (name, side, a, bad, delta) in enumerate(CASES):
        posA = 2000 + 20_000 * k
        j = a if side == "head" else L - a
        _plant(g, posA, delta, j, "+")
        rd = np.concatenate([g[posA:posA + j],
                             g[posA + delta + j:posA + delta + L]])
        for c in bad:
            col = j - 1 - c if side == "head" else j + c
            rd[col] = (rd[col] + 1 + c % 3) % 4
        fw = k % 2 == 0
        rows.append(dict(name=name, posA=posA, posB=posA + delta, j=j,
                         fw=fw, rd=rd,
                         seq=rd if fw else alphabet.revcomp(rd)))
    ref = reference_from_seqs({"chrS": alphabet.decode(g)})
    al = Aligner(build_fm_index(ref), opts=AlignerOpts(spliced=True),
                 device="cpu")
    B = len(rows)
    seqs = np.stack([r["seq"] for r in rows]).astype(np.uint8)
    quals = np.full((B, L), 40, np.int8)
    quals[:, 3::7] = 11                # a few low bins (none in the
    #                                    1-2 base anchors)
    for k, r in enumerate(rows):
        if len(CASES[k][3]) > 2:
            # a long anchor of errors sits in the lowest bins: its clip
            # then costs a base each and the read passes --score-min
            cols = np.arange(r["j"]) if CASES[k][1] == "head" else \
                np.arange(r["j"], L)
            quals[k, cols if r["fw"] else L - 1 - cols] = 2
    batch = ReadBatch(seqs, quals, np.full(B, L, np.int32),
                      [f"r{k}_{r['name']}" for k, r in enumerate(rows)])
    cands = []
    for i, r in enumerate(rows):
        segs = [(r["posA"], 0), (r["posB"], r["j"])]
        s = al._score_segs(i, batch, segs, r["fw"], [2], L)
        cands.append(dict(score=int(s), posA=r["posA"], posB=r["posB"],
                          fw=r["fw"], j=r["j"], delta=r["posB"] - r["posA"],
                          strand="+", canon=2, probscore=0.0))
    return SimpleNamespace(g=g, al=al, rows=rows, batch=batch, cands=cands)


def _walk(line, seq, qual, g):
    rec = samcheck.parse(line)
    return rec, samcheck.check_record(rec, seq, qual, g, samcheck.Known())


def _sam(al, batch, i, alns):
    res = ReadResult(alns=alns, best=alns[0].score if alns else NEG_INF)
    return temit._format_slow(al, batch, i, res, al.scoring)


def _degenerate(name):
    return name != "spliced"


def test_vectorized_rows_leave_degenerate_ones(world):
    """_spliced_fin_rows marks the rows whose clip took an anchor not ok,
    so the SE spliced finish and _fin_mate_records send them on."""
    B = len(world.rows)
    c = world.cands
    F = world.al._spliced_fin_rows(
        world.batch, np.arange(B),
        np.array([x["posA"] for x in c]), np.array([x["posB"] for x in c]),
        np.array([x["j"] for x in c]), np.array([x["fw"] for x in c]),
        np.array([x["strand"] for x in c]), np.full(B, L, np.int64))
    assert F["ok"].tolist() == [not _degenerate(r["name"])
                                for r in world.rows]


@pytest.mark.parametrize("k", range(len(CASES)), ids=[c[0] for c in CASES])
def test_finalize_spliced_agrees_with_the_walk(world, k):
    r, c = world.rows[k], world.cands[k]
    a = world.al._finalize_spliced(k, world.batch, c, L)
    assert a is not None
    ops = [op for op, _ in a.cigar]
    if _degenerate(r["name"]):
        assert "N" not in ops and a.xs_strand is None
        head = r["name"].startswith("head")
        seg = r["posB"] if head else r["posA"]
        clip = dict(a.cigar[:1]).get("S", 0) if head else \
            dict(a.cigar[-1:]).get("S", 0)
        assert clip >= (r["j"] if head else L - r["j"])
        assert a.joined_pos - seg == (clip if head else
                                      dict(a.cigar[:1]).get("S", 0))
        # the candidate's score less its intron penalty
        pen = max(0, int(-8.0 + np.log(c["delta"])))
        assert a.score == c["score"] + pen
    else:
        assert "N" in ops and a.score == c["score"]
    (line,) = _sam(world.al, world.batch, k, [a])
    rec, bad = _walk(line, world.batch.seqs[k], world.batch.quals[k],
                     world.g)
    assert bad is None, (r["name"], line)
    assert ("XS:A" in line) == (not _degenerate(r["name"]))


def _merged(world, rows, extra_reg=False):
    """A host candidate dict over the batch: each of `rows` with its
    spliced candidate in `splice`, and no contiguous candidate, or with
    extra_reg one on the diagonal a degenerate candidate is written on."""
    B = len(world.rows)
    m = dict(score=np.full((B, K2), NEG_INF, np.int64),
             pos=np.zeros((B, K2), np.int64), fw=np.zeros((B, K2), bool),
             gapped=np.zeros((B, K2), bool),
             splice={i: [world.cands[i]] for i in rows})
    if extra_reg:
        for i in rows:
            if not _degenerate(world.rows[i]["name"]):
                continue
            r = world.rows[i]
            diag = r["posB"] if r["name"].startswith("head") else r["posA"]
            a = world.al._finalize(i, world.batch, 0, diag, r["fw"], False,
                                   L)
            m["score"][i, 0] = a.score
            m["pos"][i, 0] = diag
            m["fw"][i, 0] = r["fw"]
    return m


@pytest.mark.parametrize("extra_reg", [False, True])
def test_se_ladder_agrees_with_the_walk(world, extra_reg):
    """The SE ladder (_finalize_results: _select_with_splice) writes each
    read once: beside a contiguous candidate on the same diagonal, the
    spliced candidate written unspliced is the same placement and one of
    the two is kept, the one of the higher AS."""
    rows = [k for k, r in enumerate(world.rows)
            if _degenerate(r["name"])]
    merged = _merged(world, rows, extra_reg)
    out = world.al._finalize_results(world.batch, merged,
                                     only_rows=np.array(rows))
    for i in rows:
        res = out[i]
        assert len(res.alns) == 1, (world.rows[i]["name"], res.alns)
        a = res.alns[0]
        assert res.best == a.score and "N" not in dict(a.cigar)
        if extra_reg:
            assert a.score >= world.cands[i]["score"]
        for line in temit._format_slow(world.al, world.batch, i, res,
                                       world.al.scoring):
            assert _walk(line, world.batch.seqs[i], world.batch.quals[i],
                         world.g)[1] is None, line


def _pairs(world, extra_reg=False):
    """Mate 1 the case reads; mate 2 a clean 100 bp read on the other
    strand, 150 bases past a forward mate 1's second segment or 250
    before a reverse one's first, with its contiguous candidate:
    concordant where the intron is short."""
    rows = world.rows
    B = len(rows)
    seq2, cand2 = [], []
    for r in rows:
        # FR: the forward mate upstream
        p2 = r["posB"] + L + 150 if r["fw"] else r["posA"] - 250
        rd2 = world.g[p2:p2 + L]
        fw2 = not r["fw"]
        seq2.append(rd2 if fw2 else alphabet.revcomp(rd2))
        cand2.append((p2, fw2))
    b1 = world.batch
    b2 = ReadBatch(np.stack(seq2).astype(np.uint8),
                   np.full((B, L), 40, np.int8), np.full(B, L, np.int32),
                   list(b1.names))
    m1 = _merged(world, range(B), extra_reg)
    m2 = dict(score=np.full((B, K2), NEG_INF, np.int64),
              pos=np.zeros((B, K2), np.int64), fw=np.zeros((B, K2), bool),
              gapped=np.zeros((B, K2), bool), splice={})
    for i, (p2, fw2) in enumerate(cand2):
        m2["score"][i, 0] = 0
        m2["pos"][i, 0] = p2
        m2["fw"][i, 0] = fw2
    return b1, b2, m1, m2


@pytest.mark.parametrize("khits,extra_reg", [(5, False), (5, True),
                                             (1, True)])
def test_pe_finish_agrees_with_the_walk_and_the_ladder(world, khits,
                                                       extra_reg):
    """pair_finish_rna: the pair with a junction left formats natively
    (_fin_mate_records), the pairs with a degenerate mate take the ladder;
    every record agrees with the walk, and the bytes are the per-pair
    ladder's on every pair. With extra_reg a degenerate mate also has a
    contiguous candidate on the diagonal its record is written on: the
    two combos are one placement, reported once and not counted as a
    second best for MAPQ, also under -k 1, where the second combo is not
    reported."""
    al = world.al if khits == 5 else Aligner(
        world.al.fm, opts=AlignerOpts(spliced=True, khits=khits),
        device="cpu")
    b1, b2, m1, m2 = _pairs(world, extra_reg)
    B = len(b1)
    bcat = tprna._concat_pair(b1, b2)
    w = SimpleNamespace(out=io.StringIO())
    metrics.start_trace()
    try:
        stats = tprna.pair_finish_rna(al, b1, b2, bcat, m1, m2, w)
    finally:
        tr = metrics.stop_trace()
    if not extra_reg:
        # the control formats natively, every other pair takes the ladder
        assert tr["counters"]["slow_reads"] == 2 * (B - 1)
    assert stats["pairs"] == B
    got = w.out.getvalue().splitlines(keepends=True)
    # the ladder on every pair: its bytes
    mate_cands, finalize = tpaired.mate_fns(al)
    want = []
    st = tpaired.new_pair_stats()
    for i in range(B):
        pr = tpaired._pair_result_one(al, i, b1, b2, m1, m2, None,
                                      mate_cands, finalize, [])
        if extra_reg:
            assert pr.secbest is None and not pr.alt_pairs
        want += tpaired.pair_lines(al, b1, b2, i, pr, st)
    assert got == want
    assert len(got) == 2 * B
    for t, line in enumerate(got):
        b = b1 if t % 2 == 0 else b2
        i = t // 2
        rec, bad = _walk(line, b.seqs[i], b.quals[i], world.g)
        assert bad is None, line
        assert rec["flag"] & 256 == 0          # one record a mate
        if world.cands[i]["delta"] > 200:
            continue                   # too far apart to pair
        assert rec["flag"] & 2, line
        if t % 2 == 0:
            assert ("N" in rec["cigar"]) == (
                not _degenerate(world.rows[i]["name"])), line


def test_fin_mate_records_sends_degenerate_rows_on(world):
    """The spliced rows of _fin_mate_records: ok on the control only."""
    b1, b2, m1, _ = _pairs(world)
    B = len(b1)
    lens = np.full(B, L, np.int64)
    aug, _ = tprna._augmented_mate(m1, m1["splice"], lens,
                                   np.full(B, -1000, np.int64))
    rec_pair = np.arange(B)
    tcol = np.full(B, K2)
    f = tprna._fin_mate_records(world.al, tprna._concat_pair(b1, b2), B,
                                rec_pair, tcol, aug, m1["splice"], False,
                                lens)
    assert f["ok"].tolist() == [not _degenerate(r["name"])
                                for r in world.rows]


# ---- a small seeded RNA PE run through cli.align.main ----

def _fastq(path, names, seqs, quals):
    with open(path, "w") as fh:
        for n, s, q in zip(names, seqs, quals):
            fh.write(f"@{n}\n{alphabet.decode(s)}\n+\n"
                     f"{(q + 33).astype(np.uint8).tobytes().decode()}\n")


def test_cli_rna_pe_records_agree_with_the_walk(tmp_path, monkeypatch):
    """Pairs along planted transcripts (chip_smoke.simulate_rna_pairs),
    with 3% of their bases changed on top, through the CLI
    with the transcripts' splice sites and exons: every record agrees with
    the walk, and some spliced candidate was written unspliced."""
    from hisat2_tpu_torch.cli import align as cli_align
    from hisat2_tpu_torch.cli import build as cli_build
    rng = np.random.default_rng(31)
    g = rng.integers(0, 4, 120_000).astype(np.uint8)
    txs = chip_smoke.simulate_gene_model(g, 32, n_tx=16)
    n = 400
    r1, r2, truth = chip_smoke.simulate_rna_pairs(g, txs, n, 33)
    reads = [r1.copy(), r2.copy()]
    for m in range(2):                 # errors on top: 3% of the bases
        err = rng.random((n, L)) < 0.03
        reads[m][err] = (reads[m][err] + 1) % 4
    quals = [np.where(rng.random((n, L)) < 0.1, 11, 37).astype(np.int64)
             for _ in range(2)]
    (tmp_path / "g.fa").write_text(f">chrS\n{alphabet.decode(g)}\n")
    with open(tmp_path / "g.ss", "w") as ss, open(tmp_path / "g.exon",
                                                   "w") as ex:
        for strand, exons in txs:
            for (_, e), (a, _) in zip(exons, exons[1:]):
                ss.write(f"chrS\t{e - 1}\t{a}\t{strand}\n")
            for a, e in exons:
                ex.write(f"chrS\t{a}\t{e - 1}\t{strand}\n")
    idx = str(tmp_path / "idx")
    assert cli_build.main([str(tmp_path / "g.fa"), idx, "--ss",
                           str(tmp_path / "g.ss"), "--exon",
                           str(tmp_path / "g.exon"), "--quiet"]) == 0
    names = [f"p{i}" for i in range(n)]
    for m in range(2):
        _fastq(tmp_path / f"r{m + 1}.fq", names, reads[m], quals[m])
    unspliced = []
    orig = Aligner._finalize_spliced

    def spy(self, i, batch, c, rdlen):
        a = orig(self, i, batch, c, rdlen)
        if a is not None and not any(op == "N" for op, _ in a.cigar):
            unspliced.append(a)
        return a
    monkeypatch.setattr(Aligner, "_finalize_spliced", spy)
    assert cli_align.main(["-x", idx, "-1", str(tmp_path / "r1.fq"),
                           "-2", str(tmp_path / "r2.fq"), "-S",
                           str(tmp_path / "o.sam"), "--batch-size", "128",
                           "--quiet", "--device", "cpu"]) == 0
    byname = {}
    for m in range(2):
        for i in range(n):
            byname[(f"p{i}", m)] = (reads[m][i], quals[m][i])
    checked = 0
    for line in (tmp_path / "o.sam").read_text().splitlines():
        if line.startswith("@"):
            continue
        rec = samcheck.parse(line)
        seq, q = byname[(rec["qname"], 0 if rec["flag"] & 64 else 1)]
        bad = samcheck.check_record(rec, seq, q, g, samcheck.Known(
            genes=txs))
        assert bad is None, (bad, line)
        checked += 1
    assert checked >= 2 * n
    assert unspliced
