"""Spliced (RNA) single-end alignment, the port against the JAX package:
SAM bytes, stats and the published novel sites must be equal.

On the genome of tests/test_spliced.py (canonical GT..AG introns planted
every 5 kb, cut to 50 kb), one batch of that file's reads (junctions at
50/50, 30/70 and 96/4 anchors, a reverse-complemented one, one with a
mismatch, far anchors of 9 bp that only the anchor scan finds, a
contiguous read) and 150 more reads across the planted junctions and off
them. Every configuration of the slice: the packed stream
(emit.align_and_emit_stream), seed_mode=False (the unpacked per-read emit
path) and align_batch + results_to_sam; known sites or none; dta; tmo; a
table index and the same index without its table (FM-seeded)."""

import io

import numpy as np
import pytest
import torch

from test_torch_graph_pipeline import strip_table
import test_torch_native_cache  # noqa: F401  (JAX native libs, built once under a lock)
from hisat2_tpu.align import emit as jemit
from hisat2_tpu.align.pipeline import Aligner as JAligner
from hisat2_tpu.align.pipeline import AlignerOpts as JOpts
from hisat2_tpu.align.pipeline import results_to_sam as j_results_to_sam
from hisat2_tpu.index.fm_index import build_fm_index
from hisat2_tpu.io import sam as jsam
from hisat2_tpu.io.reads import Read as JRead, batchify as jbatchify
from hisat2_tpu.io.reference import reference_from_seqs
from hisat2_tpu.utils import alphabet as jalphabet

from hisat2_tpu_torch.align import emit as temit
from hisat2_tpu_torch.align.pipeline import Aligner as TAligner
from hisat2_tpu_torch.align.pipeline import AlignerOpts as TOpts
from hisat2_tpu_torch.align.pipeline import results_to_sam as t_results_to_sam
from hisat2_tpu_torch.index.fm_index import FMIndex
from hisat2_tpu_torch.io import sam as tsam
from hisat2_tpu_torch.io.reads import Read as TRead, batchify as tbatchify

torch.set_num_threads(1)

GENOME = 50000


def genome_with_introns(rng, n=GENOME):
    """tests/test_spliced.py's genome: random, with canonical GT..AG
    introns of 200-2,000 bp planted every 5 kb."""
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    introns = []
    for start in range(3000, n - 3000, 5000):
        ilen = int(rng.integers(200, 2000))
        if start + ilen + 200 >= n:
            continue
        codes[start] = 2
        codes[start + 1] = 3
        codes[start + ilen - 2] = 0
        codes[start + ilen - 1] = 2
        introns.append((start, ilen))
    return codes, introns


def junction_read(codes, start, ilen, left=50, right=50):
    return np.concatenate([codes[start - left:start],
                           codes[start + ilen:start + ilen + right]])


def rna_reads(codes, introns, seed=5, n_junction=120, n_contig=30):
    """test_spliced.py's reads, then random junction reads (anchors 5-95,
    every third with a mismatch, every second reverse-complemented) and
    contiguous ones."""
    reads = [("j0", junction_read(codes, *introns[0])),
             ("j1", junction_read(codes, *introns[1], left=30, right=70)),
             ("jr", jalphabet.revcomp(junction_read(codes, *introns[2]))),
             ("jm", junction_read(codes, *introns[3]).copy()),
             ("jk", junction_read(codes, *introns[4], left=96, right=4)),
             ("jn", junction_read(codes, *introns[5])),
             ("sj1", junction_read(codes, *introns[1], left=91, right=9)),
             ("sj2", junction_read(codes, *introns[2], left=9, right=91)),
             ("contig", codes[9000:9100].copy())]
    reads[3][1][20] = (reads[3][1][20] + 1) % 4
    rng = np.random.default_rng(seed)
    for k in range(n_junction):
        s, il = introns[k % len(introns)]
        left = int(rng.integers(5, 96))
        seq = junction_read(codes, s, il, left, 100 - left).copy()
        if k % 3 == 0:
            seq[rng.integers(0, 100)] ^= 1
        if k % 2:
            seq = jalphabet.revcomp(seq)
        reads.append((f"r{k}", seq))
    for k in range(n_contig):
        p = int(rng.integers(0, codes.size - 100))
        reads.append((f"c{k}", codes[p:p + 100].copy()))
    return reads


def batches(reads):
    q = np.full(100, 40, np.int8)
    return (jbatchify([JRead(n, s, q, i) for i, (n, s) in enumerate(reads)],
                      pad_to=104),
            tbatchify([TRead(n, s, q, i) for i, (n, s) in enumerate(reads)],
                      pad_to=104))


@pytest.fixture(scope="module")
def world():
    codes, introns = genome_with_introns(np.random.default_rng(99))
    ref = reference_from_seqs({"chrR": jalphabet.decode(codes)})
    jfm = build_fm_index(ref, ftab_k=6)
    jfms = {"table": jfm, "fm": strip_table(jfm)}
    tfms = {k: FMIndex.from_object(j) for k, j in jfms.items()}
    return dict(codes=codes, introns=introns, ref=ref, jfms=jfms, tfms=tfms,
                reads=rna_reads(codes, introns))


def sam(emit_fn, sammod, al, ref, *args):
    buf = io.StringIO()
    st = emit_fn(al, *args, sammod.SamWriter(
        buf, list(ref.names), [int(x) for x in ref.tlens], no_head=True))
    return buf.getvalue(), st


def aligners(world, seeding, known, **opts):
    ja = JAligner(world["jfms"][seeding], opts=JOpts(spliced=True, **opts))
    ta = TAligner(world["tfms"][seeding], opts=TOpts(spliced=True, **opts),
                  device="cpu")
    if known:
        for s, il in world["introns"][::2]:
            ja.ssdb.add_known(s - 1, s + il, "+")
            ta.ssdb.add_known(s - 1, s + il, "+")
    return ja, ta


def run(world, how, ja, ta):
    jb, tb = batches(world["reads"])
    ref = world["ref"]
    if how == "align_batch":
        jtext, jst = sam(lambda al, w: j_results_to_sam(
            jb, al.align_batch(jb), al, w), jsam, ja, ref)
        ttext, tst = sam(lambda al, w: t_results_to_sam(
            tb, al.align_batch(tb), al, w), tsam, ta, ref)
    else:
        jtext, jst = sam(jemit.align_and_emit_stream, jsam, ja, ref, [jb])
        ttext, tst = sam(temit.align_and_emit_stream, tsam, ta, ref, [tb])
    return jtext, jst, ttext, tst


@pytest.mark.parametrize("how,seeding,known,opts", [
    ("stream", "table", False, {}),
    ("stream", "table", True, {}),
    ("stream", "table", False, dict(dta=True)),
    ("stream", "table", True, dict(tmo=True)),
    ("stream", "fm", False, {}),
    ("stream", "fm", True, dict(dta=True)),
    ("stream", "table", True, dict(seed_mode=False)),
    ("stream", "fm", False, dict(seed_mode=False)),
    ("align_batch", "table", False, {}),
    ("align_batch", "table", True, dict(tmo=True)),
    ("align_batch", "fm", True, {}),
])
def test_spliced_sam_equals_jax(world, how, seeding, known, opts):
    ja, ta = aligners(world, seeding, known, **opts)
    jtext, jst, ttext, tst = run(world, how, ja, ta)
    assert tst == jst
    assert ttext == jtext
    assert ta.ssdb.novel == ja.ssdb.novel
    assert ta.ssdb.version() == ja.ssdb.version()
    recs = {ln.split("\t")[0]: ln.split("\t") for ln in jtext.splitlines()
            if not int(ln.split("\t")[1]) & 256}
    if opts.get("tmo"):
        # only alignments spliced through known sites report
        assert all("N" in f[5] for f in recs.values() if not int(f[1]) & 4)
        assert int(recs["contig"][1]) & 4
    else:
        s, il = world["introns"][0]
        assert recs["j0"][5] == f"50M{il}N50M"
        assert sum("N" in f[5] for f in recs.values()) >= 100


def test_spliced_results_equal_jax(world):
    """align_batch's ReadResults alignment by alignment: coordinates,
    CIGAR, MD, NM, XS:A strand, best and second-best."""
    ja, ta = aligners(world, "table", True)
    jb, tb = batches(world["reads"])
    jres, tres = ja.align_batch(jb), ta.align_batch(tb)
    assert len(jres) == len(tres)
    for a, b in zip(jres, tres):
        assert (a.best, a.secbest, a.filtered) == (b.best, b.secbest,
                                                   b.filtered)
        assert len(a.alns) == len(b.alns)
        for x, y in zip(a.alns, b.alns):
            assert (x.joined_pos, x.fw, x.score, x.cigar, x.md, x.nm,
                    x.nmm, x.xs_strand, x.tidx, x.toff) == \
                (y.joined_pos, y.fw, y.score, y.cigar, y.md, y.nm, y.nmm,
                 y.xs_strand, y.tidx, y.toff)


def test_spliced_pe_refused(world):
    """Spliced paired-end alignment is ported: both PE entry points that
    refused it (align_pairs, submit_pe) give the JAX package's SAM bytes,
    stats and published sites on this file's reads: mate 1 the first 16,
    mate 2 their reverse complements (fragments of one read length, both
    mates over the same junction: TLEN counts its intron once)."""
    from hisat2_tpu.align import paired as jpaired
    from hisat2_tpu_torch.align import paired as tpaired
    reads = world["reads"][:16]
    jb1, tb1 = batches(reads)
    jb2, tb2 = batches([(n, jalphabet.revcomp(s)) for n, s in reads])
    ref = world["ref"]
    for entry in ("align_pairs", "submit_pe"):
        ja, ta = aligners(world, "table", False)
        if entry == "align_pairs":
            jtext, jst = sam(lambda al, w: jpaired.pairs_to_sam(
                jb1, jb2, jpaired.align_pairs(al, jb1, jb2), al, w),
                jsam, ja, ref)
            ttext, tst = sam(lambda al, w: tpaired.pairs_to_sam(
                tb1, tb2, tpaired.align_pairs(al, tb1, tb2), al, w),
                tsam, ta, ref)
        else:
            jtext, jst = sam(lambda al, w: jemit.finish_pe(
                al, jemit.submit_pe(al, jb1, jb2), w), jsam, ja, ref)
            ttext, tst = sam(lambda al, w: temit.finish_pe(
                al, temit.submit_pe(al, tb1, tb2), w), tsam, ta, ref)
        assert tst == jst and ttext == jtext
        assert ta.ssdb.novel == ja.ssdb.novel
        recs = [ln.split("\t") for ln in ttext.splitlines()]
        assert sum("N" in f[5] for f in recs) >= 16
        # j0: 50M{il}N50M on both mates, TLEN one read length
        s, il = world["introns"][0]
        assert [(f[5], abs(int(f[8]))) for f in recs if f[0] == "j0"] == \
            [(f"50M{il}N50M", 100)] * 2
