"""The port's SNP-aware ("graph") alignment against the JAX package's, as
a whole: SAM bytes and stats, single-end and paired-end.

The genome and variants of test_torch_graph_index (SNVs every 400 bp, a
two-alt site, a known deletion, a known insertion, a phased group of three
dense variants with its haplotype patch), indexed by the JAX package and
handed to the port as the same arrays: `table`, the graph index with its
k-mer table, and `fm`, the same index with the table stripped, which seeds
by FM backward search through the patch fragments. Reads are the cases of
tests/test_graph_snp.py (alt allele, ref allele, alt + mismatch, known
deletion, known insertion, the haplotype) and reads cut from a random
haplotype (each variant applied with probability 0.5) with mismatches, Ns,
novel indels and reverse complements on top, so the overlay reaches the
verify, the finalization, the DP and the per-read finish. Checked exactly:
align_and_emit_stream (packed step), align_and_emit_pe_stream (packed and
fused steps), the seed_mode=False paths, zs_tags=True, align_batch +
results_to_sam and align_pairs + pairs_to_sam; exactly but for the records
where the JAX package scores a known SNV's allele as a mismatch after a DP
traceback or a mate rescue (ROADMAP.md Queue C 19), which are held to a
walk of their CIGAR instead (tests/torch_walk.py)."""

import copy
import io

import numpy as np
import pytest
import torch

from test_torch_graph_index import HAP_AT, MULTI_AT, graph_world
from torch_walk import assert_alns_like_reference, assert_sam_like_reference
import test_torch_native_cache  # noqa: F401  (JAX native libs, built once under a lock)
from hisat2_tpu.align import emit as jemit
from hisat2_tpu.align import paired as jpaired
from hisat2_tpu.align import pipeline as jpipe
from hisat2_tpu.align.pipeline import Aligner as JAligner
from hisat2_tpu.align.pipeline import AlignerOpts as JOpts
from hisat2_tpu.io import sam as jsam
from hisat2_tpu.io.reads import Read as JRead, batchify as jbatchify
from hisat2_tpu.utils import alphabet as jalphabet

from hisat2_tpu_torch.align import emit as temit
from hisat2_tpu_torch.align import paired as tpaired
from hisat2_tpu_torch.align import pipeline as tpipe
from hisat2_tpu_torch.align.pipeline import Aligner as TAligner
from hisat2_tpu_torch.align.pipeline import AlignerOpts as TOpts
from hisat2_tpu_torch.index.fm_index import FMIndex
from hisat2_tpu_torch.io import sam as tsam
from hisat2_tpu_torch.io.reads import Read as TRead, batchify as tbatchify
from hisat2_tpu_torch.ops import dp_cuda

torch.set_num_threads(1)

RDLEN = 100
PAD = 104
NSE = 96         # reads per SE batch
NPE = 72         # pairs per PE batch


def strip_table(jfm):
    """The same JAX graph index without its k-mer table: FM-seeded."""
    j = copy.copy(jfm)
    j.__dict__.pop("device", None)         # the cached device dict
    j.st_starts = j.st_pos = None
    j.st_k = 0
    return j


def haplotype(codes, snps, s, n, rng, p=0.5):
    """n bases of a random haplotype starting at joined position s: each
    variant met on the way is applied with probability p."""
    out = []
    pos = s
    si = int(np.searchsorted(snps.jpos, s))
    got = 0
    while got < n:
        nxt = int(snps.jpos[si]) if si < len(snps) else 1 << 40
        if nxt < pos:                      # inside an applied deletion
            si += 1
            continue
        take = min(n - got, nxt - pos)
        out.append(codes[pos:pos + take])
        got += take
        pos += take
        if got == n:
            break
        if rng.random() < p:
            t, ln = int(snps.types[si]), int(snps.lens[si])
            if t == 0:
                out.append(np.array([snps.alt_codes[si]], np.uint8))
                got += 1
                pos += 1
            elif t == 1:
                pos += ln
            else:
                out.append(snps.ins_seqs[si])
                got += ln
        si += 1
    return np.concatenate(out)[:n].astype(np.uint8)


def fixed_cases(codes, snps):
    """The reads of tests/test_graph_snp.py on this genome."""
    sv = np.flatnonzero((snps.types == 0) & (snps.jpos < 29000)
                        & (snps.jpos != MULTI_AT))
    out = []

    def around(i, alt=True):
        p = int(snps.jpos[i])
        seq = codes[p - 50:p + 50].copy()
        if alt:
            seq[50] = int(snps.alt_codes[i])
        return seq
    out.append(("alt", around(sv[10])))
    out.append(("ref", around(sv[5], alt=False)))
    am = around(sv[20])
    am[10] = (am[10] + 1) % 4
    out.append(("altmm", am))
    di = int(np.flatnonzero((snps.types == 1) & (snps.jpos < 30000))[0])
    vp, d = int(snps.jpos[di]), int(snps.lens[di])
    out.append(("del", np.concatenate([codes[vp - 47:vp],
                                       codes[vp + d:vp + d + 53]])))
    ii = int(np.flatnonzero(snps.types == 2)[0])
    vp, ins = int(snps.jpos[ii]), snps.ins_seqs[ii]
    out.append(("ins", np.concatenate([codes[vp - 50:vp], ins,
                                       codes[vp:vp + 50 - ins.size]])))
    for j in (1, 2):                        # either alt of the two-alt site
        m = codes[MULTI_AT - 30:MULTI_AT + 70].copy()
        m[30] = (int(codes[MULTI_AT]) + j) % 4
        out.append((f"multi{j}", m))
    p = HAP_AT
    a1 = (int(codes[p]) + 1) % 4
    a2 = (int(codes[p + 20]) + 2) % 4
    out.append(("hap", np.concatenate([
        codes[p - 40:p], [a1], codes[p + 1:p + 8], codes[p + 10:p + 20],
        [a2], codes[p + 21:p + 21 + 42]]).astype(np.uint8)))
    return out


def se_reads(codes, snps, rng, n):
    out = fixed_cases(codes, snps)
    kinds = ["hapl", "hapl", "mm", "n", "indel", "hapl_rc", "short",
             "random"]
    sv = snps.jpos[snps.types == 0]
    i = 0
    while len(out) < n:
        kind = kinds[i % len(kinds)]
        i += 1
        ln = RDLEN if kind != "short" else int(rng.integers(30, 90))
        if kind == "random":
            out.append((kind, rng.integers(0, 4, ln).astype(np.uint8)))
            continue
        # most reads over a variant
        s = int(rng.choice(sv)) - int(rng.integers(5, ln - 5)) \
            if rng.random() < 0.8 else int(rng.integers(0, 41000 - ln))
        s = min(max(s, 0), codes.size - ln - 20)
        seq = haplotype(codes, snps, s, ln + 4, rng)
        if kind == "indel":
            d = int(rng.integers(1, 4))
            p = int(rng.integers(20, 80))
            if rng.random() < 0.5:
                seq = np.concatenate([seq[:p], seq[p + d:]])
            else:
                seq = np.concatenate([seq[:p], rng.integers(0, 4, d).astype(
                    np.uint8), seq[p:]])
        seq = seq[:ln].copy()
        if kind in ("mm", "n", "indel"):
            m = rng.random(ln) < 0.02
            seq[m] = (seq[m] + rng.integers(1, 4, int(m.sum()))) % 4
        if kind == "n":
            seq[rng.random(ln) < 0.04] = 4
        if kind == "hapl_rc" or rng.random() < 0.3:
            seq = jalphabet.revcomp(seq)
        out.append((kind, seq))
    return [(f"r{k}_{kind}", seq) for k, (kind, seq) in enumerate(out)]


def pe_pairs(codes, snps, rng, n):
    out = []
    sv = snps.jpos[snps.types == 0]
    kinds = ["hapl", "hapl", "mm", "indel", "randmate", "hapl"]
    for i in range(n):
        kind = kinds[i % len(kinds)]
        ins = int(rng.integers(200, 500))
        s = int(rng.choice(sv)) - int(rng.integers(5, 95))
        s = min(max(s, 0), codes.size - ins - 40)
        frag = haplotype(codes, snps, s, ins + 4, rng)
        r1 = frag[:RDLEN].copy()
        r2 = jalphabet.revcomp(frag[ins - RDLEN:ins])
        if kind == "indel":
            d = int(rng.integers(1, 4))
            p = int(rng.integers(20, 80))
            r1 = np.concatenate([frag[:p], frag[p + d:RDLEN + d]])
        elif kind == "randmate":
            r2 = rng.integers(0, 4, RDLEN).astype(np.uint8)
        if kind in ("mm", "indel"):
            for r in (r1, r2):
                m = rng.random(RDLEN) < 0.015
                r[m] = (r[m] + rng.integers(1, 4, int(m.sum()))) % 4
        if rng.random() < 0.5:
            r1, r2 = r2, r1
        out.append((f"p{i}_{kind}", r1, r2))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = graph_world(tmp_path_factory.mktemp("graph"))
    rng = np.random.default_rng(505)
    codes, snps = w["codes"], w["snps"]
    jfms = {"table": w["jfm"], "fm": strip_table(w["jfm"])}
    tfms = {k: FMIndex.from_object(j) for k, j in jfms.items()}
    reads = se_reads(codes, snps, rng, 2 * NSE)
    quals = [rng.integers(2, 42, s.size).astype(np.int8)
             for _, s in reads[:NSE]] + \
            [np.full(s.size, 40, np.int8) for _, s in reads[NSE:]]
    se = {}
    for which, mod_read, mod_batchify in (("j", JRead, jbatchify),
                                          ("t", TRead, tbatchify)):
        rs = [mod_read(n, s, q, i) for i, ((n, s), q)
              in enumerate(zip(reads, quals))]
        se[which] = [mod_batchify(rs[:NSE], pad_to=PAD),
                     mod_batchify(rs[NSE:], pad_to=PAD)]
    pairs = pe_pairs(codes, snps, rng, NPE)
    pe = {}
    for what in ("const", "perbase"):
        if what == "const":
            q = [(np.full(RDLEN, 40, np.int8),) * 2] * NPE
        else:
            q = [(rng.integers(2, 42, RDLEN).astype(np.int8),
                  rng.integers(2, 42, RDLEN).astype(np.int8))
                 for _ in range(NPE)]
        pe[what] = {}
        for which, mod_read, mod_batchify in (("j", JRead, jbatchify),
                                              ("t", TRead, tbatchify)):
            b1 = mod_batchify([mod_read(n, r1, q1, i) for i, ((n, r1, _),
                              (q1, _)) in enumerate(zip(pairs, q))],
                              pad_to=PAD)
            b2 = mod_batchify([mod_read(n, r2, q2, i) for i, ((n, _, r2),
                              (_, q2)) in enumerate(zip(pairs, q))],
                              pad_to=PAD)
            pe[what][which] = (b1, b2)
    return dict(jfms=jfms, tfms=tfms, se=se, pe=pe, snps=snps,
                ref=w["jfm"].ref)


def aligners(world, name, **opts):
    return (JAligner(world["jfms"][name], opts=JOpts(**opts)),
            TAligner(world["tfms"][name], opts=TOpts(**opts), device="cpu"))


def head(b, n):
    """The first n reads of a batch, as a batch of the same package."""
    return type(b)(b.seqs[:n], b.quals[:n], b.lens[:n], b.names[:n],
                   b.rdids[:n])


def _sam(emit_fn, sammod, al, ref, *args):
    buf = io.StringIO()
    st = emit_fn(al, *args, sammod.SamWriter(
        buf, list(ref.names), [int(x) for x in ref.tlens], no_head=True))
    return buf.getvalue(), st


def _fields(text):
    return {ln.split("\t")[0]: ln.split("\t") for ln in text.splitlines()
            if not int(ln.split("\t")[1]) & 256}


def test_aligner_graph_extras(world):
    for name, seeder in (("table", "table"), ("fm", "seeds")):
        jal, tal = aligners(world, name)
        assert tal.seeder == jal.seeder == seeder
        assert tal.overlay is not None and tal.snps is not None
        assert tal._del_snps == jal._del_snps and len(tal._del_snps) == 2
        assert sorted(tal._ins_snps) == sorted(jal._ins_snps)
        assert "snv_packed" in tal.idx and "patch_start" in tal.idx
        assert ("sides" in tal.idx) == (name == "fm")


@pytest.mark.parametrize("name,opts", [
    ("table", {}), ("fm", {}), ("table", dict(seed_mode=False)),
    ("fm", dict(seed_mode=False)), ("table", dict(zs_tags=True)),
    ("fm", dict(zs_tags=True)), ("table", dict(khits=3))],
    ids=["table", "fm", "table-per-read", "fm-per-read", "table-zs", "fm-zs",
         "table-k3"])
def test_se_sam_bytes_match(world, name, opts):
    jal, tal = aligners(world, name, **opts)
    ref = world["ref"]
    jtext, jst = _sam(jemit.align_and_emit_stream, jsam, jal, ref,
                      world["se"]["j"])
    before = dict(dp_cuda.launches)
    ttext, tst = _sam(temit.align_and_emit_stream, tsam, tal, ref,
                      world["se"]["t"])
    assert dp_cuda.launches == before       # CPU: the plain version
    assert tst == jst
    assert_sam_like_reference(tal, ttext, jtext)
    f = _fields(ttext)
    # the cases of the JAX package's own graph tests, through the stream
    for name_, cigar in (("r0_alt", "100M"), ("r1_ref", "100M"),
                         ("r3_del", "47M3D53M"), ("r4_ins", "50M3I47M"),
                         ("r5_multi1", "100M"), ("r6_multi2", "100M")):
        rec = f[name_]
        assert rec[5] == cigar, (name_, rec[5])
        assert {"AS:i:0", "XM:i:0", "NM:i:0"} <= set(rec[11:]), name_
    # only the real mismatch is penalized (by its base quality) and counted
    assert "XM:i:1" in f["r2_altmm"] and "NM:i:1" in f["r2_altmm"]
    assert "D" in f["r7_hap"][5] and "AS:i:0" in f["r7_hap"]
    assert "MD:Z:100" not in f["r0_alt"]    # MD still names the ref base
    assert any(("I" in r[5] or "D" in r[5]) and "AS:i:0" not in r
               for r in f.values())         # a novel indel through the DP
    assert tst["unal"] < tst["reads"] // 3
    zs = [r for r in f.values() if any(x.startswith("Zs:Z:") for x in r)]
    assert bool(zs) == bool(opts.get("zs_tags"))
    if zs:
        snp = world["snps"]
        k = int(np.flatnonzero((snp.types == 0) & (snp.jpos < 29000)
                               & (snp.jpos != MULTI_AT))[10])
        assert f"Zs:Z:50|S|{snp.names[k]}" in f["r0_alt"]


@pytest.mark.parametrize("name,seed_mode,zs", [
    ("table", True, False), ("table", False, False), ("fm", True, False),
    ("table", False, True)])
def test_align_batch_and_results_to_sam(world, name, seed_mode, zs):
    jal, tal = aligners(world, name, seed_mode=seed_mode, zs_tags=zs)
    ref = world["ref"]
    jb, tb = world["se"]["j"][0], world["se"]["t"][0]
    jres = jal.align_batch(jb)
    tres = tal.align_batch(tb)
    assert len(tres) == len(jres)
    for i, (t, j) in enumerate(zip(tres, jres)):
        assert t.filtered == j.filtered
        assert len(t.alns) == len(j.alns)
        diff = [assert_alns_like_reference(
            tal, a, b, tb, i, ("joined_pos", "fw", "score", "cigar", "nmm",
                               "gap_opens", "gap_exts", "md", "nm", "tidx",
                               "toff", "zs_snps"))
            for a, b in zip(t.alns, j.alns)]
        if any(diff):       # best and secbest follow the alignments' AS
            assert (t.best, t.secbest) == (
                t.alns[0].score,
                t.alns[1].score if len(t.alns) > 1 else None)
        else:
            assert (t.best, t.secbest) == (j.best, j.secbest)
    assert any(a.zs_snps for r in tres for a in r.alns) == zs
    # the known deletion and insertion: zero-cost gaps
    for k, op in ((3, "D"), (4, "I")):
        a = tres[k].alns[0]
        assert a.score == 0 and a.nm == 0 and a.gap_opens == 0
        assert [o for o, _ in a.cigar] == ["M", op, "M"]
    jtext, jst = _sam(lambda al, b, res, w: jpipe.results_to_sam(
        b, res, al, w), jsam, jal, ref, jb, jres)
    ttext, tst = _sam(lambda al, b, res, w: tpipe.results_to_sam(
        b, res, al, w), tsam, tal, ref, tb, tres)
    assert tst == jst
    assert_sam_like_reference(tal, ttext, jtext)


def test_legacy_emit_on_a_graph_index(world):
    """_align_and_emit_legacy's fused branch (device_align_fused), which a
    Zs-tag run reaches: called directly, with and without the tags."""
    ref = world["ref"]
    for zs in (False, True):
        jal, tal = aligners(world, "table", zs_tags=zs)
        for jb, tb in zip(world["se"]["j"], world["se"]["t"]):
            jtext, jst = _sam(jemit._align_and_emit_legacy, jsam, jal, ref,
                              jb)
            ttext, tst = _sam(temit._align_and_emit_legacy, tsam, tal, ref,
                              tb)
            assert tst == jst
            assert_sam_like_reference(tal, ttext, jtext)


@pytest.mark.parametrize("name", ["table", "fm"])
@pytest.mark.parametrize("step,opts", [
    ("const", {}), ("perbase", {}), ("perbase", dict(seed_mode=False)),
    ("const", dict(zs_tags=True)), ("perbase", dict(zs_tags=True))],
    ids=["packed", "fused", "per-pair", "zs-const", "zs-perbase"])
def test_pe_sam_bytes_match(world, name, step, opts):
    jal, tal = aligners(world, name, **opts)
    ref = world["ref"]
    jtext, jst = _sam(jemit.align_and_emit_pe_stream, jsam, jal, ref,
                      [world["pe"][step]["j"]])
    before = dict(dp_cuda.launches)
    ttext, tst = _sam(temit.align_and_emit_pe_stream, tsam, tal, ref,
                      [world["pe"][step]["t"]])
    assert dp_cuda.launches == before
    assert tst == jst
    assert_sam_like_reference(tal, ttext, jtext)
    assert tst["conc_uniq"] + tst["conc_multi"] > NPE // 2
    lines = [ln.split("\t") for ln in ttext.splitlines()]
    # pairs whose mates carry alt alleles come out penalty-free
    assert sum("AS:i:0" in r and "MD:Z:100" not in r and r[5] == "100M"
               for r in lines) > 10
    assert any("D" in r[5] or "I" in r[5] for r in lines)


@pytest.mark.parametrize("seed_mode", [True, False])
def test_align_pairs_and_pairs_to_sam(world, seed_mode):
    jal, tal = aligners(world, "table", seed_mode=seed_mode)
    ref = world["ref"]
    jb1, jb2 = world["pe"]["perbase"]["j"]
    tb1, tb2 = world["pe"]["perbase"]["t"]
    jres = jpaired.align_pairs(jal, jb1, jb2)
    tres = tpaired.align_pairs(tal, tb1, tb2)
    assert [r.kind for r in tres] == [r.kind for r in jres]
    for i, (t, j) in enumerate(zip(tres, jres)):
        assert (t.best, t.secbest) == (j.best, j.secbest)
        for a, b, tb in ((t.aln1, j.aln1, tb1), (t.aln2, j.aln2, tb2)):
            assert (a is None) == (b is None)
            if a is not None:
                assert_alns_like_reference(
                    tal, a, b, tb, i,
                    ("joined_pos", "fw", "score", "cigar", "md", "nm"))
    jtext, jst = _sam(lambda al, r, w: jpaired.pairs_to_sam(
        jb1, jb2, r, al, w), jsam, jal, ref, jres)
    ttext, tst = _sam(lambda al, r, w: tpaired.pairs_to_sam(
        tb1, tb2, r, al, w), tsam, tal, ref, tres)
    assert tst == jst
    assert_sam_like_reference(tal, ttext, jtext)


def test_options_still_unported_raise(world):
    """Spliced SE and PE and --tmo are ported (tests/test_torch_splice_*.py,
    tests/test_torch_paired_rna*.py): spliced PE on a graph index, the
    vectorized path and with --tmo the per-pair ladder, gives the JAX
    package's SAM bytes and stats through submit_pe/finish_pe."""
    jp = [head(b, 24) for b in world["pe"]["const"]["j"]]
    tp = [head(b, 24) for b in world["pe"]["const"]["t"]]
    for kw in (dict(spliced=True), dict(spliced=True, tmo=True)):
        jal, tal = aligners(world, "table", **kw)
        jtext, jst = _sam(lambda al, w: jemit.finish_pe(
            al, jemit.submit_pe(al, *jp), w), jsam, jal, world["ref"])
        ttext, tst = _sam(lambda al, w: temit.finish_pe(
            al, temit.submit_pe(al, *tp), w), tsam, tal, world["ref"])
        assert tst == jst
        assert_sam_like_reference(tal, ttext, jtext)
        assert tst["pairs"] == 24
