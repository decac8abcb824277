"""Genome-sharded alignment, the port against the JAX package: the sharded
index builders field by field, .sharded.json written by one package and
read by the other, the host merges on the same inputs, SAM bytes and
stats of ShardedAligner (SE and PE) with shards resident and with
eviction forced through HISAT2_TPU_HBM_GB, the shard size estimate
against the real bundle, the refusals, and the host-mode mate rescue's
scores and ungapped placements.

The genomes are tests/test_sharded.py's (three random 15 kb chromosomes,
three shards) and tests/test_sharded_graph.py's (the same shape with an
SNV every 700 bp); a third copies 600 bp segments of chr1 into chr3, so
reads and pairs from them place in two shards (the cross-shard merge and
its force_slow ladder). Spliced sharded cases are in
tests/test_torch_sharded_rna.py."""

import io

import numpy as np
import pytest
import torch

import test_torch_native_cache  # noqa: F401  (JAX native libs, built once under a lock)
from hisat2_tpu.align import paired as jpaired
from hisat2_tpu.align.scoring import DEFAULT_SCORING as JSCORING
from hisat2_tpu.align.sharded import ShardedAligner as JSA
from hisat2_tpu.index import sharded as jsharded
from hisat2_tpu.io import sam as jsam
from hisat2_tpu.io.annotations import read_snps as jread_snps
from hisat2_tpu.io.reads import Read as JRead, batchify as jbatchify
from hisat2_tpu.io.reference import reference_from_seqs as jref_of
from hisat2_tpu.ops.splice_host import dp_score_host as jdp_score_host
from hisat2_tpu.utils import alphabet

from hisat2_tpu_torch.align import emit as temit
from hisat2_tpu_torch.align import paired as tpaired
from hisat2_tpu_torch.align.pipeline import Aligner as TAligner
from hisat2_tpu_torch.align.pipeline import FASTPACK_REP
from hisat2_tpu_torch.align.scoring import DEFAULT_SCORING
from hisat2_tpu_torch.align.sharded import ShardedAligner as TSA
from hisat2_tpu_torch.index import sharded as tsharded
from hisat2_tpu_torch.index.fm_index import FMIndex, build_fm_index
from hisat2_tpu_torch.index.graph_index import build_graph_index as tgraph
from hisat2_tpu_torch.io import sam as tsam
from hisat2_tpu_torch.io.annotations import read_snps as tread_snps
from hisat2_tpu_torch.io.reads import Read as TRead, batchify as tbatchify
from hisat2_tpu_torch.io.reference import reference_from_seqs as tref_of
from hisat2_tpu_torch.ops.dp_cuda import dp_score
from hisat2_tpu_torch.ops.sw import dp_inputs

torch.set_num_threads(1)

COPY_LEN = 600
COPY_AT = range(1000, 13000, 1500)      # chr1 -> chr3, same offsets


def genome(copies: bool):
    """test_sharded.py's three chromosomes (seed 21), optionally with
    chr1's segments [p, p + COPY_LEN) copied to chr3 at p."""
    rng = np.random.default_rng(21)
    codes = {f"chr{k}": rng.integers(0, 4, 15000).astype(np.uint8)
             for k in range(1, 4)}
    if copies:
        for p in COPY_AT:
            codes["chr3"][p:p + COPY_LEN] = codes["chr1"][p:p + COPY_LEN]
    return {k: alphabet.decode(v) for k, v in codes.items()}, rng


def se_reads(joined, rng, copies: bool):
    """test_sharded.py's 256 reads; with copies also 64 reads from the
    copied segments (two shards place each)."""
    out = []
    for i in range(256):
        st = int(rng.integers(0, joined.size - 80))
        s = joined[st:st + 80].copy()
        mm = rng.random(80) < 0.02
        s[mm] = (s[mm] + rng.integers(1, 4, int(mm.sum()))) % 4
        if rng.random() < 0.5:
            s = alphabet.revcomp(s)
        out.append((f"s{i}_{st}", s))
    if copies:
        crng = np.random.default_rng(5)
        for i in range(64):
            p = COPY_AT[i % len(COPY_AT)] + int(crng.integers(0, 500))
            s = joined[p:p + 80].copy()
            if i % 3 == 0:                     # one mismatch
                s[40] = (s[40] + 1) % 4
            if i % 2:
                s = alphabet.revcomp(s)
            out.append((f"c{i}_{p}", s))
    return out


def pe_reads(joined, copies: bool):
    """test_sharded.py's 128 FR pairs and 8 pairs with a junk mate 2 (seed
    77); with copies also 32 pairs from inside the copied segments."""
    rng = np.random.default_rng(77)
    rdlen, frag = 72, 220
    r1, r2 = [], []
    for i in range(128):
        st = int(rng.integers(0, joined.size - frag))
        fragc = joined[st:st + frag]
        m1 = fragc[:rdlen].copy()
        m2 = alphabet.revcomp(fragc[-rdlen:]).copy()
        for r in (m1, m2):
            mm = rng.random(rdlen) < 0.01
            r[mm] = (r[mm] + rng.integers(1, 4, int(mm.sum()))) % 4
        r1.append((f"p{i}_{st}", m1))
        r2.append((f"p{i}_{st}", m2))
    for i in range(128, 136):
        st = int(rng.integers(0, joined.size - rdlen))
        m1 = joined[st:st + rdlen].copy()
        m2 = rng.integers(0, 4, rdlen).astype(m1.dtype)
        r1.append((f"p{i}_{st}", m1))
        r2.append((f"p{i}_{st}", m2))
    if copies:
        for i in range(32):
            st = COPY_AT[i % len(COPY_AT)] + 20 + 11 * i
            fragc = joined[st:st + frag]
            m1 = fragc[:rdlen].copy()
            m2 = alphabet.revcomp(fragc[-rdlen:]).copy()
            if i % 2:
                m1, m2 = m2, m1
            r1.append((f"c{i}_{st}", m1))
            r2.append((f"c{i}_{st}", m2))
    return r1, r2


def batches(pairs, pad, quals=None):
    """The same reads as a JAX and a port ReadBatch."""
    q = [np.full(s.size, 40, np.int8) if quals is None else quals[i]
         for i, (_, s) in enumerate(pairs)]
    return (jbatchify([JRead(n, s, q[i], i)
                       for i, (n, s) in enumerate(pairs)], pad_to=pad),
            tbatchify([TRead(n, s, q[i], i)
                       for i, (n, s) in enumerate(pairs)], pad_to=pad))


def writer(samio, ref):
    buf = io.StringIO()
    return buf, samio.SamWriter(buf, ref.names, [int(x) for x in ref.tlens],
                                no_head=True)


def run_se(sa, batch, samio, ref):
    buf, w = writer(samio, ref)
    st = sa.align_and_emit([batch], w)
    return buf.getvalue(), st


def run_pe(sa, b1, b2, samio, ref):
    buf, w = writer(samio, ref)
    st = sa.align_and_emit_pe([(b1, b2)], w)
    return buf.getvalue(), st


def graph_case(tmp_path_factory):
    """tests/test_sharded_graph.py's genome, SNP file and reads."""
    rng = np.random.default_rng(97)
    codes = {f"chr{k}": rng.integers(0, 4, 15000).astype(np.uint8)
             for k in range(1, 4)}
    seqs = {k: alphabet.decode(v) for k, v in codes.items()}
    lines = []
    i = 0
    for k in range(1, 4):
        for p in range(300, 14500, 700):
            alt = (int(codes[f"chr{k}"][p]) + 1) % 4
            lines.append(f"rs{i}\tsingle\tchr{k}\t{p}\t{'ACGT'[alt]}")
            i += 1
    d = tmp_path_factory.mktemp("tshgraph")
    sp = d / "t.snp"
    sp.write_text("\n".join(lines) + "\n")
    jref, tref = jref_of(seqs), tref_of(seqs)
    jsnps, tsnps = jread_snps(str(sp), jref), tread_snps(str(sp), tref)
    joined = jref.joined
    jset = jsnps.jpos
    reads = []
    for i in range(192):
        st = int(rng.integers(0, joined.size - 80))
        s = joined[st:st + 80].copy()
        inside = jset[(jset >= st) & (jset < st + 80)]
        for jp in inside[:2]:
            s[int(jp) - st] = int(
                jsnps.alt_codes[int(np.searchsorted(jset, jp))])
        if rng.random() < 0.5:
            s = alphabet.revcomp(s)
        reads.append((f"g{i}_{st}", s))
    return seqs, jref, tref, jsnps, tsnps, reads


@pytest.fixture(scope="module")
def dna():
    """Both genomes, both packages' sharded indexes, and the JAX
    ShardedAligner's SAM and stats (the oracle, run once a case)."""
    out = {}
    for copies in (False, True):
        seqs, rng = genome(copies)
        jref, tref = jref_of(seqs), tref_of(seqs)
        jsh = jsharded.build_sharded(jref, max_bases=16000)
        tsh = tsharded.build_sharded(tref, max_bases=16000)
        assert len(tsh) == 3
        jb, tb = batches(se_reads(jref.joined, rng, copies), 80)
        r1, r2 = pe_reads(jref.joined, copies)
        (jb1, tb1), (jb2, tb2) = batches(r1, 72), batches(r2, 72)
        out[copies] = dict(
            jref=jref, tref=tref, jsh=jsh, tsh=tsh, tb=tb, tb1=tb1,
            tb2=tb2, se=run_se(JSA(jsh), jb, jsam, jref),
            pe=run_pe(JSA(jsh), jb1, jb2, jsam, jref))
    return out


@pytest.fixture(scope="module")
def graph(tmp_path_factory):
    seqs, jref, tref, jsnps, tsnps, reads = graph_case(tmp_path_factory)
    jsh = jsharded.build_sharded(jref, max_bases=16000, snps=jsnps)
    tsh = tsharded.build_sharded(tref, max_bases=16000, snps=tsnps)
    jb, tb = batches(reads, 80)
    return dict(tref=tref, tsnps=tsnps, tsh=tsh, tb=tb, jsnps=jsnps,
                jsh=jsh, se=run_se(JSA(jsh), jb, jsam, jref))


# ---- builders, persistence ------------------------------------------------

_FM_KEYS = ("n", "zoff", "ftab_k", "bwt_packed", "text_packed", "occ",
            "ccount", "sa", "ftab", "st_starts", "st_pos", "st_k",
            "st_stride", "table_only")
_GRAPH_KEYS = ("primary_n", "patch_start", "patch_ref", "patch_vpos",
               "patch_shift", "patch_len", "snv_overlay")
_REF_KEYS = ("joined", "frag_joined", "frag_toff", "frag_tidx", "frag_len",
             "tlens")


def same(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.asarray(a).dtype == np.asarray(b).dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


def assert_sharded_equal(j, t):
    assert list(j.bases) == list(t.bases)
    assert len(j.shards) == len(t.shards)
    for k in _REF_KEYS:
        same(getattr(j.ref, k), getattr(t.ref, k), f"ref.{k}")
    assert list(j.ref.names) == list(t.ref.names)
    graph = j.snps is not None
    assert graph == (t.snps is not None)
    if graph:
        same(j.snv_overlay, t.snv_overlay, "snv_overlay")
        for k in ("types", "jpos", "lens", "alt_codes", "tpos"):
            same(getattr(j.snps, k), getattr(t.snps, k), f"snps.{k}")
    for i, (js, ts) in enumerate(zip(j.shards, t.shards)):
        keys = _FM_KEYS + (_GRAPH_KEYS if graph else ())
        for k in keys:
            same(getattr(js, k, False), getattr(ts, k, False),
                 f"shard {i} {k}")
        for k in _REF_KEYS:
            same(getattr(js.ref, k), getattr(ts.ref, k), f"shard {i} ref.{k}")


@pytest.mark.parametrize("mode", ["table", "fm", "graph", "stride2"])
def test_build_sharded_fields(mode, dna, graph):
    if mode == "graph":
        j, t = graph["jsh"], graph["tsh"]
        assert all(s.patch_start.size == t.shards[0].patch_start.size
                   for s in t.shards)                  # harmonized
    elif mode == "table":
        j, t = dna[False]["jsh"], dna[False]["tsh"]
        assert all(s.table_only for s in t.shards)
    else:
        kw = (dict(table_only=False) if mode == "fm"
              else dict(table_stride=2))
        j = jsharded.build_sharded(dna[False]["jref"], max_bases=16000, **kw)
        t = tsharded.build_sharded(dna[False]["tref"], max_bases=16000, **kw)
    assert_sharded_equal(j, t)


def test_slice_snps_and_harmonize(graph):
    """_slice_snps with haplotypes (one group crossing a shard boundary is
    dropped), and _harmonize on unequal shards, in both packages."""
    js, ts = graph["jsnps"], graph["tsnps"]
    n = len(js)
    haps = [[0, 1], [5, 6, 7], [20, 21], [n - 2, n - 1]]
    for base, jend in ((0, 15000), (15000, 30000), (14000, 31000)):
        jl, jh = jsharded._slice_snps(js, haps, base, jend)
        tl, th = tsharded._slice_snps(ts, haps, base, jend)
        assert jh == th
        assert jl.names == tl.names and jl.chroms == tl.chroms
        for k in ("types", "jpos", "lens", "alt_codes", "tpos"):
            same(getattr(jl, k), getattr(tl, k), k)
    # unequal table-only shards of one reference, padded alike
    jr, tr = jref_of({"a": "ACGT" * 900, "b": "GATTACA" * 300}), \
        tref_of({"a": "ACGT" * 900, "b": "GATTACA" * 300})
    jsh = [jsharded.build_table_index(jr, kt=8),
           jsharded.build_table_index(jref_of({"c": "TTGCA" * 100}), kt=8)]
    tsh = [tsharded.build_table_index(tr, kt=8),
           tsharded.build_table_index(tref_of({"c": "TTGCA" * 100}), kt=8)]
    jsharded._harmonize(jsh)
    tsharded._harmonize(tsh)
    for js_, ts_ in zip(jsh, tsh):
        for k in ("st_pos", "text_packed"):
            same(getattr(js_, k), getattr(ts_, k), k)
        for k in _REF_KEYS[1:5]:
            same(getattr(js_.ref, k), getattr(ts_.ref, k), k)


@pytest.mark.parametrize("what", ["table", "graph"])
def test_sharded_json_both_ways(what, dna, graph, tmp_path):
    if what == "graph":
        j, t = graph["jsh"], graph["tsh"]
    else:
        j, t = dna[True]["jsh"], dna[True]["tsh"]
    ks = np.asarray([[100, 400, 1]], np.int64)
    t.known_ss = j.known_ss = ks
    try:
        j.save(str(tmp_path / "j"))
        t.save(str(tmp_path / "t"))
        from_j = tsharded.ShardedIndex.load(str(tmp_path / "j"))
        from_t = jsharded.ShardedIndex.load(str(tmp_path / "t"))
    finally:
        t.known_ss = j.known_ss = None
    same(from_t.known_ss, ks, "known_ss")
    same(from_j.known_ss, ks, "known_ss")
    for a, b in ((from_t, from_j), (from_t, t)):
        assert list(a.bases) == list(b.bases)
        same(a.ref.joined, b.ref.joined, "joined")
        for sa, sb in zip(a.shards, b.shards):
            for k in ("text_packed", "st_starts", "st_pos", "st_k"):
                same(getattr(sa, k), getattr(sb, k), k)
        if what == "graph":
            same(a.snv_overlay, b.snv_overlay, "overlay")
            same(a.snps.jpos, b.snps.jpos, "snps")


# ---- the host merges --------------------------------------------------------

def merge_inputs(seed, S, B=40, KF=3, K2=8, KP=8, NL=24):
    rng = np.random.default_rng(seed)
    fps, mgs, pes, exs = [], [], [], []
    W = 4 + 1 + tpaired.PEPACK_REP * 3
    for s in range(S):
        fp = rng.integers(-2000, 2000, (B, 4 + FASTPACK_REP * KF)).astype(
            np.int16)
        fp[:, 0] = rng.integers(0, 3, B)
        fp[:, 1] = rng.integers(-60, 1, B)
        fp[:, 2] = np.where(rng.random(B) < 0.3, -32768,
                            rng.integers(-80, 0, B))
        fps.append(fp)
        mg = np.stack([rng.integers(-90, 1, (B, K2)),
                       rng.integers(0, 15000, (B, K2)),
                       rng.integers(0, 4, (B, K2))], axis=2).astype(np.int32)
        mgs.append(mg)
        pk = rng.integers(-3000, 3000, (B, W)).astype(np.int16)
        pk[:, 0] = rng.integers(0, 3, B)
        pk[:, 1] = rng.integers(-120, 1, B)
        pk[:, -1] = rng.integers(0, 4, B)
        pt = np.stack([rng.integers(-200, 1, (B, KP)),
                       rng.integers(0, K2, (B, KP)),
                       rng.integers(0, K2, (B, KP))], axis=2).astype(np.int32)
        pes.append((pk, mg, mg[:, ::-1].copy(), pt))
        s16 = rng.integers(-50, 50, (NL, 8)).astype(np.int16)
        s16[:, 4] = rng.integers(0, 2, NL)
        s16b = rng.integers(0, NL, (NL // 2, 8)).astype(np.int16)
        s16b[:, 4] = rng.integers(0, 2, NL // 2)
        exs.append(dict(
            splanes16=s16,
            splanes32=rng.integers(0, 14000, (NL, 3)).astype(np.int32),
            splanes16b=s16b,
            splanes32b=rng.integers(0, 14000, (NL // 2, 3)).astype(np.int32),
            spl_cov=rng.integers(0, 4, B).astype(np.int8),
            spl_nsel=np.int64(rng.integers(0, NL + 1)),
            spl_nsel2=np.int64(NL // 2)))
    return fps, mgs, pes, exs


def test_merge_functions_equal_jax(dna):
    d = dna[True]
    jsa, tsa = JSA(d["jsh"]), TSA(d["tsh"], device="cpu")
    S = len(d["tsh"])
    for seed in range(4):
        fps, mgs, pes, exs = merge_inputs(seed, S)
        jr = jsa._merge_shard_results(fps, mgs)
        tr = tsa._merge_shard_results(fps, mgs)
        same(jr[0], tr[0], "fastpack")
        same(jr[1], tr[1], "force_slow")
        for k in ("score", "pos", "fw", "gapped"):
            same(jr[2][k], tr[2][k], k)
        for k, v in jsa._merge_grids(mgs).items():
            same(v, tsa._merge_grids(mgs)[k], k)
        for a, b in zip(jsa._merge_pe_shards(pes), tsa._merge_pe_shards(pes)):
            same(a, b, "pe merge")
        if seed == 3:                  # one shard without lanes: no pack
            exs[1] = {}
        jl = jsa._merge_splice_lanes(exs, 7)
        tl = tsa._merge_splice_lanes(exs, 7)
        assert (jl is None) == (tl is None)
        if jl is not None:
            assert sorted(jl) == sorted(tl)
            for k in jl:
                same(jl[k], tl[k], k)


# ---- SAM bytes ------------------------------------------------------------

def single_se(tref, tb, fm):
    buf, w = writer(tsam, tref)
    st = temit.align_and_emit(TAligner(fm, device="cpu"), tb, w)
    return buf.getvalue(), st


@pytest.mark.parametrize("case", ["plain", "copies", "graph"])
def test_se_sam_equals_jax(case, dna, graph):
    d = graph if case == "graph" else dna[case == "copies"]
    got = run_se(TSA(d["tsh"], device="cpu"), d["tb"], tsam, d["tref"])
    assert got[0] == d["se"][0]
    assert got[1] == d["se"][1]
    if case == "copies":
        # the cross-shard reads took the ladder and came out multi
        assert got[1]["multi"] >= 32
        return
    fm = (tgraph(d["tref"], d["tsnps"], ftab_k=6) if case == "graph"
          else build_fm_index(d["tref"]))
    assert single_se(d["tref"], d["tb"], fm) == got


@pytest.mark.parametrize("case", ["plain", "copies"])
def test_pe_sam_equals_jax(case, dna, monkeypatch):
    """Also: the ladder's mate rescue ran in host mode (the junk mates)."""
    d = dna[case == "copies"]
    calls = []
    real = tpaired._rescue_ungapped
    monkeypatch.setattr(tpaired, "_rescue_ungapped",
                        lambda *a: calls.append(len(a[4])) or real(*a))
    got = run_pe(TSA(d["tsh"], device="cpu"), d["tb1"], d["tb2"], tsam,
                 d["tref"])
    assert got[0] == d["pe"][0]
    assert got[1] == d["pe"][1]
    assert calls and sum(calls) >= 8
    if case == "plain":
        buf, w = writer(tsam, d["tref"])
        st = temit.align_and_emit_pe(
            TAligner(build_fm_index(d["tref"]), device="cpu"), d["tb1"],
            d["tb2"], w)
        assert (buf.getvalue(), st) == got


@pytest.mark.parametrize("what", ["se", "pe"])
def test_forced_eviction_keeps_bytes(what, dna, monkeypatch):
    """A budget below one shard: every pass uploads each shard again and
    evicts the one before; the SAM bytes do not move."""
    d = dna[True]
    monkeypatch.setenv("HISAT2_TPU_HBM_GB", "0.00001")
    sa = TSA(d["tsh"], device="cpu")
    assert sa.budget < sa._shard_dev_bytes(0)
    for rep in range(2):
        if what == "se":
            got = run_se(sa, d["tb"], tsam, d["tref"])
        else:
            got = run_pe(sa, d["tb1"], d["tb2"], tsam, d["tref"])
        assert got == d[what]
    S = len(d["tsh"])
    assert sa.uploads == 2 * S and sa.evictions == 2 * S - 1
    assert list(sa._resident) == [S - 1]
    monkeypatch.delenv("HISAT2_TPU_HBM_GB")
    resident = TSA(d["tsh"], device="cpu")
    run_se(resident, d["tb"], tsam, d["tref"])
    run_se(resident, d["tb"], tsam, d["tref"])
    assert resident.uploads == S and resident.evictions == 0


def test_shard_estimate_equals_bundle(dna, graph):
    """The shape-only estimate equals the bytes of the real bundle: table
    shards, FM shards, graph shards, stride-2 shards and a sampled-SA
    index."""
    tref = dna[False]["tref"]
    cases = [dna[False]["tsh"], graph["tsh"],
             tsharded.build_sharded(tref, max_bases=16000, table_only=False),
             tsharded.build_sharded(tref, max_bases=16000, table_stride=2)]
    for sh in cases:
        sa = TSA(sh, device="cpu")
        for i, fm in enumerate(sh.shards):
            assert sa._shard_dev_bytes(i) == FMIndex.bundle_bytes(
                fm.device_bundle("cpu"))
    for fm in (build_fm_index(tref, offrate=4, seed_table=False),
               build_fm_index(tref, seed_table=False)):
        assert fm.bundle_nbytes() == FMIndex.bundle_bytes(
            fm.device_bundle("cpu"))


def test_refusals(dna):
    d = dna[False]
    sh = d["tsh"]
    bases = list(sh.bases)
    sh.bases = bases[:-1] + [(1 << 32) - 100]
    try:
        with pytest.raises(ValueError, match="exceeds 2"):
            TSA(sh, device="cpu")
    finally:
        sh.bases = bases
    rng = np.random.default_rng(3)
    r1, r2 = pe_reads(d["jref"].joined, False)
    quals = [rng.integers(2, 41, s.size).astype(np.int8) for _, s in r1]
    _, b1 = batches(r1[:8], 72, quals)
    _, b2 = batches(r2[:8], 72, quals)
    with pytest.raises(ValueError, match="constant per-read qualities"):
        TSA(sh, device="cpu").align_and_emit_pe([(b1, b2)], io.StringIO())


# ---- the host-mode mate rescue ---------------------------------------------

def rescue_lanes(seed, P=96, L=104, W=1104):
    """Mates cut from their windows with mismatches, gaps and Ns, windows
    reaching past the genome (N padding), a few unrelated mates."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, 20000).astype(np.uint8)
    ref = tref_of({"g": alphabet.decode(g)})
    rd = np.full((P, L), 4, np.int64)
    q = np.full((P, L), 40, np.int64)
    rls = np.zeros(P, np.int32)
    lanes, wins = [], []
    for k in range(P):
        ws = int(rng.integers(-300, 20000 - W + 300))
        win = ref.get_stretch(ws, W)
        rl = int(rng.integers(60, L + 1))
        off = int(rng.integers(0, W - rl - 4))
        r = win[off:off + rl + 3].astype(np.int64)
        if k % 4 == 1:
            r = np.delete(r, rl // 2)                  # a deletion
        r = r[:rl]
        r = np.where(r >= 4, int(rng.integers(0, 4)), r)
        mm = rng.random(rl) < 0.03
        r[mm] = (r[mm] + 1) % 4
        if k % 9 == 0:
            r = rng.integers(0, 4, rl)
        if k % 11 == 0:
            r[::13] = 4
        rd[k, :rl] = r
        q[k, :rl] = rng.integers(2, 41, rl)
        rls[k] = rl
        lanes.append((k, 1, None, ws, True, rl))
        wins.append(win)
    return ref, rd, q, rls, lanes, np.stack(wins)


@pytest.mark.parametrize("seed", [0, 1])
def test_host_rescue_scores_equal_dp_score_host(seed):
    """The windows the sharded finish gathers on the host, scored by
    ops/dp_cuda.dp_score on a CPU tensor (dp_fill_plain), give
    dp_score_host's scores, so the SAM bytes cannot move."""
    ref, rd, q, rls, lanes, win = rescue_lanes(seed)
    sc = DEFAULT_SCORING
    up = (lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
        torch.int32))
    rd_t, q_t, rl_t = up(rd), up(q), up(rls)
    pen, scp_cum = dp_inputs(sc.device_tables("cpu"), q_t, rl_t)
    got = dp_score(rd_t, pen.contiguous(), rl_t, up(win),
                   scp_cum.contiguous(), **sc.dp_consts()).numpy()
    want = jdp_score_host(JSCORING, rd, q, rls.astype(np.int64),
                          win.astype(np.int64))
    np.testing.assert_array_equal(got.astype(np.int64), want)


def test_rescue_ungapped_equals_jax():
    ref, rd, q, rls, lanes, win = rescue_lanes(2)
    sc = DEFAULT_SCORING
    scores = jdp_score_host(sc, rd, q, rls.astype(np.int64),
                            win.astype(np.int64))
    passing = [k for k in range(len(lanes))
               if scores[k] >= sc.min_score(int(rls[k]))]
    windows = {k: win[k] for k in passing}
    got = tpaired._rescue_ungapped(sc, rd, q, rls, lanes, windows, scores,
                                   passing)
    want = jpaired._rescue_ungapped(JSCORING, rd, q, rls, lanes, windows,
                                    scores, passing)
    assert len(got) >= len(passing) // 2
    assert got == want
