"""Spliced (RNA) alignment over a genome-sharded index, the port against
the JAX package's ShardedAligner: SAM bytes and stats.

The genome and reads are tests/test_sharded_rna.py's (two 50 kb
chromosomes, two GT..AG introns on each, one shard per chromosome), and
so are its four cases: RNA SE, the snp_tran composition (a sharded graph
index, known sites, reads carrying alt alleles), RNA PE and --tmo PE with
known sites (whose mates 2 lie in one exon, so the reference reports no
pair); a fifth runs --tmo SE (the per-read path of the sharded SE
finish), a sixth --tmo PE on pairs whose mates both cross an intron (mate
1 the first intron of a chromosome, mate 2 the second). Each case runs on the port with shards resident and again with a
budget below one shard (HISAT2_TPU_HBM_GB), which evicts and re-uploads
every shard."""

import io

import numpy as np
import pytest
import torch

import test_torch_native_cache  # noqa: F401  (JAX native libs, built once under a lock)
from hisat2_tpu.align.pipeline import AlignerOpts as JOpts
from hisat2_tpu.align.sharded import ShardedAligner as JSA
from hisat2_tpu.index import sharded as jsharded
from hisat2_tpu.io import sam as jsam
from hisat2_tpu.io.annotations import read_snps as jread_snps
from hisat2_tpu.io.reads import Read as JRead, batchify as jbatchify
from hisat2_tpu.io.reference import reference_from_seqs as jref_of
from hisat2_tpu.utils import alphabet

from hisat2_tpu_torch.align.pipeline import AlignerOpts as TOpts
from hisat2_tpu_torch.align.sharded import ShardedAligner as TSA
from hisat2_tpu_torch.index import sharded as tsharded
from hisat2_tpu_torch.io import sam as tsam
from hisat2_tpu_torch.io.annotations import read_snps as tread_snps
from hisat2_tpu_torch.io.reads import Read as TRead, batchify as tbatchify
from hisat2_tpu_torch.io.reference import reference_from_seqs as tref_of

torch.set_num_threads(1)

L = 100


def genome():
    rng = np.random.default_rng(31)
    g1 = np.asarray(rng.integers(0, 4, 50000), np.uint8)
    g2 = np.asarray(rng.integers(0, 4, 50000), np.uint8)
    introns = []
    for g, chrom_base in ((g1, 0), (g2, 1)):
        for start, ilen in ((5000, 400), (20000, 1500)):
            g[start:start + 2] = [2, 3]
            g[start + ilen - 2:start + ilen] = [0, 2]
            introns.append((chrom_base, start, ilen))
    return (g1, g2), introns


def se_reads(gs, introns, rng, n=48):
    out = []
    for i in range(n):
        cb, start, ilen = introns[i % len(introns)]
        g = gs[cb]
        j = int(rng.integers(15, L - 15))
        seq = np.concatenate([g[start - j:start],
                              g[start + ilen:start + ilen + (L - j)]])
        if i % 3 == 2:
            seq = alphabet.revcomp(seq)
        out.append((f"r{i}", seq.copy()))
    for i in range(n, n + 32):
        p = int(rng.integers(0, 40000))
        out.append((f"p{i}", gs[i % 2][p:p + L].copy()))
    return out


def snp_tran_reads(gs, introns, rng):
    out = []
    for i in range(40):
        cb, start, ilen = introns[i % len(introns)]
        g = gs[cb].copy()
        g[start - 20] = (g[start - 20] + 1) % 4   # the read carries the ALT
        j = int(rng.integers(25, 75))
        out.append((f"s{i}", np.concatenate(
            [g[start - j:start],
             g[start + ilen:start + ilen + (L - j)]]).copy()))
    return out


def pe_reads(gs, introns, rng, n, exonic):
    r1, r2 = [], []
    for i in range(n):
        cb, start, ilen = introns[i % len(introns)]
        g = gs[cb]
        j = int(rng.integers(15, L - 15))
        m1 = np.concatenate([g[start - j:start],
                             g[start + ilen:start + ilen + (L - j)]])
        m2s = start + ilen + 150
        r1.append((f"q{i}", m1.copy()))
        r2.append((f"q{i}", alphabet.revcomp(g[m2s:m2s + L])))
    for i in range(n, n + exonic):           # --tmo drops these
        p0 = int(rng.integers(0, 40000))
        g = gs[i % 2]
        r1.append((f"q{i}", g[p0:p0 + L].copy()))
        r2.append((f"q{i}", alphabet.revcomp(g[p0 + 250:p0 + 250 + L])))
    return r1, r2


def both(reads):
    q = np.full(L, 40, np.int8)
    return (jbatchify([JRead(n, s, q, i) for i, (n, s) in enumerate(reads)],
                      pad_to=104),
            tbatchify([TRead(n, s, q, i) for i, (n, s) in enumerate(reads)],
                      pad_to=104))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    gs, introns = genome()
    seqs = {"c1": alphabet.decode(gs[0]), "c2": alphabet.decode(gs[1])}
    jref, tref = jref_of(seqs), tref_of(seqs)
    lines = []
    i = 0
    for cb, start, ilen in introns:
        for off in (-40, -20, 25, 60):
            p = start + (off if off < 0 else ilen + off)
            alt = (int(gs[cb][p]) + 1) % 4
            lines.append(f"rs{i}\tsingle\t{('c1', 'c2')[cb]}\t{p}\t"
                         f"{'ACGT'[alt]}")
            i += 1
    sp = tmp_path_factory.mktemp("tshrna") / "t.snp"
    sp.write_text("\n".join(lines) + "\n")
    known = [(cb * 50000 + s - 1, cb * 50000 + s + n) for cb, s, n in introns]
    out = dict(known=known, jref=jref, tref=tref,
               jsh=jsharded.build_sharded(jref, max_bases=60000),
               tsh=tsharded.build_sharded(tref, max_bases=60000),
               jgsh=jsharded.build_sharded(
                   jref, max_bases=60000, snps=jread_snps(str(sp), jref)),
               tgsh=tsharded.build_sharded(
                   tref, max_bases=60000, snps=tread_snps(str(sp), tref)))
    assert len(out["tsh"]) == len(out["tgsh"]) == 2
    for k in ("jgsh", "tgsh"):
        out[k].known_ss = np.asarray([[a, b, 1] for a, b in known],
                                     np.int64)
    out["se"] = both(se_reads(gs, introns, np.random.default_rng(7)))
    out["snp_tran"] = both(snp_tran_reads(gs, introns,
                                          np.random.default_rng(41)))
    r1, r2 = pe_reads(gs, introns, np.random.default_rng(13), 32, 0)
    out["pe"] = (both(r1), both(r2))
    r1, r2 = pe_reads(gs, introns, np.random.default_rng(19), 24, 8)
    out["tmo_pe"] = (both(r1), both(r2))
    rng = np.random.default_rng(23)
    r1, r2 = [], []
    for i in range(16):
        cb = i % 2
        (_, s1, n1), (_, s2, n2) = introns[2 * cb], introns[2 * cb + 1]
        j1, j2 = (int(x) for x in rng.integers(20, L - 20, 2))
        g = gs[cb]
        m1 = np.concatenate([g[s1 - j1:s1], g[s1 + n1:s1 + n1 + L - j1]])
        m2 = np.concatenate([g[s2 - j2:s2], g[s2 + n2:s2 + n2 + L - j2]])
        r1.append((f"b{i}", m1.copy()))
        r2.append((f"b{i}", alphabet.revcomp(m2)))
    out["tmo_pe2"] = (both(r1), both(r2))
    return out


TMO = dict(spliced=True, tmo=True, no_temp_splicesite=True)
CASES = {
    # case: (reads, index key, opts, known sites, PE, spliced records at
    # least)
    "rna_se": ("se", "sh", dict(spliced=True), False, False, 40),
    "snp_tran": ("snp_tran", "gsh", dict(spliced=True), True, False, 36),
    "rna_pe": ("pe", "sh", dict(spliced=True), False, True, 30),
    "tmo_pe": ("tmo_pe", "sh", TMO, True, True, 0),
    "tmo_se": ("se", "sh", TMO, True, False, 40),
    "tmo_pe2": ("tmo_pe2", "sh", TMO, True, True, 16),
}


def run(setup, case, port: bool):
    reads, idx, opts, known, pe, _ = CASES[case]
    p = "t" if port else "j"
    ref, samio = (setup["tref"], tsam) if port else (setup["jref"], jsam)
    sa = (TSA(setup[p + idx], opts=TOpts(**opts), device="cpu") if port
          else JSA(setup[p + idx], opts=JOpts(**opts)))
    if known:
        for jl, jr in setup["known"]:
            sa.host.ssdb.add_known(int(jl), int(jr), "+")
    buf = io.StringIO()
    w = samio.SamWriter(buf, ref.names, [int(x) for x in ref.tlens],
                        no_head=True)
    k = 1 if port else 0
    data = setup[reads]
    if pe:
        st = sa.align_and_emit_pe([(data[0][k], data[1][k])], w)
    else:
        st = sa.align_and_emit([data[k]], w)
    return buf.getvalue(), st, sa


@pytest.fixture(scope="module")
def oracle(setup):
    """The JAX ShardedAligner's SAM and stats, one run a case."""
    return {c: run(setup, c, False)[:2] for c in CASES}


@pytest.mark.parametrize("evict", [False, True], ids=["resident", "evict"])
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_rna_equals_jax(case, evict, setup, oracle, monkeypatch):
    if evict:
        monkeypatch.setenv("HISAT2_TPU_HBM_GB", "0.00001")
    text, stats, sa = run(setup, case, True)
    assert text == oracle[case][0]
    assert stats == oracle[case][1]
    assert sa.evictions == (len(sa.sh) - 1 if evict else 0)
    recs = [ln.split("\t") for ln in text.splitlines()]
    spliced = [f for f in recs if not int(f[1]) & 260 and "N" in f[5]]
    assert len(spliced) >= CASES[case][5]
    if case.startswith("tmo"):
        # --tmo reports known-junction-spliced records only
        assert all("N" in f[5] for f in recs if not int(f[1]) & 4)
