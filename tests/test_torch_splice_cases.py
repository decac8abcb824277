"""Spliced (RNA) alignment, the port against the JAX package on the cases
of tests/test_multi_intron.py, tests/test_long_intron.py and
tests/test_simulate_rna.py, and on a graph (SNP) index with known splice
sites, where the spliced scorers' SNV-overlay branches decide scores
(_score_segs, _spliced_fin_rows, _finalize_spliced): SAM bytes and stats
equal, exact.

The long-intron case keeps its 70,000 bp intron, beyond the anchor scan's
first 64 kb tile, so the genome is 100 kb; the other genomes are 50 kb or
less. Reads of the simulated-RNA case come from
hisat2_tpu/tools/simulate_reads.simulate_rna, imported here only."""

import io

import numpy as np
import pytest
import torch

from test_torch_graph_index import graph_world
from test_torch_graph_pipeline import haplotype
import test_torch_native_cache  # noqa: F401  (JAX native libs, built once under a lock)
from hisat2_tpu.align import emit as jemit
from hisat2_tpu.align.pipeline import Aligner as JAligner
from hisat2_tpu.align.pipeline import AlignerOpts as JOpts
from hisat2_tpu.align.pipeline import results_to_sam as j_results_to_sam
from hisat2_tpu.index.fm_index import build_fm_index
from hisat2_tpu.io import sam as jsam
from hisat2_tpu.io.reads import Read as JRead, batchify as jbatchify
from hisat2_tpu.io.reference import reference_from_seqs
from hisat2_tpu.tools.simulate_reads import simulate_rna
from hisat2_tpu.utils import alphabet as jalphabet

from hisat2_tpu_torch.align import emit as temit
from hisat2_tpu_torch.align.pipeline import Aligner as TAligner
from hisat2_tpu_torch.align.pipeline import AlignerOpts as TOpts
from hisat2_tpu_torch.align.pipeline import results_to_sam as t_results_to_sam
from hisat2_tpu_torch.index.fm_index import FMIndex
from hisat2_tpu_torch.io import sam as tsam
from hisat2_tpu_torch.io.reads import Read as TRead, batchify as tbatchify

torch.set_num_threads(1)


def batches(reads, quals=None):
    q40 = np.full(100, 40, np.int8)
    qs = quals or [q40] * len(reads)
    return (jbatchify([JRead(n, s, q, i) for i, ((n, s), q)
                       in enumerate(zip(reads, qs))], pad_to=104),
            tbatchify([TRead(n, s, q, i) for i, ((n, s), q)
                       in enumerate(zip(reads, qs))], pad_to=104))


def sam_pair(jal, tal, ref, jb, tb, how="stream"):
    """SAM text and stats of both packages: the packed stream, or
    align_batch + results_to_sam."""
    out = []
    for al, mod, b, emit, r2s in ((jal, jsam, jb, jemit, j_results_to_sam),
                                  (tal, tsam, tb, temit, t_results_to_sam)):
        buf = io.StringIO()
        w = mod.SamWriter(buf, list(ref.names), [int(x) for x in ref.tlens],
                          no_head=True)
        if how == "stream":
            st = emit.align_and_emit_stream(al, [b], w)
        else:
            st = r2s(b, al.align_batch(b), al, w)
        out.append((buf.getvalue(), st))
    return out


def pair(jfm, **opts):
    return (JAligner(jfm, opts=JOpts(spliced=True, **opts)),
            TAligner(FMIndex.from_object(jfm), opts=TOpts(spliced=True,
                                                          **opts),
                     device="cpu"))


@pytest.mark.parametrize("how", ["align_batch", "stream"])
def test_multi_intron(how):
    """tests/test_multi_intron.py: reads over two introns around a 45 bp
    middle exon chain both junctions (the second pass)."""
    rng = np.random.default_rng(5)
    g = rng.integers(0, 4, 40000).astype(np.uint8)
    e1, exon, intron = 10000, 45, 300
    i1 = e1 + exon
    e2 = i1 + intron
    i2 = e2 + exon
    e3 = i2 + intron
    g[i1:i1 + 2] = [2, 3]
    g[e2 - 2:e2] = [0, 2]
    g[i2:i2 + 2] = [2, 3]
    g[e3 - 2:e3] = [0, 2]
    jfm = build_fm_index(reference_from_seqs({"chrG": jalphabet.decode(g)}),
                         ftab_k=6)
    tx = np.concatenate([g[e1:i1], g[e2:i2], g[e3:e3 + exon]])
    reads = [(f"t{k}", tx[off:off + 100].copy())
             for k, off in enumerate(range(2, 34, 2))]
    reads += [(f"r{k}", jalphabet.revcomp(r)) for k, (_, r)
              in enumerate(reads[:8])]
    jb, tb = batches(reads)
    jal, tal = pair(jfm)
    (jt, js), (tt, ts) = sam_pair(jal, tal, jfm.ref, jb, tb, how)
    assert ts == js and tt == jt
    chains = [ln for ln in jt.splitlines()
              if ln.split("\t")[5].count("N") == 2]
    assert len(chains) >= 8


def test_long_intron():
    """tests/test_long_intron.py's shape with a 70,000 bp intron: far
    anchors of 12-20 bp that only the anchor scan's second tile reaches,
    among contiguous reads, through the packed stream."""
    ilen = 70_000
    rng = np.random.default_rng(17)
    n = ilen + 30_000
    g = rng.integers(0, 4, n).astype(np.uint8)
    ie = 15_000
    g[ie:ie + 2] = [2, 3]
    g[ie + ilen - 2:ie + ilen] = [0, 2]
    jfm = build_fm_index(reference_from_seqs({"chrL": jalphabet.decode(g)}))
    reads = []
    for i, far in enumerate((12, 14, 16, 18, 20)):
        reads.append((f"lj{i}_{far}",
                      np.concatenate([g[ie - (100 - far):ie],
                                      g[ie + ilen:ie + ilen + far]])))
        reads.append((f"lk{i}_{far}",
                      np.concatenate([g[ie - far:ie],
                                      g[ie + ilen:ie + ilen + 100 - far]])))
    for i in range(22):
        st = int(rng.integers(0, n - 100))
        reads.append((f"f{i}", g[st:st + 100].copy()))
    jb, tb = batches(reads)
    jal, tal = pair(jfm)
    (jt, js), (tt, ts) = sam_pair(jal, tal, jfm.ref, jb, tb)
    assert ts == js and tt == jt
    assert f"{ilen}N" in jt


def test_simulated_rna():
    """tests/test_simulate_rna.py: two 3-exon transcripts, reads from
    simulate_rna at 0.5% errors with per-base qualities, both packed
    stream and align_batch, known sites of one transcript."""
    rng = np.random.default_rng(17)
    g = rng.integers(0, 4, 50000).astype(np.uint8)
    trans = {}
    exonsets = [[(5001, 5160), (5501, 5650), (6001, 6200)],
                [(20001, 20100), (20601, 20700), (21501, 21700)]]
    for gi, exons in enumerate(exonsets):
        for k in range(1, len(exons)):
            d = exons[k - 1][1]
            a = exons[k][0]
            g[d:d + 2] = [2, 3]
            g[a - 3:a - 1] = [0, 2]
        trans[f"tx{gi}"] = ("chrR", "+", exons)
    ref = reference_from_seqs({"chrR": jalphabet.decode(g)})
    jfm = build_fm_index(ref)
    rng2 = np.random.default_rng(2)
    reads = [(name, s1) for name, s1, _s2, _tr in simulate_rna(
        ref, trans, rng2, 160, 100, error_rate=0.005)]
    quals = [rng2.integers(10, 41, 100).astype(np.int8) for _ in reads]
    jb, tb = batches(reads, quals)
    for how, known in (("stream", False), ("align_batch", True)):
        jal, tal = pair(jfm)
        if known:
            exons = exonsets[0]
            for k in range(1, len(exons)):
                for al in (jal, tal):
                    al.ssdb.add_known(exons[k - 1][1] - 1, exons[k][0] - 1,
                                      "+")
        (jt, js), (tt, ts) = sam_pair(jal, tal, ref, jb, tb, how)
        assert ts == js and tt == jt
        assert sum("N" in ln.split("\t")[5] for ln in jt.splitlines()) > 60


@pytest.fixture(scope="module")
def graph(tmp_path_factory):
    """The graph index of tests/test_torch_graph_index.py (SNVs, indels,
    haplotypes) with known splice sites, and reads over them cut from
    haplotypes with every variant applied: one junction or two around a
    40 bp middle exon."""
    w = graph_world(tmp_path_factory.mktemp("graph_rna"))
    codes, snps = w["codes"], w["snps"]
    rng = np.random.default_rng(808)
    junctions = [(2500, 400), (6000, 900), (11000, 1500), (17000, 250),
                 (23000, 700)]
    chains = [((4000, 300), (4340, 500))]      # middle exon [4300, 4340)
    reads = []
    for k in range(60):
        s, il = junctions[k % len(junctions)]
        left = int(rng.integers(8, 92))
        seq = np.concatenate([
            haplotype(codes, snps, s - left, left, rng, 1.0),
            haplotype(codes, snps, s + il, 100 - left, rng, 1.0)])
        if k % 3 == 0:
            seq[rng.integers(0, 100)] ^= 1
        reads.append((f"g{k}", jalphabet.revcomp(seq) if k % 2 else seq))
    (s1, il1), (s2, il2) = chains[0]
    for k in range(12):
        a = int(rng.integers(20, 45))
        seq = np.concatenate([
            haplotype(codes, snps, s1 - a, a, rng, 1.0),
            haplotype(codes, snps, s1 + il1, s2 - (s1 + il1), rng, 1.0),
            haplotype(codes, snps, s2 + il2, 100 - a - 40, rng, 1.0)])
        reads.append((f"m{k}", jalphabet.revcomp(seq) if k % 2 else seq))
    sites = [(s - 1, s + il) for s, il in junctions + list(chains[0])]
    return w, reads, sites


@pytest.mark.parametrize("how", ["stream", "align_batch"])
def test_graph_index_with_known_sites(graph, how):
    w, reads, sites = graph
    jb, tb = batches(reads)
    jal, tal = pair(w["jfm"])
    assert tal.overlay is not None
    for al in (jal, tal):
        for left, right in sites:
            al.ssdb.add_known(left, right, "+")
    (jt, js), (tt, ts) = sam_pair(jal, tal, w["ref"], jb, tb, how)
    assert ts == js and tt == jt
    spliced = [ln.split("\t") for ln in jt.splitlines()
               if "N" in ln.split("\t")[5]]
    assert len(spliced) >= 40
    assert any(f[5].count("N") == 2 for f in spliced)
