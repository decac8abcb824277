"""Graph mode (a --snp index): a read base that is a known SNV's
alternative allele costs nothing and is no mismatch in NM or XM, on every
path that writes a record. The ungapped and spliced finalizers scored it so;
the host DP traceback of a gapped candidate (Aligner._traceback) and the
mate rescue's DP (paired._rescue_mates) scored the linear reference, and
wrote AS, NM and XM that the walk of their CIGAR over the genome
(benchmark/reference/samcheck.py, known SNVs free) does not give. Each
record here is held to that walk."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from hisat2_tpu_torch.align import paired as tpaired
from hisat2_tpu_torch.align.pipeline import NEG_INF, Aligner, AlignerOpts
from hisat2_tpu_torch.index.graph_index import build_graph_index
from hisat2_tpu_torch.io.annotations import read_snps
from hisat2_tpu_torch.io.reads import ReadBatch
from hisat2_tpu_torch.io.reference import reference_from_seqs
from hisat2_tpu_torch.utils import alphabet

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "bench_samcheck_snv", os.path.join(ROOT, "benchmark", "reference",
                                       "samcheck.py"))
samcheck = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(samcheck)

L = 100
K2 = 4
G = 40_000
SNV_EVERY = 37


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A random genome with a known SNV every 37 bases (alternative
    allele: the base plus one), its graph index, a DNA aligner on the
    CPU, and the samcheck view of the variants."""
    d = tmp_path_factory.mktemp("snv")
    rng = np.random.default_rng(4242)
    g = rng.integers(0, 4, G).astype(np.uint8)
    pos = np.arange(500, G - 500, SNV_EVERY)
    alt = (g[pos] + 1) % 4
    with open(d / "g.snp", "w") as fh:
        for k, (p, a) in enumerate(zip(pos, alt)):
            fh.write(f"s{k}\tsingle\tchrS\t{p}\t{'ACGT'[a]}\n")
    ref = reference_from_seqs({"chrS": alphabet.decode(g)})
    fm = build_graph_index(ref, read_snps(str(d / "g.snp"), ref))
    al = Aligner(fm, opts=AlignerOpts(), device="cpu")
    known = samcheck.Known(dict(
        pos=pos, type=np.zeros(pos.size, np.int64),
        len=np.ones(pos.size, np.int64), alt=alt,
        ins=[b""] * pos.size))
    return dict(g=g, al=al, known=known, snv=dict(zip(pos.tolist(),
                                                      alt.tolist())))


def _haplotype_read(w, p, dels=(), alts=L):
    """L bases from genome position p, the first `alts` known SNVs in them
    taken as their alternative allele, with the genome stretches in `dels`
    (start, length) left out."""
    g = w["g"]
    snv = {x: a for x, a in sorted(w["snv"].items())
           if p <= x < p + L + 8}
    snv = dict(list(snv.items())[:alts])
    out, q = [], p
    for a, n in sorted(dels) + [(None, 0)]:
        stop = a if a is not None else q + L
        out.append(np.array([snv.get(x, g[x]) for x in range(q, stop)],
                            np.uint8))
        q = stop + n
    rd = np.concatenate(out)[:L]
    assert rd.size == L
    return rd


def _batch(seqs, names):
    B = len(seqs)
    quals = np.full((B, L), 37, np.int8)
    quals[:, 5::9] = 25
    return ReadBatch(np.stack(seqs).astype(np.uint8), quals,
                     np.full(B, L, np.int32), names)


def _line_ok(w, line, seq, qual):
    rec = samcheck.parse(line)
    return rec, samcheck.check_record(rec, seq, qual, w["g"], w["known"])


@pytest.mark.parametrize("fw", [True, False], ids=["fw", "rc"])
def test_gapped_traceback_frees_known_snvs(world, fw):
    """A read with a 2 bp deletion (no known variant) and the alternative
    allele at each known SNV: the gapped candidate's record."""
    from hisat2_tpu_torch.align.emit import _format_slow
    from hisat2_tpu_torch.align.pipeline import ReadResult
    al = world["al"]
    p = 10_003
    rd = _haplotype_read(world, p, dels=[(p + 48, 2)])
    seq = rd if fw else alphabet.revcomp(rd)
    b = _batch([seq], ["gapped"])
    a = al._finalize(0, b, 0, p, fw, True, L)
    assert a is not None and ("D", 2) in a.cigar
    assert a.nm == 2                    # the deletion; the SNVs are free
    (line,) = _format_slow(al, b, 0, ReadResult(alns=[a], best=a.score),
                           al.scoring)
    rec, bad = _line_ok(world, line, b.seqs[0], b.quals[0])
    assert bad is None, line


@pytest.mark.parametrize("gap", [False, True], ids=["ungapped", "gapped"])
def test_mate_rescue_frees_known_snvs(world, gap):
    """Mate 1 placed, mate 2 with no candidate: the ladder rescues mate 2
    by DP in the window past mate 1; its record, with the alternative
    allele at each known SNV (where `gap`, at the first only, and a 1 bp
    deletion), agrees
    with the walk. (The rescue's gate still scores the linear reference:
    a mate whose known SNVs alone take it under --score-min is not
    rescued.)"""
    al = world["al"]
    p1 = 20_011
    p2 = p1 + 260
    r1 = _haplotype_read(world, p1)
    r2 = _haplotype_read(world, p2, dels=[(p2 + 51, 1)] if gap else (),
                         alts=1 if gap else L)
    b1 = _batch([r1], ["pair"])
    b2 = _batch([alphabet.revcomp(r2)], ["pair"])

    def grid(score, pos, fw):
        m = dict(score=np.full((1, K2), NEG_INF, np.int64),
                 pos=np.zeros((1, K2), np.int64),
                 fw=np.zeros((1, K2), bool), gapped=np.zeros((1, K2), bool))
        if pos is not None:
            m["score"][0, 0], m["pos"][0, 0], m["fw"][0, 0] = score, pos, fw
        return m
    res = tpaired.align_pairs(al, b1, b2,
                              premerged=(grid(0, p1, True),
                                         grid(0, None, False)))
    pr = res[0]
    assert pr.kind == "concordant"
    assert pr.aln2.joined_pos == p2 or gap
    lines = tpaired.pair_lines(al, b1, b2, 0, pr, tpaired.new_pair_stats())
    assert len(lines) == 2
    for line, b in zip(lines, (b1, b2)):
        rec, bad = _line_ok(world, line, b.seqs[0], b.quals[0])
        assert bad is None, line
    assert pr.aln2.nm == (1 if gap else 0)
