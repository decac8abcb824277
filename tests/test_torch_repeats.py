"""The repeat index, the port against the JAX package on
tests/test_repeats.py's inputs: lcp_array (native Kasai and the Python
loop), build_repeats (names, consensus sequences, positions; with and
without consensus extension, one strand and two), RepeatDB.expand,
.rep.fa/.rep.info written by one package and read by the other, the
minimizer table and classifier, and RepeatAligner.align_repeats."""

import numpy as np
import pytest
import torch

import test_torch_native_cache  # noqa: F401  (JAX native libs, built once under a lock)
from hisat2_tpu.align.pipeline import RepeatAligner as JRepeatAligner
from hisat2_tpu.index import repeats as jrep
from hisat2_tpu.index.fm_index import build_fm_index as jbuild_fm
from hisat2_tpu.index.suffix_array import build_suffix_array
from hisat2_tpu.io.reads import Read as JRead, batchify as jbatchify
from hisat2_tpu.io.reference import reference_from_seqs as jref_of
from hisat2_tpu.utils import alphabet

from hisat2_tpu_torch.align.pipeline import RepeatAligner as TRepeatAligner
from hisat2_tpu_torch.index import repeats as trep
from hisat2_tpu_torch.index.fm_index import build_fm_index as tbuild_fm
from hisat2_tpu_torch.io.reads import Read as TRead, batchify as tbatchify
from hisat2_tpu_torch.io.reference import reference_from_seqs as tref_of

torch.set_num_threads(1)


def rep_genome():
    """test_repeats.py::rep_setup: 20 kb, a 150 bp unit planted 6 times
    forward and twice reverse-complemented."""
    rng = np.random.default_rng(123)
    codes = rng.integers(0, 4, size=20000).astype(np.uint8)
    unit = rng.integers(0, 4, size=150).astype(np.uint8)
    spots = [1000, 3000, 5000, 8000, 11000, 14000]
    for p in spots:
        codes[p:p + 150] = unit
    for p in (16500, 18200):
        codes[p:p + 150] = alphabet.revcomp(unit)
    return codes, spots


def snp_genome():
    """test_repeats.py::test_consensus_snp_copies: 8 copies of a 300 bp
    unit, one SNV each outside the shared exact core."""
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 4, size=40000).astype(np.uint8)
    unit = rng.integers(0, 4, size=300).astype(np.uint8)
    for i, p in enumerate(range(2000, 2000 + 8 * 2000, 2000)):
        cp = unit.copy()
        mpos = 20 + 25 * i if i < 4 else 210 + 20 * (i - 4)
        cp[mpos] = (cp[mpos] + 1) % 4
        codes[p:p + 300] = cp
    return codes


@pytest.fixture(scope="module")
def rep():
    codes, spots = rep_genome()
    seq = {"chrX": alphabet.decode(codes)}
    jref, tref = jref_of(seq), tref_of(seq)
    jdb = jrep.build_repeats(jref, repeat_length=100, repeat_count=5)
    tdb = trep.build_repeats(tref, repeat_length=100, repeat_count=5)
    return dict(codes=codes, spots=spots, jref=jref, tref=tref, jdb=jdb,
                tdb=tdb)


def assert_db_equal(j, t):
    assert [r.name for r in j.repeats] == [r.name for r in t.repeats]
    for a, b in zip(j.repeats, t.repeats):
        assert a.seq.dtype == b.seq.dtype
        np.testing.assert_array_equal(a.seq, b.seq)
        assert a.positions == b.positions


@pytest.mark.parametrize("text", ["ACGCAGTACGCA", "GATTACAGATTACAGAT",
                                  "random"])
def test_lcp_array_both_ways(text):
    """Native Kasai (SA over text + sentinel) and the Python loop (an SA
    without the sentinel row), each equal to the JAX package's."""
    if text == "random":
        codes = np.random.default_rng(4).integers(0, 4, 3000).astype(
            np.uint8)
        codes[1000:1200] = codes[2000:2200]
    else:
        codes = alphabet.encode(text)
    sa = build_suffix_array(codes)
    for s in (sa, sa[1:]):
        got = trep.lcp_array(codes.astype(np.int64), s)
        want = jrep.lcp_array(codes.astype(np.int64), s)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [{}, {"forward_only": True},
                                {"consensus": False}])
def test_build_repeats_equal(kw, rep):
    if not kw:
        assert_db_equal(rep["jdb"], rep["tdb"])
        assert 1 <= len(rep["tdb"].repeats) <= 6
        return
    assert_db_equal(
        jrep.build_repeats(rep["jref"], repeat_length=100, repeat_count=5,
                           **kw),
        trep.build_repeats(rep["tref"], repeat_length=100, repeat_count=5,
                           **kw))


def test_consensus_snp_copies_equal():
    seq = {"chrC": alphabet.decode(snp_genome())}
    j = jrep.build_repeats(jref_of(seq), repeat_length=100, repeat_count=5)
    t = trep.build_repeats(tref_of(seq), repeat_length=100, repeat_count=5)
    assert_db_equal(j, t)
    assert max(len(r.seq) for r in t.repeats) >= 280


def test_expand_equal(rep):
    for r in rep["tdb"].repeats:
        for pos, length in ((0, 50), (10, 50), (len(r) - 60, 60)):
            got = rep["tdb"].expand(r.name, pos, length)
            assert got == rep["jdb"].expand(r.name, pos, length)
    assert len(got) >= 1
    with pytest.raises(KeyError):
        rep["tdb"].by_name("rpt_missing")


def test_rep_files_both_ways(rep, tmp_path):
    rep["jdb"].save(str(tmp_path / "j"))
    rep["tdb"].save(str(tmp_path / "t"))
    for ext in (".rep.fa", ".rep.info"):
        assert (tmp_path / f"t{ext}").read_bytes() == \
            (tmp_path / f"j{ext}").read_bytes()
    from_j = trep.RepeatDB.load(str(tmp_path / "j"), rep["tref"])
    from_t = jrep.RepeatDB.load(str(tmp_path / "t"), rep["jref"])
    assert_db_equal(from_t, from_j)
    assert_db_equal(rep["jdb"], from_j)
    name = from_j.repeats[0].name
    assert from_j.expand(name, 0, 50) == from_t.expand(name, 0, 50)


def test_kmer_table_and_classifier_equal(rep):
    codes, spots = rep["codes"], rep["spots"]
    jt, tt = jrep.build_kmer_table(rep["jdb"]), trep.build_kmer_table(
        rep["tdb"])
    assert tt.dtype == jt.dtype and tt.size > 0
    np.testing.assert_array_equal(tt, jt)
    rng = np.random.default_rng(0)
    B, L = 96, 80
    seqs = np.zeros((B, L), np.uint8)
    for i in range(B):
        p = (spots[i % len(spots)] + 10 if i % 2 == 0
             else int(rng.integers(0, codes.size - L)))
        seqs[i] = codes[p:p + L]
        if i % 4 >= 2:
            seqs[i] = alphabet.revcomp(seqs[i].copy())
        if i % 7 == 0:
            seqs[i, ::9] = 4                     # Ns break windows
    lens = np.where(np.arange(B) % 5 == 0, 60, L).astype(np.int64)
    got = trep.classify_repetitive(seqs, lens, tt)
    np.testing.assert_array_equal(got, jrep.classify_repetitive(seqs, lens,
                                                                jt))
    assert got[::2].sum() >= 30
    assert not trep.classify_repetitive(seqs, lens,
                                        np.zeros(0, np.uint64)).any()


def test_repeat_aligner_equal(rep):
    """align_repeats on the repeat FM index (the per-read path on the
    CPU): the same (name, offset, fw, score, placements) per read."""
    codes, spots = rep["codes"], rep["spots"]
    jdb, tdb = rep["jdb"], rep["tdb"]
    rseq = {r.name: alphabet.decode(r.seq) for r in tdb.repeats}
    ja = JRepeatAligner(jbuild_fm(jref_of(rseq), ftab_k=6), jdb)
    ta = TRepeatAligner(tbuild_fm(tref_of(rseq), ftab_k=6), tdb,
                        device="cpu")
    rng = np.random.default_rng(6)
    reads = []
    for i in range(48):
        if i % 3 == 2:                            # unique sequence
            p = int(rng.integers(0, 900))
        else:
            p = spots[i % len(spots)] + int(rng.integers(0, 50))
        s = codes[p:p + 100].copy()
        if i % 4 == 1:
            s[50] = (s[50] + 1) % 4
        if i % 2:
            s = alphabet.revcomp(s)
        reads.append((f"r{i}", s))
    q = np.full(100, 40, np.int8)
    got = ta.align_repeats(tbatchify([TRead(n, s, q, i) for i, (n, s)
                                      in enumerate(reads)]))
    want = ja.align_repeats(jbatchify([JRead(n, s, q, i) for i, (n, s)
                                       in enumerate(reads)]))
    assert got == want
    placed = [o for o in got if o is not None]
    assert len(placed) >= 30
    assert all(len(o[4]) >= len(spots) for o in placed)
