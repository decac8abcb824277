"""hisat2_tpu_torch/align/paired_rna.py function by function against the
JAX package's align/paired_rna.py on the same numpy inputs, exact.

Random inputs for the pure host functions: _concat_pair, _augmented_mate
(rows with more spliced candidates than grid columns among them),
_mark_baked_ties, _pair_grid under fr/rf/ff, dovetail, no_contain,
no_overlap and in DNA mode, _tlen_intron_sum without and with known sites
in the gap. Real inputs for the two that run the aligner's finalizers and
splice rescue: each mate's candidate grids from the port's fused PE step
(CPU) on the genome and mixed pairs of tests/test_torch_paired_rna_pipeline
.py, copied for each package; rescue_pair_rna must leave equal grids,
spliced candidates and published sites, and _fin_mate_records equal
columns for every valid column of the rescued grids, both mates."""

import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_paired_rna_pipeline import (PAIRS, mixed_pairs,
                                            sharded_genome, to_batches)
import test_torch_native_cache  # noqa: F401  (JAX native libs, built once under a lock)
from hisat2_tpu.align import paired_rna as jprna
from hisat2_tpu.align.pipeline import Aligner as JAligner
from hisat2_tpu.align.pipeline import AlignerOpts as JOpts
from hisat2_tpu.align.splice_db import SpliceSiteDB as JSpliceSiteDB
from hisat2_tpu.index.fm_index import build_fm_index
from hisat2_tpu.io.reads import ReadBatch as JReadBatch
from hisat2_tpu.io.reference import reference_from_seqs
from hisat2_tpu.utils import alphabet as jalphabet

from hisat2_tpu_torch.align import paired as tpaired
from hisat2_tpu_torch.align import paired_rna as tprna
from hisat2_tpu_torch.align.pipeline import NEG_INF
from hisat2_tpu_torch.align.pipeline import Aligner as TAligner
from hisat2_tpu_torch.align.pipeline import AlignerOpts as TOpts
from hisat2_tpu_torch.align.splice_db import SpliceSiteDB as TSpliceSiteDB
from hisat2_tpu_torch.index.fm_index import FMIndex
from hisat2_tpu_torch.io.reads import ReadBatch as TReadBatch

torch.set_num_threads(1)


def plain(x):
    """Nested lists/dicts of Python scalars, for comparing candidate
    dicts and column dicts of both packages."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.tolist())
    if isinstance(x, np.generic):
        return x.item()
    return x


def assert_same(got, want):
    assert plain(got) == plain(want)


def random_mate(rng, B=40, K2=8, spl_rows=12, max_spl=6):
    """A per-mate grid dict and a spliced-candidate map with up to max_spl
    candidates a row (more than paired_rna's 4 columns on some rows)."""
    pos = np.sort(rng.integers(1000, 60000, (B, K2)), axis=1)
    score = -np.sort(rng.integers(0, 30, (B, K2)), axis=1).astype(np.int64)
    score[rng.random((B, K2)) < 0.25] = NEG_INF
    m = dict(score=score, pos=pos.astype(np.int32),
             fw=rng.random((B, K2)) < 0.5, gapped=rng.random((B, K2)) < 0.1)
    spl = {}
    for i in rng.choice(B, spl_rows, replace=False):
        n = int(rng.integers(1, max_spl + 1))
        cands = []
        for _ in range(n):
            a = int(rng.integers(1000, 60000))
            j = int(rng.integers(10, 90))
            d = int(rng.integers(60, 3000))
            cands.append(dict(score=int(rng.integers(-25, 1)), posA=a,
                              posB=a + d, fw=bool(rng.random() < 0.5), j=j,
                              delta=d, strand="+", canon=int(rng.integers(0,
                                                                         3))))
        spl[int(i)] = cands
    lens = rng.integers(60, 101, B).astype(np.int64)
    return m, spl, lens, np.full(B, -20, np.int64)


def test_concat_pair():
    out = []
    for RB in (JReadBatch, TReadBatch):
        r = np.random.default_rng(2)
        b1 = RB(r.integers(0, 5, (6, 104)).astype(np.uint8),
                r.integers(0, 42, (6, 104)).astype(np.int8),
                r.integers(50, 101, 6).astype(np.int32),
                [f"a{i}" for i in range(6)])
        b2 = RB(r.integers(0, 5, (6, 112)).astype(np.uint8),
                r.integers(0, 42, (6, 112)).astype(np.int8),
                r.integers(50, 109, 6).astype(np.int32),
                [f"a{i}" for i in range(6)])
        out.append((b1, b2))
    want = jprna._concat_pair(*out[0])
    got = tprna._concat_pair(*out[1])
    for f in ("seqs", "quals", "lens"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got.seqs.shape == (12, 112)
    assert got.names == want.names


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_augmented_mate(seed):
    m, spl, lens, mins = random_mate(np.random.default_rng(seed))
    want, wovf = jprna._augmented_mate(m, spl, lens, mins)
    got, govf = tprna._augmented_mate(m, spl, lens, mins)
    assert_same(got, want)
    np.testing.assert_array_equal(govf, wovf)
    assert govf.any() and not govf.all()
    assert (got["ext"] > lens[:, None]).any()


def test_augmented_mate_without_spliced_candidates():
    m, _, lens, mins = random_mate(np.random.default_rng(6))
    want, wovf = jprna._augmented_mate(m, {}, lens, mins)
    got, govf = tprna._augmented_mate(m, {}, lens, mins)
    assert_same(got, want)
    assert not govf.any()


def test_mark_baked_ties():
    m, spl, lens, mins = random_mate(np.random.default_rng(7))
    jdb, tdb = JSpliceSiteDB(), TSpliceSiteDB()
    baked = 0
    for i, cands in spl.items():
        for c in cands[::2]:
            c["canon"] = 1
            c["score"] = int(m["score"][i, 0])      # ties the best column
            site = (c["posA"] + c["j"] - 1, c["posB"] + c["j"])
            jdb.add_known(*site, "+")
            tdb.add_known(*site, "+")
            baked += 1
        cands[-1]["canon"] = 1                      # canonical, not baked
    jdb.add_novel(5, 900, "+")
    tdb.add_novel(5, 900, "+")
    want, _ = jprna._augmented_mate(m, spl, lens, mins)
    got, _ = tprna._augmented_mate(m, spl, lens, mins)
    before = got["rank"].copy()
    jprna._mark_baked_ties(SimpleNamespace(ssdb=jdb), want, m, spl, lens)
    tprna._mark_baked_ties(SimpleNamespace(ssdb=tdb), got, m, spl, lens)
    assert_same(got, want)
    assert baked and (got["rank"] != before).any()


@pytest.mark.parametrize("opts", [
    dict(fr="fr", spliced=True), dict(fr="rf", spliced=True),
    dict(fr="ff", spliced=True), dict(fr="fr", spliced=True, dovetail=True),
    dict(fr="rf", spliced=True, dovetail=True),
    dict(fr="fr", spliced=True, no_contain=True),
    dict(fr="fr", spliced=True, no_overlap=True),
    dict(fr="fr", minins=150, maxins=400),
    dict(fr="ff", no_contain=True, no_overlap=True, max_intron=2000,
         spliced=True)],
    ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_pair_grid(opts):
    rng = np.random.default_rng(len(str(opts)))
    m1, spl1, lens, mins = random_mate(rng)
    m2, spl2, _, _ = random_mate(rng)
    m2["pos"][:6] = m1["pos"][:6]                # containment, full overlap
    a1, _ = tprna._augmented_mate(m1, spl1, lens, mins)
    a2, _ = tprna._augmented_mate(m2, spl2, lens, mins)
    wk, wt = jprna._pair_grid(a1, a2, JOpts(**opts), 104)
    gk, gt = tprna._pair_grid(a1, a2, TOpts(**opts), 104)
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gt, wt)
    assert gk.dtype == wk.dtype == np.int64
    ok = gt > NEG_INF // 2
    assert ok.any() and not ok.all()
    assert tpaired._maxins_eff(TOpts(**opts), 104) == \
        (opts.get("max_intron", TOpts().max_intron) + 208
         if opts.get("spliced") else opts.get("maxins", TOpts().maxins))


@pytest.mark.parametrize("known", [False, True])
def test_tlen_intron_sum(known):
    rng = np.random.default_rng(11)
    N = 300
    a1s = rng.integers(1000, 50000, N)
    a2s = a1s + rng.integers(-400, 2500, N)
    a1e = a1s + rng.integers(80, 1200, N)
    a2e = a2s + rng.integers(80, 1200, N)
    g1 = np.where(rng.random(N) < 0.5, rng.integers(60, 1000, N), 0)
    g2 = np.where(rng.random(N) < 0.5, rng.integers(60, 1000, N), 0)
    i1s = a1s + rng.integers(5, 60, N)
    i2s = np.where(rng.random(N) < 0.2, i1s, a2s + rng.integers(5, 60, N))
    g2 = np.where((i2s == i1s) & (rng.random(N) < 0.5), g1, g2)
    jdb, tdb = JSpliceSiteDB(), TSpliceSiteDB()
    if known:
        # sites inside inter-mate gaps, some equal to a mate's own intron,
        # some straddling a gap's end
        for k in range(0, N, 3):
            lo, hi = sorted((int(min(a1e[k], a2e[k])),
                             int(max(a1s[k], a2s[k]))))
            if hi - lo > 40:
                left = int(rng.integers(lo, hi - 30))
                right = int(rng.integers(left + 2, hi + 20))
                for db in (jdb, tdb):
                    db.add_known(left, right, "+")
            if g1[k]:
                for db in (jdb, tdb):
                    db.add_known(int(i1s[k]) - 1, int(i1s[k] + g1[k]), "+")
    args = (a1s, a1e, a2s, a2e, i1s, g1, i2s, g2)
    want = jprna._tlen_intron_sum(SimpleNamespace(ssdb=jdb), *args)
    got = tprna._tlen_intron_sum(SimpleNamespace(ssdb=tdb), *args)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    base = np.where(g1 > 0, g1, 0) + np.where(g2 > 0, g2, 0) - np.where(
        (g1 > 0) & (g2 > 0) & (i1s == i2s) & (g1 == g2), g1, 0)
    if known:
        assert (got > base).any()
    else:
        np.testing.assert_array_equal(got, base)


@pytest.fixture(scope="module")
def real():
    """Both packages' aligners (RNA mode, known sites of one intron per
    chromosome), batches and the port's fused-step grids of the mixed
    pairs' first batch."""
    gs, introns = sharded_genome()
    ref = reference_from_seqs({"c1": jalphabet.decode(gs[0]),
                               "c2": jalphabet.decode(gs[1])})
    jfm = build_fm_index(ref, ftab_k=6)
    jb, tb = to_batches(mixed_pairs(gs, introns)[:PAIRS])
    jal = JAligner(jfm, opts=JOpts(spliced=True))
    tal = TAligner(FMIndex.from_object(jfm), opts=TOpts(spliced=True),
                   device="cpu")
    for cb, s, il in introns[::2]:
        jal.ssdb.add_known(cb * 50000 + s - 1, cb * 50000 + s + il, "+")
        tal.ssdb.add_known(cb * 50000 + s - 1, cb * 50000 + s + il, "+")
    m1, m2, *_ = tpaired.stage_pe_fused(tal, *tb[0], KP=8, KF=1)
    return dict(jal=jal, tal=tal, jb=jb[0], tb=tb[0], m=(m1, m2))


@pytest.fixture(scope="module")
def rescued(real):
    """rescue_pair_rna of both packages on copies of the same grids."""
    jm = copy.deepcopy(real["m"])
    tm = copy.deepcopy(real["m"])
    jprna.rescue_pair_rna(real["jal"], *real["jb"], *jm)
    tprna.rescue_pair_rna(real["tal"], *real["tb"], *tm)
    return jm, tm


def test_rescue_pair_rna(real, rescued):
    jm, tm = rescued
    for t, j in zip(tm, jm):
        assert sorted(t) == sorted(j)
        for k in ("score", "pos", "fw", "gapped"):
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        assert_same(t.get("splice", {}), j.get("splice", {}))
    assert tm[0].get("splice") and tm[1].get("splice")
    assert real["tal"].ssdb.novel == real["jal"].ssdb.novel
    assert real["tal"].ssdb.version() == real["jal"].ssdb.version()
    assert real["tal"].ssdb.novel


@pytest.mark.parametrize("mate2", [False, True])
def test_fin_mate_records(real, rescued, mate2):
    _, tm = rescued
    m = tm[1 if mate2 else 0]
    B = len(real["tb"][0])
    lens = real["tb"][1 if mate2 else 0].lens.astype(np.int64)
    spl = m.get("splice", {})
    aug, _ = tprna._augmented_mate(m, spl, lens, np.full(B, -20, np.int64))
    rec_pair, tcol = np.nonzero(aug["valid"])
    jcat = jprna._concat_pair(*real["jb"])
    tcat = tprna._concat_pair(*real["tb"])
    want = jprna._fin_mate_records(real["jal"], jcat, B, rec_pair, tcol,
                                   aug, spl, mate2, lens)
    got = tprna._fin_mate_records(real["tal"], tcat, B, rec_pair, tcol, aug,
                                  spl, mate2, lens)
    assert_same(got, want)
    K2 = m["score"].shape[1]
    assert (tcol >= K2).any() and got["ok"][tcol >= K2].any()
    assert got["ok"][tcol < K2].any()
