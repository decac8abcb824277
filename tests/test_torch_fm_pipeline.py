"""The port's FM-index paths, single-end and paired-end, against the JAX
package's.

One two-chromosome 46 kb genome (a planted repeat, an N run) indexed by
the JAX package in five ways, each handed to the port as the same arrays:
  A       no k-mer table, full suffix array
  B       A with the SA sampled at offrate 4
  T       the default index with its k-mer table
  pair    a kt = 6 table (bucket load 11: the paired-k-mer mode)
  stride2 a kt = 9 table sampled at stride 2
Reads carry mismatches, Ns, 1-3 bp indels, reverse complements, repeat
copies, a chromosome boundary, short lengths and random sequence, so the
segment fallback and the gapped DP both run. Checked, exactly (all int32):
every key of _stage_candidates with the `seeds` and `segments` seeders; the
fused SE step (_se_core inside _stage_align_fused); the packed step's
fastpack, merged grid and extras; _device_align + _merged_host;
Aligner.align_batch; and the SAM bytes and stats of align_and_emit_stream,
of the seed_mode=False emit path and of results_to_sam. B's SAM must also
equal A's: a sampled SA changes memory, never answers.

Paired-end, on pairs of test_torch_paired_emit's kinds (indels, repeat
copies, random mates, discordant mates, an N every 8 bases for the mate
rescue): the host concordance grid (_concordant_grid; fr, rf, ff,
dovetail, no_contain, no_overlap) on random candidate grids, and the SAM
bytes and stats of the packed step, the fused step and the
seed_mode=False per-pair path (align_pairs + pairs_to_sam) on A and B."""

import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_paired_emit as pe_base
import test_torch_pipeline as se_base
from test_torch_fm_ops import variant
import test_torch_native_cache  # noqa: F401  (JAX native libs, built once under a lock)
from hisat2_tpu.align import emit as jemit
from hisat2_tpu.align import paired as jpaired
from hisat2_tpu.align import pipeline as jpipe
from hisat2_tpu.align.pipeline import Aligner as JAligner
from hisat2_tpu.align.pipeline import AlignerOpts as JOpts
from hisat2_tpu.align.scoring import DEFAULT_SCORING as JSCORING
from hisat2_tpu.index.fm_index import build_fm_index
from hisat2_tpu.io import sam as jsam
from hisat2_tpu.io.reads import Read as JRead, batchify as jbatchify
from hisat2_tpu.io.reference import reference_from_seqs

from hisat2_tpu_torch.align import emit as temit
from hisat2_tpu_torch.align import paired as tpaired
from hisat2_tpu_torch.align import pipeline as tpipe
from hisat2_tpu_torch.align.pipeline import Aligner as TAligner
from hisat2_tpu_torch.align.pipeline import AlignerOpts as TOpts
from hisat2_tpu_torch.align.scoring import DEFAULT_SCORING as TSCORING
from hisat2_tpu_torch.index.fm_index import FMIndex
from hisat2_tpu_torch.io import sam as tsam
from hisat2_tpu_torch.io.reads import Read as TRead, batchify as tbatchify
from hisat2_tpu_torch.ops import dp_cuda

torch.set_num_threads(1)

NB = 88          # reads per batch: 8 of each kind of se_base._reads


def T(a, dtype=torch.int32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(77)
    ref = reference_from_seqs(se_base._genome(rng))
    a = build_fm_index(ref, seed_table=False)
    jfms = {"A": a, "B": variant(a, offrate=4), "T": build_fm_index(ref),
            "pair": variant(a, table=(6, 1)),
            "stride2": variant(a, table=(9, 2))}
    assert a.st_k == 0 and a.ftab_k == 8 and jfms["B"].sa.size == 0
    na = int(a.ref.frag_joined[-1])
    triples = se_base._reads(a.ref.joined, na, rng, 2 * NB)
    # one batch with per-base qualities, one with a constant quality
    parts = [triples[:NB], [(n, s, np.full(s.size, 40, np.int8))
                            for n, s, _ in triples[NB:]]]
    jb = [jbatchify([JRead(n, s, q, i) for i, (n, s, q) in enumerate(p)],
                    pad_to=104) for p in parts]
    tb = [tbatchify([TRead(n, s, q, i) for i, (n, s, q) in enumerate(p)],
                    pad_to=104) for p in parts]
    return jfms, {k: FMIndex.from_object(j) for k, j in jfms.items()}, jb, tb


def aligners(world, name, **opts):
    jfms, tfms, _, _ = world
    return (JAligner(jfms[name], opts=JOpts(**opts)),
            TAligner(tfms[name], opts=TOpts(**opts), device="cpu"))


def test_aligner_picks_the_seeder(world):
    for name, seed_mode, want in (("A", True, ("seeds", "segments")),
                                  ("A", False, ("segments", "segments")),
                                  ("B", True, ("seeds", "segments")),
                                  ("T", False, ("table", "table_dense")),
                                  ("pair", True, ("table", "table_dense"))):
        jal, tal = aligners(world, name, seed_mode=seed_mode)
        assert (tal.seeder, tal.fb_seeder) == want
        assert (tal.seeder, tal.fb_seeder) == (jal.seeder, jal.fb_seeder)
        assert tal.min_seg_len == jal.min_seg_len == 8
        # FM keys on the device exactly when backward search will run
        assert ("sides" in tal.idx) == (want[0] != "table")
        assert ("samp_bits" in tal.idx) == (name == "B")


@pytest.mark.parametrize("name", ["A", "B"])
@pytest.mark.parametrize("seeder,nseeds,locs", [
    ("seeds", 8, 8), ("segments", 16, 8), ("seeds", 8, 2)])
def test_stage_candidates(world, name, seeder, nseeds, locs):
    jal, tal = aligners(world, name)
    _, _, jb, tb = world
    b = jb[0]
    want = jpipe._stage_candidates(
        jal.idx, jal.sctab, jnp.asarray(b.seqs), jnp.asarray(b.quals),
        jnp.asarray(b.lens), nseeds, locs, 16, jal.min_seg_len, seeder,
        jal.fm.ftab_k)
    got = tpipe._stage_candidates(
        tal.idx, tal.sctab, T(tb[0].seqs), T(tb[0].quals), T(tb[0].lens),
        nseeds, locs, 16, tal.min_seg_len, seeder, tal.fm.ftab_k)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    exh = got["exhausted"].numpy()
    # the three repeat copies overflow 2 rows a seed, not 8
    assert exh.any() and exh.all() == (locs == 8)
    assert (got["score"].numpy()[:, 0] > tpipe.NEG_INF).mean() > 0.3


@pytest.mark.parametrize("name", ["A", "B"])
def test_fused_step(world, name):
    """_se_core (seeds, then the segment fallback, then the DP) inside
    _stage_align_fused, and Aligner.device_align_fused around it."""
    jal, tal = aligners(world, name)
    _, _, jb, tb = world
    jm, jfin = jal.device_align_fused(jb[0])
    before = dp_cuda.launches["dp_score"]
    tm, tfin = tal.device_align_fused(tb[0])
    assert dp_cuda.launches["dp_score"] == before   # CPU: the plain version
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_array_equal(tm[k], jm[k], err_msg=k)
    np.testing.assert_array_equal(tfin, jfin)
    assert tm["gapped"].any()


@pytest.mark.parametrize("name", ["A", "B", "pair", "stride2"])
def test_packed_step(world, name):
    jal, tal = aligners(world, name)
    _, _, jb, tb = world
    for jbatch, tbatch in zip(jb, tb):
        jfp, jmerged, jex = jal.device_align_fast(jbatch)
        fp, merged, ex, ready = tal.device_align_fast(tbatch)
        assert ready is None
        np.testing.assert_array_equal(fp.numpy(), np.asarray(jfp))
        np.testing.assert_array_equal(merged.numpy(), np.asarray(jmerged))
        assert sorted(ex) == sorted(jex)
        for k in jex:
            np.testing.assert_array_equal(ex[k].numpy(), np.asarray(jex[k]),
                                          err_msg=k)
        assert (merged[:, :, 2] & 2).any()


@pytest.mark.parametrize("name,seed_mode", [("A", False), ("A", True),
                                            ("B", False), ("T", False)])
def test_device_align_and_merged_host(world, name, seed_mode):
    jal, tal = aligners(world, name, seed_mode=seed_mode)
    _, _, jb, tb = world
    jst, jdp = jal._device_align(jb[0])
    tst, tdp = tal._device_align(tb[0])
    for k in ("pos", "score", "nmm", "exhausted", "seqs2", "quals2",
              "lens2"):
        np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]),
                                      err_msg=k)
    assert tdp is not None and jdp is not None
    np.testing.assert_array_equal(tdp.numpy(), np.asarray(jdp))
    assert (tdp > tpipe.NEG_INF).any()
    jm = jal._merged_host(jst, jdp, NB)
    tm = tal._merged_host(tst, tdp, NB)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        assert tm[k].dtype == jm[k].dtype, k
        np.testing.assert_array_equal(tm[k], jm[k], err_msg=k)
    for m in (jal.metrics, tal.metrics):
        assert m.dp_lanes > 0
    assert tal.metrics.dp_lanes == jal.metrics.dp_lanes
    assert tal.metrics.seeds == jal.metrics.seeds
    assert tal.metrics.fallback_reads == jal.metrics.fallback_reads
    assert (tal.metrics.fallback_reads > 0) == seed_mode


def _same_results(tres, jres):
    assert len(tres) == len(jres)
    for t, j in zip(tres, jres):
        assert (t.best, t.secbest, t.filtered) == (j.best, j.secbest,
                                                   j.filtered)
        assert len(t.alns) == len(j.alns)
        for a, b in zip(t.alns, j.alns):
            for f in ("joined_pos", "fw", "score", "cigar", "nmm",
                      "gap_opens", "gap_exts", "md", "nm", "tidx", "toff"):
                assert getattr(a, f) == getattr(b, f), f


def _head(b, n):
    """The first n reads of a batch, as a batch of the same package."""
    return type(b)(b.seqs[:n], b.quals[:n], b.lens[:n], b.names[:n],
                   b.rdids[:n])


def _sam(emit_fn, sammod, al, ref, *args):
    buf = io.StringIO()
    st = emit_fn(al, *args, sammod.SamWriter(
        buf, list(ref.names), [int(x) for x in ref.tlens], no_head=True))
    return buf.getvalue(), st


@pytest.mark.parametrize("name,seed_mode", [("A", True), ("A", False),
                                            ("B", True)])
def test_align_batch_and_results_to_sam(world, name, seed_mode):
    jal, tal = aligners(world, name, seed_mode=seed_mode)
    _, _, jb, tb = world
    ref = jal.fm.ref
    jres = jal.align_batch(jb[0])
    tres = tal.align_batch(tb[0])
    _same_results(tres, jres)
    assert sum(r.aligned for r in tres) > NB // 2
    assert any(a.gap_opens for r in tres for a in r.alns)
    jtext, jst = _sam(lambda al, b, res, w: jpipe.results_to_sam(
        b, res, al, w), jsam, jal, ref, jb[0], jres)
    ttext, tst = _sam(lambda al, b, res, w: tpipe.results_to_sam(
        b, res, al, w), tsam, tal, ref, tb[0], tres)
    assert tst == jst and ttext == jtext
    assert ttext.count("\n") >= NB


# index B must give index A's bytes; filled by the A cases, read by B's
_SAM_OF_A: dict = {}


@pytest.mark.parametrize("name,seed_mode", [
    ("A", True), ("B", True), ("pair", True), ("stride2", True),
    ("A", False), ("B", False), ("T", False)])
def test_sam_bytes_match(world, name, seed_mode):
    """align_and_emit_stream: the packed step on an FM index (A, B), on
    the two Gbp-shard table modes, and the seed_mode=False emit path."""
    jal, tal = aligners(world, name, seed_mode=seed_mode)
    _, _, jb, tb = world
    ref = jal.fm.ref
    jtext, jst = _sam(jemit.align_and_emit_stream, jsam, jal, ref, jb)
    before = dp_cuda.launches["dp_score"]
    ttext, tst = _sam(temit.align_and_emit_stream, tsam, tal, ref, tb)
    assert dp_cuda.launches["dp_score"] == before
    assert tst == jst
    assert ttext == jtext
    lines = ttext.splitlines()
    prim = [ln.split("\t")[0] for ln in lines
            if not int(ln.split("\t")[1]) & 256]
    assert prim == [n for b in tb for n in b.names]
    assert any("D" in ln.split("\t")[5] or "I" in ln.split("\t")[5]
               for ln in lines)
    assert tst["unal"] < tst["reads"] // 2
    if name == "A":
        _SAM_OF_A[seed_mode] = ttext
    elif name == "B" and seed_mode in _SAM_OF_A:
        assert ttext == _SAM_OF_A[seed_mode]


def test_legacy_emit_in_seed_mode(world):
    """_align_and_emit_legacy's other branch (device_align_fused), which
    no option of the port routes to: called directly."""
    jal, tal = aligners(world, "A")
    _, _, jb, tb = world
    ref = jal.fm.ref
    jtext, jst = _sam(jemit._align_and_emit_legacy, jsam, jal, ref, jb[0])
    ttext, tst = _sam(temit._align_and_emit_legacy, tsam, tal, ref, tb[0])
    assert tst == jst and ttext == jtext


def test_unported_options_still_raise(world):
    """Spliced SE and PE and --tmo are ported (tests/test_torch_splice_*.py,
    tests/test_torch_paired_rna*.py): spliced align_pairs + pairs_to_sam,
    with and without --tmo, gives the JAX package's SAM bytes and stats on
    index A (FM seeding, per-base qualities); local mode still raises."""
    _, tfms, jb, tb = world
    jb0, tb0 = _head(jb[0], 24), _head(tb[0], 24)
    for kw in (dict(spliced=True), dict(spliced=True, tmo=True)):
        jal, tal = aligners(world, "A", **kw)
        jtext, jst = _sam(lambda al, w: jpaired.pairs_to_sam(
            jb0, jb0, jpaired.align_pairs(al, jb0, jb0), al, w),
            jsam, jal, jal.fm.ref)
        ttext, tst = _sam(lambda al, w: tpaired.pairs_to_sam(
            tb0, tb0, tpaired.align_pairs(al, tb0, tb0), al, w),
            tsam, tal, tal.fm.ref)
        assert tst == jst and ttext == jtext
        assert tst["pairs"] == 24
    with pytest.raises(NotImplementedError):
        TAligner(tfms["A"], scoring=dataclasses.replace(TSCORING, local=True),
                 device="cpu")
    # Zs:Z tags are ported: on a linear index the option changes nothing
    assert TAligner(tfms["A"], opts=TOpts(zs_tags=True),
                    device="cpu").overlay is None


# ---------------------------------------------------------------------------
# paired-end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opts", [
    dict(fr="fr"), dict(fr="rf"), dict(fr="ff"),
    dict(fr="fr", dovetail=True), dict(fr="rf", dovetail=True),
    dict(fr="fr", no_contain=True), dict(fr="fr", no_overlap=True),
    dict(fr="ff", no_contain=True, no_overlap=True, minins=150, maxins=400)],
    ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_concordant_grid(opts):
    from types import SimpleNamespace
    rng = np.random.default_rng(len(str(opts)))
    B, K = 60, 8

    def cands(base):
        pos = base[:, None] + rng.integers(-450, 450, (B, K))
        pos[:, K - 2] = pos[:, 0]            # a duplicate locus
        score = -np.sort(rng.integers(0, 40, (B, K)), axis=1)
        score[rng.random((B, K)) < 0.2] = -(1 << 30)
        return dict(score=score.astype(np.int64), pos=pos.astype(np.int32),
                    fw=rng.random((B, K)) < 0.5,
                    gapped=np.zeros((B, K), bool))
    base = rng.integers(1000, 40000, B)
    m1, m2 = cands(base), cands(base)
    m2["pos"][:5] = m1["pos"][:5]            # containment and full overlap
    lens = rng.integers(60, 101, B).astype(np.int32)
    b = SimpleNamespace(lens=lens, seqs=np.zeros((B, 104), np.uint8))
    want = jpaired._concordant_grid(m1, m2, b, b, JOpts(**opts), JSCORING)
    got = tpaired._concordant_grid(m1, m2, b, b, TOpts(**opts), TSCORING)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["has"].any() and not got["has"].all()
    assert (got["sec"] > tpipe.NEG_INF // 2).any()


@pytest.fixture(scope="module")
def pe_world(world):
    jfms, tfms, _, _ = world
    rng = np.random.default_rng(2027)
    a = jfms["A"]
    na = int(a.ref.frag_joined[-1])
    pairs = pe_base._pairs(a.ref.joined, na, rng, 96)
    const = [(np.full(100, 40, np.int8),) * 2] * 96
    perbase = [(rng.integers(2, 42, 100).astype(np.int8),
                rng.integers(2, 42, 100).astype(np.int8)) for _ in range(96)]
    out = {}
    for what, quals in (("const", const), ("perbase", perbase)):
        out[what] = (pe_base._batches(JRead, jbatchify, pairs, quals),
                     pe_base._batches(TRead, tbatchify, pairs, quals))
    return out


_PE_SAM_OF_A: dict = {}


@pytest.mark.parametrize("name", ["A", "B"])
@pytest.mark.parametrize("step,seed_mode", [
    ("const", True), ("perbase", True), ("perbase", False)],
    ids=["packed", "fused", "per-pair"])
def test_pe_sam_bytes_match(world, pe_world, name, step, seed_mode):
    jal, tal = aligners(world, name, seed_mode=seed_mode)
    jb, tb = pe_world[step]
    ref = jal.fm.ref
    jtext, jst = _sam(jemit.align_and_emit_pe_stream, jsam, jal, ref, [jb])
    ttext, tst = _sam(temit.align_and_emit_pe_stream, tsam, tal, ref, [tb])
    assert tst == jst
    assert ttext == jtext
    assert tst["conc_uniq"] + tst["conc_multi"] > 40
    lines = ttext.splitlines()
    assert any("D" in ln.split("\t")[5] or "I" in ln.split("\t")[5]
               for ln in lines)
    key = (step, seed_mode)
    if name == "A":
        _PE_SAM_OF_A[key] = ttext
    elif key in _PE_SAM_OF_A:
        assert ttext == _PE_SAM_OF_A[key]


def test_align_pairs_per_pair_path(world, pe_world):
    """align_pairs with seed_mode=False: both mates through _device_align,
    the host grid, the ladder and the rescue; PairResults equal JAX's."""
    jal, tal = aligners(world, "A", seed_mode=False)
    (jb1, jb2), (tb1, tb2) = pe_world["perbase"]
    jres = jpaired.align_pairs(jal, jb1, jb2)
    tres = tpaired.align_pairs(tal, tb1, tb2)
    assert [r.kind for r in tres] == [r.kind for r in jres]
    assert {"concordant", "mixed"} <= {r.kind for r in tres}
    for t, j in zip(tres, jres):
        assert (t.best, t.secbest) == (j.best, j.secbest)
        for a, b in ((t.aln1, j.aln1), (t.aln2, j.aln2)):
            assert (a is None) == (b is None)
            if a is not None:
                assert (a.joined_pos, a.fw, a.score, a.cigar, a.md) == (
                    b.joined_pos, b.fw, b.score, b.cigar, b.md)
    assert any(r.secbest is not None for r in tres)
