"""The port's paired-end DNA path against the JAX package's, end to end.

One index, built by hisat2_tpu and loaded by the port, over a
two-chromosome 46 kb genome (one chromosome boundary) with a planted
600 bp repeat in four copies. Pairs are FR fragments of 200-600 bp with
mismatches, half with mates swapped, of these kinds: plain; a mate with a
1-3 bp indel; both mates inside the repeat (four concordant placements:
the multi-report tiers fill); a random mate (its rescue fails); both mates
random; mates on different chromosomes (discordant); a fragment across the
chromosome boundary; and a mate with an N every 8 bases, which no seed of
the index can place but whose window DP passes (the mate rescue). One
batch has a constant quality (the packed step) and one per-base qualities
(the fused legacy step). Inputs come from a numpy seed; every comparison
is exact.
"""

import io

import numpy as np
import pytest
import torch

import test_torch_native_cache  # noqa: F401  (JAX native libs, built once under a lock)
from hisat2_tpu.align import emit as jemit
from hisat2_tpu.align import paired as jpaired
from hisat2_tpu.align.pipeline import Aligner as JAligner
from hisat2_tpu.index.fm_index import build_fm_index
from hisat2_tpu.io import sam as jsam
from hisat2_tpu.io.reads import Read as JRead, batchify as jbatchify
from hisat2_tpu.io.reference import reference_from_seqs
from hisat2_tpu.utils import alphabet as jalphabet

from hisat2_tpu_torch.align import emit as temit
from hisat2_tpu_torch.align import paired as tpaired
from hisat2_tpu_torch.align.pipeline import Aligner as TAligner
from hisat2_tpu_torch.index.fm_index import FMIndex
from hisat2_tpu_torch.io import sam as tsam
from hisat2_tpu_torch.io.reads import Read as TRead, batchify as tbatchify
from hisat2_tpu_torch.ops import dp_cuda

torch.set_num_threads(1)

RDLEN = 100
PAD = 104
REP = 600
REP_AT = (3000, 12000, 20000, 26000 + 8000)     # joined coordinates
KINDS = ["plain", "indel", "repeat", "randmate", "plain", "bothrand",
         "disc", "boundary", "nrescue", "indel", "plain", "nrescue"]


def _genome(rng):
    a = rng.integers(0, 4, 26000).astype(np.uint8)
    b = rng.integers(0, 4, 20000).astype(np.uint8)
    rep = rng.integers(0, 4, REP).astype(np.uint8)
    for p in REP_AT:
        if p < a.size:
            a[p:p + REP] = rep
        else:
            b[p - a.size:p - a.size + REP] = rep
    return {"chrA": jalphabet.decode(a), "chrB": jalphabet.decode(b)}


def _mutate(rng, seq, rate=0.01):
    seq = seq.copy()
    m = rng.random(seq.size) < rate
    seq[m] = (seq[m] + rng.integers(1, 4, int(m.sum()))) % 4
    return seq


def _pairs(joined, na, rng, n):
    """(name, mate-1 codes, mate-2 codes) per pair; `na` is chrB's first
    base in the joined text."""
    out = []
    for i in range(n):
        kind = KINDS[i % len(KINDS)]
        ins = int(rng.integers(200, 601))
        if kind == "repeat":
            ins = int(rng.integers(250, 351))
            s = int(rng.choice(REP_AT)) + int(rng.integers(0, REP - ins))
        elif kind == "boundary":
            s = na - int(rng.integers(150, 300))
        else:
            s = int(rng.integers(0, joined.size - ins - 10))
        frag = joined[s:s + ins + 3].astype(np.uint8)
        r1 = frag[:RDLEN].copy()
        r2 = jalphabet.revcomp(frag[ins - RDLEN:ins])
        if kind == "indel":
            d = int(rng.integers(1, 4))
            p = int(rng.integers(20, 80))
            if rng.random() < 0.5:       # deletion from mate 1
                r1 = np.concatenate([frag[:p], frag[p + d:RDLEN + d]])
            else:                        # insertion into mate 1
                r1 = np.concatenate([frag[:p],
                                     rng.integers(0, 4, d).astype(np.uint8),
                                     frag[p:RDLEN - d]])
        elif kind == "randmate":
            r2 = rng.integers(0, 4, RDLEN).astype(np.uint8)
        elif kind == "bothrand":
            r1 = rng.integers(0, 4, RDLEN).astype(np.uint8)
            r2 = rng.integers(0, 4, RDLEN).astype(np.uint8)
        elif kind == "disc":
            t = int(rng.integers(na + 1000, joined.size - RDLEN - 10)) \
                if s < na else int(rng.integers(0, na - RDLEN - 1000))
            r2 = jalphabet.revcomp(joined[t:t + RDLEN].astype(np.uint8))
        r1 = _mutate(rng, r1)
        if kind == "nrescue":
            # an N every 8 bases: every seed window (9-mers at this genome
            # size) holds one, and the 13 Ns cost 13 against a minimum
            # score of -20. (13 mod 8 > 4 keeps the pair off the fast path's
            # 3-bit mismatch lanes: see test_wire_nmm_lanes_match_jax)
            r2 = r2.copy()
            r2[2::8] = 4
        else:
            r2 = _mutate(rng, r2)
        if rng.random() < 0.5:
            r1, r2 = r2, r1
        out.append((f"p{i}_{kind}", r1, r2))
    return out


def _batches(mod_read, mod_batchify, pairs, quals):
    b1 = mod_batchify([mod_read(n, r1, q1, i) for i, ((n, r1, _), (q1, _))
                       in enumerate(zip(pairs, quals))], pad_to=PAD)
    b2 = mod_batchify([mod_read(n, r2, q2, i) for i, ((n, _, r2), (_, q2))
                       in enumerate(zip(pairs, quals))], pad_to=PAD)
    return b1, b2


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rng = np.random.default_rng(2026)
    jfm = build_fm_index(reference_from_seqs(_genome(rng)))
    prefix = str(tmp_path_factory.mktemp("idx") / "pe")
    jfm.save(prefix)
    tfm = FMIndex.load(prefix)
    na = int(jfm.ref.frag_joined[-1])
    assert len(jfm.ref.names) == 2 and jfm.ref.joined.size == 46000
    pairs = _pairs(jfm.ref.joined, na, rng, 416)
    const = [(np.full(RDLEN, 40, np.int8),) * 2] * 256
    perbase = [(rng.integers(2, 42, RDLEN).astype(np.int8),
                rng.integers(2, 42, RDLEN).astype(np.int8))
               for _ in range(160)]
    parts = [(pairs[:256], const), (pairs[256:], perbase)]
    jb = [_batches(JRead, jbatchify, p, q) for p, q in parts]
    tb = [_batches(TRead, tbatchify, p, q) for p, q in parts]
    return dict(jal=JAligner(jfm), tal=TAligner(tfm, device="cpu"), jb=jb,
                tb=tb, ref=jfm.ref)


def _writer(mod, ref, buf):
    return mod.SamWriter(buf, list(ref.names), [int(x) for x in ref.tlens],
                         no_head=True)


def test_packed_step_matches(setup):
    """stage_pe_packed: wire-coded pack, both merged grids, the combo list
    and every extras key equal JAX's; the tiers and the rescue rows are
    populated."""
    (jb1, jb2), (tb1, tb2) = setup["jb"][0], setup["tb"][0]
    KP = max(8, setup["tal"].opts.khits + 3)
    jpack, jm1, jm2, jpt, jex = jpaired.stage_pe_packed(setup["jal"], jb1,
                                                        jb2, KP=KP)
    pack, m1, m2, pt, ex, ready = tpaired.stage_pe_packed(setup["tal"], tb1,
                                                          tb2, KP=KP)
    assert ready is None and pack.dtype == torch.int32
    np.testing.assert_array_equal(pack.numpy().view(np.uint32),
                                  np.asarray(jpack))
    for name, g, w in (("m1", m1, jm1), ("m2", m2, jm2), ("pair_top", pt,
                                                          jpt)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    assert sorted(ex) == sorted(jex)
    assert {"mrows0", "mrows1", "mrep0", "mrep1", "srows", "sm1", "sm2",
            "spt", "rescue"} <= set(ex)
    assert ex["_wire"] == jex["_wire"]
    for k in ex:
        if k == "_wire":
            continue
        got = ex[k].numpy()
        want = np.asarray(jex[k])
        if want.dtype == np.uint32:
            got = got.view(np.uint32)
        np.testing.assert_array_equal(got, want, err_msg=k)
    assert (ex["mrows1"].numpy() >= 0).any()        # tier 1 filled
    assert (ex["srows"].numpy() >= 0).any()


def test_rescue_passes_and_pair_is_concordant(setup):
    """Rescue lanes score at or above their minimum, and their pairs come
    out concordant (both records flag 2, YT:Z:CP): every N-laden mate's,
    whose window holds it whole. (A lane whose window crosses the
    chromosome boundary can pass the DP and still fail concordance.)"""
    tal = setup["tal"]
    tb1, tb2 = setup["tb"][0]
    out = tpaired.stage_pe_packed(tal, tb1, tb2,
                                  KP=max(8, tal.opts.khits + 3))
    r = out[4]["rescue"].numpy()
    rows = r[:, 0]
    rl = np.where(r[:, 1] == 1, tb2.lens[rows], tb1.lens[rows])
    mins = np.array([tal.scoring.min_score(int(x)) for x in rl])
    passing = [tb1.names[int(i)] for i in rows[(rows >= 0) & (r[:, 2] >= mins)]]
    nres = [n for n in passing if n.endswith("_nrescue")]
    assert len(nres) >= 1
    buf = io.StringIO()
    temit.align_and_emit_pe(tal, tb1, tb2, _writer(tsam, setup["ref"], buf))
    recs = {}
    for ln in buf.getvalue().splitlines():
        f = ln.split("\t")
        if not int(f[1]) & 256:
            recs.setdefault(f[0], []).append(ln)
    for name in nres:
        lines = recs[name]
        assert len(lines) == 2
        for ln in lines:
            assert int(ln.split("\t")[1]) & 2 and "YT:Z:CP" in ln


def test_fused_step_matches(setup):
    """stage_pe_fused (the per-base-quality batches' device step) equals
    JAX's on every output."""
    (jb1, jb2), (tb1, tb2) = setup["jb"][1], setup["tb"][1]
    want = jpaired.stage_pe_fused(setup["jal"], jb1, jb2, KP=8, KF=1)
    got = tpaired.stage_pe_fused(setup["tal"], tb1, tb2, KP=8, KF=1)
    for g, w in zip(got[:2], want[:2]):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=k)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_sam_bytes_match_jax(setup):
    """align_and_emit_pe_stream over both batches: identical SAM bytes and
    stats; on the CPU the DP kernels' counts never move."""
    ref = setup["ref"]
    jbuf, tbuf = io.StringIO(), io.StringIO()
    jst = jemit.align_and_emit_pe_stream(setup["jal"], setup["jb"],
                                         _writer(jsam, ref, jbuf))
    before = dict(dp_cuda.launches)
    tst = temit.align_and_emit_pe_stream(setup["tal"], setup["tb"],
                                         _writer(tsam, ref, tbuf))
    assert dp_cuda.launches == before
    assert tst == jst
    text = tbuf.getvalue()
    assert text == jbuf.getvalue()
    assert tst["pairs"] == 416 and tst["conc_multi"] >= 1
    assert tst["disc"] >= 1 and tst["mixed_al"] >= 1 and tst["unal"] >= 1
    lines = text.splitlines()
    prim = [ln.split("\t")[0] for ln in lines
            if not int(ln.split("\t")[1]) & 256]
    assert prim == [n for b1, _ in setup["tb"] for n in b1.names
                    for _mate in (1, 2)]
    assert any("D" in ln.split("\t")[5] or "I" in ln.split("\t")[5]
               for ln in lines)
    assert any(int(ln.split("\t")[1]) & 256 for ln in lines)


def test_dna_pairs_with_known_sites_match_jax(setup):
    """DNA pairs with known splice sites in the table take the fused step
    and the per-pair ladder, as in the JAX package (TLEN leaves out the
    known introns between the mates): identical SAM bytes and stats on the
    constant-quality batch, and some TLEN shorter than without the sites."""
    ref = setup["ref"]
    (jb1, jb2), (tb1, tb2) = setup["jb"][0], setup["tb"][0]
    jal, tal = JAligner(setup["jal"].fm), TAligner(setup["tal"].fm,
                                                   device="cpu")
    for left in range(1000, 45000, 700):
        jal.ssdb.add_known(left, left + 61, "+")
        tal.ssdb.add_known(left, left + 61, "+")
    assert temit.submit_pe(tal, tb1, tb2)[0] == "legacy"
    jbuf, tbuf, plain = io.StringIO(), io.StringIO(), io.StringIO()
    jst = jemit.align_and_emit_pe(jal, jb1, jb2, _writer(jsam, ref, jbuf))
    tst = temit.align_and_emit_pe(tal, tb1, tb2, _writer(tsam, ref, tbuf))
    assert tst == jst
    assert tbuf.getvalue() == jbuf.getvalue()
    temit.align_and_emit_pe(setup["tal"], tb1, tb2, _writer(tsam, ref,
                                                            plain))
    tl = [abs(int(ln.split("\t")[8])) for ln in tbuf.getvalue().splitlines()]
    tl0 = [abs(int(ln.split("\t")[8])) for ln in plain.getvalue().splitlines()]
    assert len(tl) == len(tl0) and any(a < b for a, b in zip(tl, tl0))


@pytest.mark.parametrize("part", [0, 1], ids=["packed", "legacy"])
def test_fast_path_matches_align_pairs(setup, part):
    """The port's fast emit equals its own per-pair path (align_pairs +
    pairs_to_sam), the oracle tests/test_emit_pe.py uses for JAX."""
    tal, ref = setup["tal"], setup["ref"]
    b1, b2 = setup["tb"][part]
    fbuf, sbuf = io.StringIO(), io.StringIO()
    fst = temit.align_and_emit_pe(tal, b1, b2, _writer(tsam, ref, fbuf))
    res = tpaired.align_pairs(tal, b1, b2)
    sst = tpaired.pairs_to_sam(b1, b2, res, tal, _writer(tsam, ref, sbuf))
    assert fst == sst
    assert fbuf.getvalue() == sbuf.getvalue()
    assert {pr.kind for pr in res} >= {"concordant", "mixed", "unal"}


def test_wire_nmm_lanes_match_jax(tmp_path):
    """The packed step's wire codec carries a mate's mismatch counts in 3
    bits, so a concordant pair whose mate has 8 mismatches (Ns included)
    reaches the native fast path as 0 and is formatted with XM:i:0,
    NM:i:0, MD:Z:100, where the per-pair path reports 8. The port keeps
    the JAX package's bytes here too; the smallest input: one pair on a
    20 kb random genome, mate 2 with 8 Ns."""
    rng = np.random.default_rng(0)
    g = rng.integers(0, 4, 20000).astype(np.uint8)
    jfm = build_fm_index(reference_from_seqs({"chr1": jalphabet.decode(g)}))
    jfm.save(str(tmp_path / "w"))
    tfm = FMIndex.load(str(tmp_path / "w"))
    r1 = g[1000:1100].copy()
    r2 = jalphabet.revcomp(g[1300:1400])
    r2[5:85:10] = 4
    pairs, quals = [("p0", r1, r2)], [(np.full(RDLEN, 40, np.int8),) * 2]
    jbuf, tbuf = io.StringIO(), io.StringIO()
    jemit.align_and_emit_pe(JAligner(jfm),
                            *_batches(JRead, jbatchify, pairs, quals),
                            _writer(jsam, jfm.ref, jbuf))
    tb1, tb2 = _batches(TRead, tbatchify, pairs, quals)
    tal = TAligner(tfm, device="cpu")
    temit.align_and_emit_pe(tal, tb1, tb2, _writer(tsam, jfm.ref, tbuf))
    assert tbuf.getvalue() == jbuf.getvalue()
    assert "\tXM:i:0\t" in tbuf.getvalue().splitlines()[1]
    sbuf = io.StringIO()
    tpaired.pairs_to_sam(tb1, tb2, tpaired.align_pairs(tal, tb1, tb2), tal,
                         _writer(tsam, jfm.ref, sbuf))
    assert "\tXM:i:8\t" in sbuf.getvalue().splitlines()[1]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the PE path on the card needs one")


@pytest.mark.gpu
@pytest.mark.parametrize("constant", [True, False],
                         ids=["packed", "legacy"])
def test_pe_sam_on_card_equals_cpu(constant):
    """512 pairs through each PE path on the card and on the CPU:
    identical SAM bytes, and the rescue's wide kernel ran on the card."""
    _need_card()
    from hisat2_tpu_torch.index.fm_index import build_fm_index as tbuild
    from hisat2_tpu_torch.io.reference import reference_from_seqs as tref
    rng = np.random.default_rng(31 if constant else 32)
    g = _genome(rng)
    fm = tbuild(tref(g))
    na = int(fm.ref.frag_joined[-1])
    pairs = _pairs(fm.ref.joined, na, rng, 512)
    quals = ([(np.full(RDLEN, 40, np.int8),) * 2] * 512 if constant else
             [(rng.integers(2, 42, RDLEN).astype(np.int8),
               rng.integers(2, 42, RDLEN).astype(np.int8))
              for _ in range(512)])
    batches = [_batches(TRead, tbatchify, pairs[k:k + 256],
                        quals[k:k + 256]) for k in (0, 256)]

    def sam(device):
        buf = io.StringIO()
        temit.align_and_emit_pe_stream(TAligner(fm, device=device), batches,
                                       _writer(tsam, fm.ref, buf))
        return buf.getvalue()
    before = dict(dp_cuda.launches)
    on_card = sam("cuda")
    assert dp_cuda.launches["dp_score"] > before["dp_score"]
    assert dp_cuda.launches["dp_score_wide"] > before["dp_score_wide"]
    assert on_card == sam("cpu")
