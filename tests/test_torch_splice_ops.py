"""The spliced slice's host pieces and device ops, the port against the
JAX package, exact.

Host (numpy): align/splice_model, align/splice_db.SpliceSiteDB,
ops/splice_host (the numpy junction scorer, its gates, the native
juncscore.cpp scorer, dp_score_host). Device ops (ops/splice, plain
PyTorch on the CPU against JAX on XLA's CPU): the float32 intron-length
penalty at every intron length from 20 to 500,000, the splice-signal
probscore and the acceptance gates at and around each threshold from 0.8
to 0.99, junction_score, _gate_pack, the intron-length limits,
_gather_oriented, junction_score_packed_rows, rescue_fused, _lane_enum,
anchor_scan (one tile and eight, where rows reach past the first), and
spliced_stage through the packed step's RNA extras. On the genome of
tests/test_splice_host.py (40 kb, five canonical introns).

One float is not bit for bit: inside the jitted junction_score, XLA
evaluates the 24-term float32 splice-signal sum in an order of its own
(the same expression jitted alone gives the port's bits), so the
probscore that junction_score returns may differ from the JAX one by a
few float32 steps; it is held to 2e-7 at 0.5 and above (every threshold)
and to 1e-5 relative below, and the gates it feeds are compared exactly
on both sides of every threshold."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_native_cache  # noqa: F401  (JAX native libs, built once under a lock)
from hisat2_tpu.align import pipeline as jpipe
from hisat2_tpu.align import splice_model as jsm
from hisat2_tpu.align.pipeline import Aligner as JAligner
from hisat2_tpu.align.pipeline import AlignerOpts as JOpts
from hisat2_tpu.align.scoring import DEFAULT_SCORING as JSC
from hisat2_tpu.align.splice_db import SpliceSiteDB as JDB
from hisat2_tpu.index.fm_index import build_fm_index
from hisat2_tpu.io.reads import Read as JRead, batchify as jbatchify
from hisat2_tpu.io.reference import reference_from_seqs
from hisat2_tpu.ops import splice as jsp
from hisat2_tpu.ops import splice_host as jsh
from hisat2_tpu.utils import alphabet as jalphabet

from hisat2_tpu_torch import native as tnative
from hisat2_tpu_torch.align import pipeline as tpipe
from hisat2_tpu_torch.align import splice_model as tsm
from hisat2_tpu_torch.align.pipeline import Aligner as TAligner
from hisat2_tpu_torch.align.pipeline import AlignerOpts as TOpts
from hisat2_tpu_torch.align.scoring import DEFAULT_SCORING as TSC
from hisat2_tpu_torch.align.splice_db import SpliceSiteDB as TDB
from hisat2_tpu_torch.index.fm_index import FMIndex
from hisat2_tpu_torch.io.reads import Read as TRead, batchify as tbatchify
from hisat2_tpu_torch.ops import splice as tsp
from hisat2_tpu_torch.ops import splice_host as tsh

torch.set_num_threads(1)

INTRONS = ((2000, 300), (5000, 800), (9000, 2500), (15000, 120),
           (21000, 5000))


def T(a, dtype=torch.int32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def J(a, dtype=jnp.int32):
    return jnp.asarray(np.ascontiguousarray(a), dtype)


def eq(a, b):
    """Exact equality of a JAX and a torch array (or nested dicts; a
    junction_score dict's probscore within a few float32 steps)."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            (close_probscore if k == "probscore" else eq)(a[k], b[k])
        return
    a = np.asarray(a)
    b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype.kind == "f":
        assert (a.view(np.int32 if a.itemsize == 4 else np.int64)
                == b.astype(a.dtype).view(
                    np.int32 if a.itemsize == 4 else np.int64)).all()
    else:
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64))


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(77)
    g = np.asarray(rng.integers(0, 4, 40000), np.uint8)
    for start, ilen in INTRONS:
        g[start:start + 2] = [2, 3]
        g[start + ilen - 2:start + ilen] = [0, 2]
    ref = reference_from_seqs({"chrH": jalphabet.decode(g)})
    jfm = build_fm_index(ref, ftab_k=6)
    ja = JAligner(jfm, opts=JOpts(spliced=True))
    ta = TAligner(FMIndex.from_object(jfm), opts=TOpts(spliced=True),
                  device="cpu")
    ks = sorted((s - 1, s + l) for s, l in INTRONS[:2])
    for a in (ja, ta):
        for left, right in ks:
            a.ssdb.add_known(left, right, "+")
    return dict(g=g, jfm=jfm, ja=ja, ta=ta,
                kl=np.asarray([k[0] for k in ks], np.int64),
                kr=np.asarray([k[1] for k in ks], np.int64))


def close_probscore(a, b):
    a = np.asarray(a, np.float64)
    b = (b.numpy() if torch.is_tensor(b) else np.asarray(b)).astype(
        np.float64)
    assert a.shape == b.shape
    hi = a >= 0.5
    assert (np.abs(a - b)[hi] <= 2e-7).all()
    assert (np.abs(a - b)[~hi] <= 1e-5 * np.abs(a)[~hi] + 1e-30).all()


def lanes(g, rng, n=64, L=100):
    """tests/test_splice_host.py's lanes: half across real junctions with
    2% mismatches, half arbitrary diagonal pairs."""
    rd = np.zeros((n, L), np.int64)
    q = np.full((n, L), 40, np.int64)
    rdl = np.full(n, L, np.int64)
    pA = np.zeros(n, np.int64)
    pB = np.zeros(n, np.int64)
    for i in range(n):
        if i % 2 == 0:
            start, ilen = INTRONS[i % len(INTRONS)]
            j = int(rng.integers(10, L - 10))
            a = start - j
            seq = np.concatenate([g[a:start],
                                  g[start + ilen:start + ilen + (L - j)]])
            mm = rng.random(L) < 0.02
            seq = seq.copy()
            seq[mm] = (seq[mm] + 1) % 4
            rd[i] = seq
            pA[i] = a
            pB[i] = a + ilen
        else:
            p = int(rng.integers(100, 30000))
            rd[i] = g[p:p + L]
            pA[i] = p
            pB[i] = p + int(rng.integers(25, 4000))
    rdl[5] = 60                        # a shorter read
    q[7] = rng.integers(2, 41, L)      # per-base qualities
    rd[9, 40] = 4                      # an N
    return rd, q, rdl, pA, pB


def junction_reads(g, rng, n=96):
    """Reads across the planted junctions (anchors 5-95, some mismatches,
    half reverse-complemented) and contiguous ones."""
    out = []
    for k in range(n):
        if k % 4 == 3:
            p = int(rng.integers(0, g.size - 100))
            out.append(g[p:p + 100].copy())
            continue
        s, il = INTRONS[k % len(INTRONS)]
        left = int(rng.integers(5, 96))
        seq = np.concatenate([g[s - left:s], g[s + il:s + il + 100 - left]])
        if k % 3 == 0:
            seq[rng.integers(0, 100)] ^= 1
        out.append(jalphabet.revcomp(seq) if k % 2 else seq)
    return out


def batches(seqs):
    q = np.full(100, 40, np.int8)
    return (jbatchify([JRead(f"r{i}", s, q, i) for i, s in enumerate(seqs)],
                      pad_to=104),
            tbatchify([TRead(f"r{i}", s, q, i) for i, s in enumerate(seqs)],
                      pad_to=104))


# ---------------------------------------------------------------------------
# host pieces
# ---------------------------------------------------------------------------

def test_splice_model():
    rng = np.random.default_rng(1)
    d = rng.integers(0, 5, (4096, 9))
    a = rng.integers(0, 5, (4096, 15))
    eq(jsm.probscore_np(d, a), tsm.probscore_np(d, a))
    il = np.concatenate([np.arange(0, 300000, 97), [4095, 4096, 8191, 8192,
                                                    16384, 32768, 65535,
                                                    65536, 1 << 20]])
    eq(jsm.probscore_thresh(il), tsm.probscore_thresh(il))
    anchors = np.arange(-3, 60)
    for m in (1, 7, 14):
        eq(jsm.max_intron_len(anchors, m), tsm.max_intron_len(anchors, m))
        eq(jsm.max_intron_len_noncan(anchors, m),
           tsm.max_intron_len_noncan(anchors, m))
    eq(jsm.DONOR_LOGODDS, tsm.DONOR_LOGODDS)
    eq(jsm.ACCEPTOR_LOGODDS, tsm.ACCEPTOR_LOGODDS)


def test_splice_site_db():
    jd, td = JDB(), TDB()
    rng = np.random.default_rng(2)
    ops = [("k", int(a), int(a) + int(b), "+-."[int(c)]) for a, b, c in zip(
        rng.integers(0, 90000, 40), rng.integers(20, 5000, 40),
        rng.integers(0, 3, 40))]
    ops += [("n", l_, r_, s) for _, l_, r_, s in ops[::5]]   # already known
    ops += [("n", int(a), int(a) + 300, "+") for a in
            rng.integers(0, 90000, 30)]
    ops += ops[-10:]                                        # repeats
    v = []
    for kind, left, right, strand in ops:
        for db in (jd, td):
            (db.add_known if kind == "k" else db.add_novel)(left, right,
                                                            strand)
        v.append(jd.version())
        assert td.version() == jd.version()
    assert (td.known, td.novel, td.strands) == (jd.known, jd.novel,
                                                jd.strands)
    assert len(td) == len(jd)
    for ver in (0, v[10], v[45], v[-1]):
        eq(jd.added_since(ver), td.added_since(ver))
    for x, y in zip(jd.lefts_rights() + jd.rights_sorted(),
                    td.lefts_rights() + td.rights_sorted()):
        eq(x, y)
    for left, right in list(jd.known)[:5] + list(jd.novel)[:5] + [(1, 2)]:
        assert td.is_baked(left, right) == jd.is_baked(left, right)
    for x, y in zip(jd.device_arrays4(), td.device_arrays4("cpu")):
        eq(x, y)
    for x, y in zip(jd.device_arrays(), td.device_arrays("cpu")):
        eq(x, y)


@pytest.mark.parametrize("with_ov", [False, True])
def test_host_scorers(world, with_ov):
    g = world["g"]
    rng = np.random.default_rng(3)
    rd, q, rdl, pA, pB = lanes(g, rng)
    kl, kr = world["kl"], world["kr"]
    ov = (rng.choice(np.array([0, 0, 0, 1, 2, 3, 4, 15]), g.size)
          .astype(np.uint8) if with_ov else None)
    joined = g.astype(np.int64)
    rj = jsh.junction_score_host(joined, JSC, rd, q, rdl, pA, pB, kl, kr,
                                 overlay=ov)
    rt = tsh.junction_score_host(joined, TSC, rd, q, rdl, pA, pB, kl, kr,
                                 overlay=ov)
    eq(rj, rt)
    for mi, dta in ((500000, False), (4096, True)):
        eq(jsh.gate_pack_host(rj, JSC, rdl, pA, pB, mi, dta),
           tsh.gate_pack_host(rt, TSC, rdl, pA, pB, mi, dta))
        rjn, pjn = jsh.junction_score_gate(g, JSC, rd, q, rdl, pA, pB, kl,
                                           kr, ov, mi, dta)
        rtn, ptn = tsh.junction_score_gate(g, TSC, rd, q, rdl, pA, pB, kl,
                                           kr, ov, mi, dta)
        eq(rjn, rtn)
        eq(pjn, ptn)
    win = np.stack([g[p - 16:p + 120] for p in pA.clip(16)])
    eq(jsh.dp_score_host(JSC, rd, q, rdl, win),
       tsh.dp_score_host(TSC, rd, q, rdl, win))


def test_juncscore_library_loads():
    lib = tnative.juncscore_lib()
    assert hasattr(lib, "junc_score_batch")
    assert tnative.juncscore_lib() is lib


# ---------------------------------------------------------------------------
# device ops
# ---------------------------------------------------------------------------

def test_intron_len_pen_every_length():
    """-8 + ln(len) in float32, truncated: every length from 20 to
    500,000, so every point where the value crosses an integer (e^9 ..
    e^13 and their neighbours), plus lengths below 1."""
    d = np.concatenate([np.arange(-5, 2), np.arange(20, 500001)])
    eq(jsp._intron_len_pen(J(d)), tsp._intron_len_pen(T(d)))
    crossings = [int(np.ceil(np.exp(8 + k))) for k in range(1, 6)]
    pen = tsp._intron_len_pen(T(d)).numpy()
    for c in crossings:
        i = int(np.searchsorted(d, c))
        assert pen[i - 5:i + 5].max() > pen[i - 5:i + 5].min()


def _probscore_jax(dwin, awin):
    """The JAX package's probscore expression (ops/splice.py:200-204)."""
    dlo = jnp.asarray(jsm.DONOR_LOGODDS)
    alo = jnp.asarray(jsm.ACCEPTOR_LOGODDS)
    s = jnp.zeros((dwin.shape[0],), jnp.float32)
    for b in range(4):
        s = s + jnp.where(dwin == b, dlo[b][None, :], 0.0).sum(1)
        s = s + jnp.where(awin == b, alo[b][None, :], 0.0).sum(1)
    return 1.0 / (1.0 + jnp.exp(-s))


THRESH = (0.8, 0.88, 0.91, 0.94, 0.97, 0.99)


def test_probscore_and_gates_at_thresholds():
    """The probscore of 2^20 random donor/acceptor windows, bit for bit,
    the windows within 1e-6 of each threshold among them; then the gates
    on probscores at each threshold and 1-3 float32 steps either side,
    for intron lengths in each threshold's tier."""
    rng = np.random.default_rng(4)
    n = 1 << 18
    dw = rng.integers(0, 4, (n, 9))
    aw = rng.integers(0, 4, (n, 15))
    # windows whose probscore lies within 1e-6 of each threshold, met in
    # the middle: 4,096 donors drawn from the donor model against the
    # 65,536 acceptors that end in its 7-base consensus, the pairs whose
    # float64 score is nearest each threshold's logit
    dl = jsm.DONOR_LOGODDS.astype(np.float64)
    al = jsm.ACCEPTOR_LOGODDS.astype(np.float64)
    cdf = np.cumsum(jsm.DONOR_PWM / jsm.DONOR_PWM.sum(0), axis=0)
    donors = (rng.random((4096, 9, 1)) > cdf.T[None]).sum(2).clip(0, 3)
    s_d = dl[donors, np.arange(9)].sum(1)
    head = (np.arange(1 << 16)[:, None] >> (2 * np.arange(8))) & 3
    tail = jsm.ACCEPTOR_PWM[:, 8:].argmax(0)       # the consensus AG end
    acc = np.concatenate([head, np.broadcast_to(tail, (1 << 16, 7))], 1)
    s_a = al[acc, np.arange(15)].sum(1)
    order = np.argsort(s_a)
    near_d, near_a = [], []
    for t in THRESH:
        want = np.log(t / (1 - t)) - s_d
        k = np.clip(np.searchsorted(s_a[order], want), 1, s_a.size - 1)
        k = np.where(np.abs(s_a[order][k - 1] - want)
                     < np.abs(s_a[order][k] - want), k - 1, k)
        best = np.argsort(np.abs(s_a[order][k] - want))[:16]
        near_d.append(donors[best])
        near_a.append(acc[order[k[best]]])
    dw = np.concatenate([dw] + near_d).astype(np.int32)
    aw = np.concatenate([aw] + near_a).astype(np.int32)
    pj = np.asarray(jax.jit(_probscore_jax)(J(dw), J(aw)))
    pt = tsp._probscore(T(dw), T(aw)).numpy()
    eq(pj, pt)
    near = {t: int((np.abs(pt.astype(np.float64) - t) < 1e-6).sum())
            for t in THRESH}
    assert min(near.values()) >= 1, near
    # gates: probscore values on the threshold and around it
    lens_tier = (3000, 6000, 12000, 20000, 40000, 100000)
    vals, deltas = [], []
    for t, il in zip(THRESH, lens_tier):
        x = np.float32(t)
        for k in range(-3, 4):
            v = x
            for _ in range(abs(k)):
                v = np.nextafter(v, np.float32(2 if k > 0 else 0))
            vals.append(v)
            deltas.append(il)
    C = len(vals)
    # an 11 bp anchor: lim_c = 2^18 covers every delta and lies below
    # max_intron, so the probscore gate applies
    r = dict(score=np.zeros(C, np.int32), j=np.full(C, 11, np.int32),
             strand=np.ones(C, np.int32), canon=np.full(C, 2, np.int32),
             mmL=np.zeros(C, np.int32), mmR=np.zeros(C, np.int32),
             probscore=np.asarray(vals, np.float32))
    rdl = np.full(C, 100)
    pA = np.full(C, 1000)
    pB = pA + np.asarray(deltas)
    for mi in (500000, 1 << 20):
        pj = jsp._gate_pack({k: J(v, v.dtype) for k, v in r.items()},
                            J(rdl), J(pA), J(pB), jnp.float32(0.0),
                            jnp.float32(-0.2), jnp.int32(mi), False)
        ptt = tsp._gate_pack({k: torch.from_numpy(v) for k, v in r.items()},
                             T(rdl), T(pA), T(pB), 0.0, -0.2, mi, False)
        eq(pj, ptt)
        acc = (np.asarray(pj)[:, 2] >> 4) & 1
        assert 0 < acc.sum() < C      # both sides of the thresholds


def test_intron_limits_dev():
    a = np.arange(-3, 40)
    for m in (1, 7, 14):
        eq(jsp._max_intron_len_dev(J(a), m), tsp._max_intron_len_dev(T(a), m))
    eq(jsp._max_intron_len_noncan_dev(J(a)),
       tsp._max_intron_len_noncan_dev(T(a)))
    il = np.concatenate([np.arange(0, 200000, 37), [4095, 4096, 65536]])
    eq(jsp._probscore_thresh_dev(J(il)), tsp._probscore_thresh_dev(T(il)))


def test_junction_score_and_gates(world):
    ja, ta = world["ja"], world["ta"]
    rng = np.random.default_rng(5)
    rd, q, rdl, pA, pB = lanes(world["g"], rng, n=128)
    pB[3] = pA[3] + 10                 # a delta below the minimum intron
    jk, tk = ja.ssdb.device_arrays(), ta.ssdb.device_arrays("cpu")
    rj = jsp.junction_score(ja.idx, ja.sctab, J(rd), J(q), J(rdl), J(pA),
                            J(pB), *jk)
    rt = tsp.junction_score(ta.idx, ta.sctab, T(rd), T(q), T(rdl), T(pA),
                            T(pB), *tk)
    eq(rj, rt)
    for mi, dta in ((500000, False), (2048, True)):
        eq(jsp._gate_pack(rj, J(rdl), J(pA), J(pB), jnp.float32(0.0),
                          jnp.float32(-0.2), jnp.int32(mi), dta),
           tsp._gate_pack(rt, T(rdl), T(pA), T(pB), 0.0, -0.2, mi, dta))
    # no known sites
    e = jnp.zeros(0, jnp.int32)
    eq(jsp.junction_score(ja.idx, ja.sctab, J(rd), J(q), J(rdl), J(pA),
                          J(pB), e, e),
       tsp.junction_score(ta.idx, ta.sctab, T(rd), T(q), T(rdl), T(pA),
                          T(pB), T(np.zeros(0)), T(np.zeros(0))))


@pytest.fixture(scope="module")
def oriented(world):
    """The batch of junction_reads in both packages, and its device-
    resident oriented reads (_stage_oriented)."""
    seqs = junction_reads(world["g"], np.random.default_rng(6))
    jb, tb = batches(seqs)
    jo = world["ja"]._dev_oriented(jb)
    to = world["ta"]._dev_oriented(tb)
    return jb, tb, jo, to


def test_stage_oriented_and_gather(world, oriented):
    _, _, jo, to = oriented
    for x, y in zip(jo, to):
        eq(x, y)
    rng = np.random.default_rng(7)
    B = jo[0].shape[0] // 2
    rows = rng.integers(0, B, 200)
    lfw = rng.random(200) < 0.5
    for x, y in zip(jsp._gather_oriented(*jo, J(rows), J(lfw, bool)),
                    tsp._gather_oriented(*to, T(rows),
                                         T(lfw, torch.bool))):
        eq(x, y)


def test_junction_score_packed_rows(world, oriented):
    ja, ta = world["ja"], world["ta"]
    _, _, jo, to = oriented
    rng = np.random.default_rng(8)
    B = jo[0].shape[0] // 2
    C = 256
    rows = rng.integers(0, B, C)
    lfw = rng.random(C) < 0.5
    start = rng.integers(0, 60, C)
    seglen = np.minimum(rng.integers(10, 100, C), 100 - start)
    pA = rng.integers(100, 30000, C)
    pB = pA + rng.integers(-50, 6000, C)
    jk, tk = ja.ssdb.device_arrays(), ta.ssdb.device_arrays("cpu")
    j = np.asarray(jsp.junction_score_packed_rows(
        ja.idx, ja.sctab, *jo, J(rows), J(lfw, bool), J(start), J(seglen),
        J(pA), J(pB), *jk))
    t = tsp.junction_score_packed_rows(
        ta.idx, ta.sctab, *to, T(rows), T(lfw, torch.bool), T(start),
        T(seglen), T(pA), T(pB), *tk).numpy()
    cols = [0, 1, 2, 3, 5, 6]                 # column 4: probscore bits
    eq(j[:, cols], t[:, cols])
    close_probscore(j[:, 4].view(np.float32), t[:, 4].view(np.float32))


def test_rescue_fused(world, oriented):
    """Seeded lanes across the planted junctions and off them, and scan
    rows on the reads' primary diagonals (tiles 1 and 8)."""
    ja, ta = world["ja"], world["ta"]
    jb, tb, jo, to = oriented
    jm = ja._merged_host(*ja._device_align(jb), len(jb))
    B = len(jb)
    rng = np.random.default_rng(9)
    PB, SBk = 512, 64
    rows = rng.integers(0, B, PB)
    lfw = jm["fw"][rows, 0]
    pA = jm["pos"][rows, 0].astype(np.int64)
    pB = pA + rng.integers(100, 6000, PB)
    srow = np.arange(SBk) % B
    sfw = jm["fw"][srow, 0]
    spos = jm["pos"][srow, 0]
    slive = np.arange(SBk) < 50
    jk, tk = ja.ssdb.device_arrays(), ta.ssdb.device_arrays("cpu")
    for tiles, dta in ((1, False), (8, True)):
        j = jsp.rescue_fused(
            ja.idx, ja.sctab, *jo, J(rows), J(lfw, bool), J(pA), J(pB),
            J(srow), J(sfw, bool), J(spos), J(slive, bool), *jk,
            jnp.float32(0.0), jnp.float32(-0.2), jnp.int32(500000),
            jnp.int32(20), jnp.int32(14), 32, dta=dta, tiles=tiles)
        t = tsp.rescue_fused(
            ta.idx, ta.sctab, *to, T(rows), T(lfw, torch.bool), T(pA),
            T(pB), T(srow), T(sfw, torch.bool), T(spos),
            T(slive, torch.bool), *tk, 0.0, -0.2, 500000, 20, 14, 32,
            dta=dta, tiles=tiles)
        for x, y in zip(j, t):
            eq(x, y)


@pytest.mark.parametrize("tiles", [1, 8])
def test_anchor_scan(world, tiles):
    """Far anchors after and before seeded diagonals: rows whose mate lies
    in the first 64 kb tile, rows that find nothing there (the genome is
    40 kb: an up scan from its start), N anchors, short reads."""
    ja, ta = world["ja"], world["ta"]
    g = world["g"]
    rng = np.random.default_rng(10 + tiles)
    S, L = 48, 100
    rd = np.zeros((S, L), np.int64)
    rdl = np.full(S, L)
    pos = np.zeros(S, np.int64)
    down = np.arange(S) % 2 == 0
    for i in range(S):
        s, il = INTRONS[i % len(INTRONS)]
        far = int(rng.integers(8, 20))
        if down[i]:
            seq = np.concatenate([g[s - (L - far):s], g[s + il:s + il + far]])
            pos[i] = s - (L - far)
        else:
            seq = np.concatenate([g[s - far:s], g[s + il:s + il + L - far]])
            pos[i] = s + il - far
        rd[i] = seq
    rd[5, -3] = 4
    rdl[7] = 12
    pos[9] = 10                        # an up scan off the genome's start
    live = np.arange(S) != 11
    j = jsp.anchor_scan(ja.idx, J(rd), J(rdl), J(pos), J(down, bool),
                        jnp.int32(20), tiles=tiles, live=J(live, bool))
    t = tsp.anchor_scan(ta.idx, T(rd), T(rdl), T(pos), T(down, torch.bool),
                        20, tiles=tiles, live=T(live, torch.bool))
    eq(j, t)
    assert (np.asarray(j)[:, :, 1] > 0).sum() >= S // 2


def test_lane_enum(world, oriented):
    ja, ta = world["ja"], world["ta"]
    jb, _, _, _ = oriented
    st, dp = ja._device_align(jb)
    B = len(jb)
    K2 = min(2 * st["pos"].shape[1], max(8, ja.opts.khits + 3))
    mg = np.asarray(jpipe._stage_merge(st["pos"], st["score"], dp, B, K2))
    lens = np.asarray(jb.lens)
    jk = ja.ssdb.device_arrays4()
    tk = ta.ssdb.device_arrays4("cpu")
    for PJ, mi in ((8, 500000), (4, 1000)):
        eq(jsp._lane_enum(J(mg), J(lens), *jk, jnp.int32(20),
                          jnp.int32(mi), PJ),
           tsp._lane_enum(T(mg), T(lens), *tk, 20, mi, PJ))


@pytest.mark.parametrize("known,dta", [(True, False), (False, True)])
def test_spliced_stage_through_packed_step(world, known, dta):
    """The packed step in RNA mode (spliced_stage inside it: lane
    enumeration, junction scoring and gates, the anchor scan over eight
    tiles, the second pass): every extra it ships, and the fastpack."""
    seqs = junction_reads(world["g"], np.random.default_rng(12), n=128)
    jb, tb = batches(seqs)
    ja = JAligner(world["jfm"], opts=JOpts(spliced=True, dta=dta))
    ta = TAligner(world["ta"].fm, opts=TOpts(spliced=True, dta=dta),
                  device="cpu")
    if known:
        for a in (ja, ta):
            for s, il in INTRONS:
                a.ssdb.add_known(s - 1, s + il, "+")
    jfp, jmerged, jex = ja.device_align_fast(jb)
    tfp, tmerged, tex, _ = ta.device_align_fast(tb)
    eq(jfp, tfp)
    eq(jmerged, tmerged)
    assert sorted(jex) == sorted(tex)
    assert "splanes16" in tex and tex["spl_ssv"] == jex["spl_ssv"]
    for k in jex:
        if k != "spl_ssv":
            eq(jex[k], tex[k])
