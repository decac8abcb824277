"""Spliced (RNA) paired-end alignment, the port against the JAX package as
a whole: SAM bytes, stats and the published novel sites must be equal.

The genome is tests/test_sharded_rna.py's (two 50 kb chromosomes, GT..AG
introns of 400 and 1,500 bp on each), with a two-intron chain planted at
42 kb on the first (a 45 bp middle exon). The first two cases are the
single-index sides of that file's PE tests: its 32 junction pairs through
align_and_emit_pe, and its --tmo pairs (junction and exonic) with known
sites through align_pairs + pairs_to_sam. The others run a mixed set of 64
pairs (junction mates on either side, swapped mates, exonic pairs,
two-intron mates, mates of random sequence and mates with an N every 8
bases, which only the mate rescue places, pairs with both mates over one
junction) through align_and_emit_pe_stream in two batches of 32, so the
second batch sees the sites the first published, without and with known
sites and per-base qualities; --tmo through align_and_emit_pe (the
per-pair ladder); RF orientation with no_temp_splicesite. FM seeding,
seed_mode=False and a graph index are in
tests/test_torch_paired_rna_indexes.py."""

import io

import numpy as np
import pytest
import torch

from test_torch_graph_pipeline import strip_table
import test_torch_native_cache  # noqa: F401  (JAX native libs, built once under a lock)
from hisat2_tpu.align import emit as jemit
from hisat2_tpu.align import paired as jpaired
from hisat2_tpu.align.pipeline import Aligner as JAligner
from hisat2_tpu.align.pipeline import AlignerOpts as JOpts
from hisat2_tpu.index.fm_index import build_fm_index
from hisat2_tpu.io import sam as jsam
from hisat2_tpu.io.reads import Read as JRead, batchify as jbatchify
from hisat2_tpu.io.reference import reference_from_seqs
from hisat2_tpu.utils import alphabet as jalphabet

from hisat2_tpu_torch.align import emit as temit
from hisat2_tpu_torch.align import paired as tpaired
from hisat2_tpu_torch.align.pipeline import Aligner as TAligner
from hisat2_tpu_torch.align.pipeline import AlignerOpts as TOpts
from hisat2_tpu_torch.index.fm_index import FMIndex
from hisat2_tpu_torch.io import sam as tsam
from hisat2_tpu_torch.io.reads import Read as TRead, batchify as tbatchify

torch.set_num_threads(1)

L = 100
PAIRS = 32                       # pairs per batch, every case
CHAIN = (41900, 42000, 42300, 42345, 42645)   # exon1, i1, exon2, i2, exon3


def sharded_genome():
    """tests/test_sharded_rna.py's genome, and the chain at 42 kb on c1."""
    rng = np.random.default_rng(31)
    g1 = np.asarray(rng.integers(0, 4, 50000), np.uint8)
    g2 = np.asarray(rng.integers(0, 4, 50000), np.uint8)
    introns = []
    for g, cb in ((g1, 0), (g2, 1)):
        for start, ilen in ((5000, 400), (20000, 1500)):
            g[start:start + 2] = [2, 3]
            g[start + ilen - 2:start + ilen] = [0, 2]
            introns.append((cb, start, ilen))
    _, i1, e2, i2, e3 = CHAIN
    for d, a in ((i1, e2), (i2, e3)):
        g1[d:d + 2] = [2, 3]
        g1[a - 2:a] = [0, 2]
    return (g1, g2), introns


def junction(g, start, ilen, j, n=L):
    """n bases over the intron [start, start + ilen): j of them before."""
    return np.concatenate([g[start - j:start],
                           g[start + ilen:start + ilen + (n - j)]])


def sharded_pe_pairs(gs, introns):
    """test_sharded_rna.py::test_sharded_rna_pe's pairs."""
    rng = np.random.default_rng(13)
    pairs = []
    for i in range(32):
        cb, start, ilen = introns[i % len(introns)]
        g = gs[cb]
        m1 = junction(g, start, ilen, int(rng.integers(15, L - 15)))
        m2s = start + ilen + 150
        pairs.append((f"q{i}", m1, jalphabet.revcomp(g[m2s:m2s + L])))
    return pairs


def sharded_tmo_pairs(gs, introns):
    """test_sharded_rna.py::test_sharded_tmo_matches_single's pairs."""
    rng = np.random.default_rng(19)
    pairs = []
    for i in range(24):
        cb, start, ilen = introns[i % len(introns)]
        g = gs[cb]
        m1 = junction(g, start, ilen, int(rng.integers(15, L - 15)))
        m2s = start + ilen + 150
        pairs.append((f"t{i}", m1, jalphabet.revcomp(g[m2s:m2s + L])))
    for i in range(24, 32):
        g = gs[i % 2]
        p0 = int(rng.integers(0, 40000))
        pairs.append((f"t{i}", g[p0:p0 + L].copy(),
                      jalphabet.revcomp(g[p0 + 250:p0 + 250 + L])))
    return pairs


def mixed_pairs(gs, introns):
    """64 FR pairs: junction mates (mate 1, mate 2 or both, some with a
    mismatch, every fifth pair swapped), exonic pairs, two-intron mates,
    and pairs whose mate 2 is random sequence or has an N every 8 bases
    (no seed; the mate rescue places it), and pairs
    with both mates over one junction; in a shuffled order."""
    rng = np.random.default_rng(71)
    e1, i1, e2, i2, e3 = CHAIN
    g1 = gs[0]
    tx = np.concatenate([g1[e1:i1], g1[e2:i2], g1[e3:e3 + 300]])
    pairs = []
    for k in range(30):
        cb, start, ilen = introns[k % len(introns)]
        g = gs[cb]
        j = int(rng.integers(8, L - 8))
        if k % 3 == 2:            # mate 2 over the junction, mate 1 upstream
            m2 = jalphabet.revcomp(junction(g, start, ilen, j))
            s1 = start - j - int(rng.integers(120, 260))
            m1 = g[s1:s1 + L].copy()
        else:
            m1 = junction(g, start, ilen, j)
            s2 = start + ilen + (L - j) + int(rng.integers(20, 200))
            m2 = jalphabet.revcomp(g[s2:s2 + L])
        if k % 4 == 1:
            m1[rng.integers(0, L)] ^= 1
        if k % 5 == 0:
            m1, m2 = m2, m1
        pairs.append((f"j{k}", m1, m2))
    for k in range(10):
        g = gs[k % 2]
        p0 = int(rng.integers(1000, 45000))
        frag = int(rng.integers(220, 420))
        pairs.append((f"e{k}", g[p0:p0 + L].copy(),
                      jalphabet.revcomp(g[p0 + frag - L:p0 + frag])))
    for k, off in enumerate(range(70, 81, 2)):     # anchors 20-30, 45, 25-35
        s2 = e3 + (off + 55) + 150
        pairs.append((f"c{k}", tx[off:off + L].copy(),
                      jalphabet.revcomp(g1[s2:s2 + L])))
    for k in range(12):
        g = gs[k % 2]
        p0 = int(rng.integers(1000, 45000))
        m1 = g[p0:p0 + L].copy()
        if k < 6:
            m2 = rng.integers(0, 4, L).astype(np.uint8)
        else:
            m2 = jalphabet.revcomp(g[p0 + 200:p0 + 200 + L])
            m2[3::8] = 4
        pairs.append((f"u{k}", m1, m2))
    assert len(pairs) == 58
    for k in range(6):                             # both mates spliced
        cb, start, ilen = introns[k % len(introns)]
        g = gs[cb]
        a = int(rng.integers(30, 70))
        m1 = junction(g, start, ilen, a + 40)
        m2 = jalphabet.revcomp(junction(g, start, ilen, a))
        pairs.append((f"b{k}", m1, m2))
    return [pairs[i] for i in rng.permutation(len(pairs))]


def to_batches(pairs, quals=None):
    """(JAX batches, port batches): lists of (mate-1, mate-2) batches of
    PAIRS pairs, padded to 104."""
    q40 = np.full(L, 40, np.int8)
    out = {"j": [], "t": []}
    for b0 in range(0, len(pairs), PAIRS):
        rows = range(b0, min(b0 + PAIRS, len(pairs)))
        for key, Read, batchify in (("j", JRead, jbatchify),
                                    ("t", TRead, tbatchify)):
            mates = []
            for m in (1, 2):
                mates.append(batchify(
                    [Read(pairs[i][0], pairs[i][m],
                          q40 if quals is None else quals[i, m - 1], i)
                     for i in rows], pad_to=104))
            out[key].append(tuple(mates))
    return out["j"], out["t"]


def sharded_world():
    """The genome indexed by the JAX package (`table`; `fm` is the same
    index without its k-mer table), its known sites and the pair sets."""
    gs, introns = sharded_genome()
    ref = reference_from_seqs({"c1": jalphabet.decode(gs[0]),
                               "c2": jalphabet.decode(gs[1])})
    jfm = build_fm_index(ref, ftab_k=6)
    sites = [(cb * 50000 + s - 1, cb * 50000 + s + il)
             for cb, s, il in introns]
    _, i1, e2, i2, e3 = CHAIN
    sites += [(i1 - 1, e2), (i2 - 1, e3)]
    mix = mixed_pairs(gs, introns)
    rng = np.random.default_rng(5)
    return dict(
        jfms={"table": jfm, "fm": strip_table(jfm)},
        refs={"table": ref, "fm": ref},
        sites={"table": sites, "fm": sites},
        sets={"sharded": to_batches(sharded_pe_pairs(gs, introns)),
              "tmo": to_batches(sharded_tmo_pairs(gs, introns)),
              "mix": to_batches(mix),
              "mix0": to_batches(mix[:PAIRS]),
              "rf": to_batches([(n, jalphabet.revcomp(a),
                                 jalphabet.revcomp(b))
                                for n, a, b in mix[:PAIRS]]),
              "perbase": to_batches(mix, rng.integers(
                  2, 42, (len(mix), 2, L)).astype(np.int8))})


@pytest.fixture(scope="module")
def world():
    return sharded_world()


def run(how, emit, paired, sammod, al, ref, batches):
    """SAM text and summed stats of `batches` through one entry point:
    the stream, align_and_emit_pe a batch at a time, or align_pairs +
    pairs_to_sam."""
    buf = io.StringIO()
    w = sammod.SamWriter(buf, list(ref.names), [int(x) for x in ref.tlens],
                         no_head=True)
    if how == "stream":
        st = emit.align_and_emit_pe_stream(al, batches, w)
    else:
        st = {}
        for b1, b2 in batches:
            if how == "pe":
                got = emit.align_and_emit_pe(al, b1, b2, w)
            else:
                got = paired.pairs_to_sam(
                    b1, b2, paired.align_pairs(al, b1, b2), al, w)
            for k, v in got.items():
                st[k] = st.get(k, 0) + v
    w.flush()
    return buf.getvalue(), st


def both(world, how, index, pairs, known, **opts):
    """SAM text and stats of both packages, each aligner its own (the
    novel sites one publishes must not reach the other)."""
    jal = JAligner(world["jfms"][index], opts=JOpts(spliced=True, **opts))
    tal = TAligner(FMIndex.from_object(world["jfms"][index]),
                   opts=TOpts(spliced=True, **opts), device="cpu")
    if known:
        for left, right in world["sites"][index]:
            jal.ssdb.add_known(left, right, "+")
            tal.ssdb.add_known(left, right, "+")
    jb, tb = world["sets"][pairs]
    ref = world["refs"][index]
    jt, js = run(how, jemit, jpaired, jsam, jal, ref, jb)
    tt, ts = run(how, temit, tpaired, tsam, tal, ref, tb)
    assert ts == js
    assert tt == jt
    assert tal.ssdb.novel == jal.ssdb.novel
    assert tal.ssdb.version() == jal.ssdb.version()
    recs = [ln.split("\t") for ln in tt.splitlines()]
    prim = [f for f in recs if not int(f[1]) & 256]
    npairs = sum(len(b1) for b1, _ in tb)
    assert len(prim) == 2 * npairs
    aligned = [f for f in prim if not int(f[1]) & 4]
    if opts.get("tmo"):
        # a pair reports only where both mates splice through known sites
        assert all("N" in f[5] for f in aligned)
    return prim, aligned, [f for f in aligned if "N" in f[5]]


CASES = [
    ("sharded_pe", "pe", "sharded", False, {}),
    ("sharded_tmo", "pairs", "tmo", True,
     dict(tmo=True, no_temp_splicesite=True)),
    ("stream", "stream", "mix", False, {}),
    ("stream_known_perbase", "stream", "perbase", True, {}),
    ("tmo_emit", "pe", "mix0", True, dict(tmo=True)),
    ("rf_no_temp_splicesite", "stream", "rf", False,
     dict(fr="rf", no_temp_splicesite=True)),
]


@pytest.mark.parametrize("name,how,pairs,known,opts", CASES,
                         ids=[c[0] for c in CASES])
def test_spliced_pe_sam_equals_jax(world, monkeypatch, name, how, pairs,
                                   known, opts):
    widths = []
    real = tpaired.dp_score

    def spy(rd, pen, rl, ref, scp_cum, **kw):
        widths.append(ref.shape[1])
        return real(rd, pen, rl, ref, scp_cum, **kw)
    monkeypatch.setattr(tpaired, "dp_score", spy)
    prim, aligned, spliced = both(world, how, "table", pairs, known, **opts)
    if name == "sharded_pe":
        assert len({f[0] for f in spliced}) >= 30
    elif name == "sharded_tmo":
        # exonic pairs come out unaligned
        assert all(int(f[1]) & 4 for f in prim if int(f[0][1:]) >= 24)
    elif name == "tmo_emit":
        assert aligned
    else:
        assert len(spliced) >= 20
    if pairs in ("mix", "perbase"):
        # two-intron mates chain both junctions (the ladder)
        assert any(f[5].count("N") == 2 for f in spliced)
        # mates with an N every 8 bases do not seed: the ladder's mate
        # rescue (the DP over the rescue window; dp_fill_plain on the
        # CPU) places them in concordant pairs
        W = tpaired.rescue_width(TOpts(), 104)
        assert W in widths and set(widths) == {W}
        assert any(f[0].startswith("u") and int(f[1]) & 2
                   and int(f[1]) & 128 for f in aligned)
