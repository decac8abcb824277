"""The port's single-end DNA path against the JAX package's, end to end.

One index, built by hisat2_tpu and loaded by the port, over a
two-chromosome 46 kb genome with a planted 300 bp repeat (three copies)
and an N run. Reads carry mismatches, Ns, 1-3 bp indels, reverse
complements, multi-mapping from the repeat, placements across the
chromosome boundary, short lengths and random sequence. The device step
(_stage_align_packed, reached through Aligner.device_align_fast) must give
equal fastpack, merged grid and extras; align_and_emit_stream must give
identical SAM bytes. Inputs come from a numpy seed; equality is exact."""

import io

import numpy as np
import pytest
import torch

import test_torch_native_cache  # noqa: F401  (JAX native libs, built once under a lock)
from hisat2_tpu.align import emit as jemit
from hisat2_tpu.align.pipeline import Aligner as JAligner
from hisat2_tpu.index.fm_index import build_fm_index
from hisat2_tpu.io import sam as jsam
from hisat2_tpu.io.reads import Read as JRead, batchify as jbatchify
from hisat2_tpu.io.reference import reference_from_seqs
from hisat2_tpu.utils import alphabet as jalphabet

from hisat2_tpu_torch.align import emit as temit
from hisat2_tpu_torch.align.pipeline import Aligner as TAligner
from hisat2_tpu_torch.index.fm_index import FMIndex
from hisat2_tpu_torch.io import sam as tsam
from hisat2_tpu_torch.io.reads import Read as TRead, batchify as tbatchify
from hisat2_tpu_torch.ops import dp_cuda

torch.set_num_threads(1)

RDLEN = 100


def _genome(rng):
    a = rng.integers(0, 4, 26000).astype(np.uint8)
    b = rng.integers(0, 4, 20000).astype(np.uint8)
    rep = rng.integers(0, 4, 300).astype(np.uint8)
    a[3000:3300] = rep
    a[17000:17300] = rep
    b[6000:6300] = rep
    sa, sb = jalphabet.decode(a), jalphabet.decode(b)
    sa = sa[:9000] + "N" * 40 + sa[9040:]
    return {"chrA": sa, "chrB": sb}


def _reads(joined, na, rng, n):
    """(name, codes, quals) triples; `na` is where chrB starts in the
    joined text (chromosome boundary)."""
    out = []
    kinds = ["exact", "mm", "mm", "n", "del", "ins", "repeat", "boundary",
             "short", "random", "mm"]
    for i in range(n):
        kind = kinds[i % len(kinds)]
        ln = RDLEN if kind != "short" else int(rng.integers(20, 90))
        if kind == "repeat":
            s = int(rng.choice([3000, 17000])) + int(rng.integers(0, 200))
        elif kind == "boundary":
            s = na - int(rng.integers(10, 90))
        else:
            s = int(rng.integers(0, joined.size - ln - 10))
        seq = joined[s:s + ln].astype(np.uint8).copy()
        if kind == "del":
            d = int(rng.integers(1, 4))
            p = int(rng.integers(20, 80))
            seq = np.concatenate([joined[s:s + p],
                                  joined[s + p + d:s + ln + d]]).astype(
                np.uint8)
        elif kind == "ins":
            d = int(rng.integers(1, 4))
            p = int(rng.integers(20, 80))
            seq = np.concatenate([seq[:p],
                                  rng.integers(0, 4, d).astype(np.uint8),
                                  seq[p:ln - d]])
        elif kind == "random":
            seq = rng.integers(0, 4, ln).astype(np.uint8)
        if kind in ("mm", "n", "del", "ins", "repeat"):
            m = rng.random(ln) < 0.02
            seq[m] = (seq[m] + rng.integers(1, 4, int(m.sum()))) % 4
        if kind == "n":
            seq[rng.random(ln) < 0.04] = 4
        if rng.random() < 0.5:
            seq = jalphabet.revcomp(seq)
        qual = rng.integers(2, 42, ln).astype(np.int8)
        out.append((f"r{i}_{kind}", seq, qual))
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rng = np.random.default_rng(2024)
    jfm = build_fm_index(reference_from_seqs(_genome(rng)))
    prefix = str(tmp_path_factory.mktemp("idx") / "pipe")
    jfm.save(prefix)
    tfm = FMIndex.load(prefix)
    na = int(jfm.ref.frag_joined[-1])          # chrB's first base
    assert jfm.ref.joined.size > 40000 and len(jfm.ref.names) == 2
    triples = _reads(jfm.ref.joined, na, rng, 448)
    # one batch with per-base qualities, one with a constant quality
    # (the packed upload then carries no qualities at all)
    parts = [triples[:256], [(n, s, np.full(s.size, 40, np.int8))
                             for n, s, _ in triples[256:]]]
    jb = [jbatchify([JRead(n, s, q, i) for i, (n, s, q) in enumerate(p)],
                    pad_to=104) for p in parts]
    tb = [tbatchify([TRead(n, s, q, i) for i, (n, s, q) in enumerate(p)],
                    pad_to=104) for p in parts]
    return (JAligner(jfm), TAligner(tfm, device="cpu"), jb, tb,
            jfm.ref)


def test_device_step_matches(setup):
    jal, tal, jb, tb, _ = setup
    for jbatch, tbatch in zip(jb, tb):
        jfp, jmerged, jex = jal.device_align_fast(jbatch)
        fp, merged, ex, ready = tal.device_align_fast(tbatch)
        assert ready is None
        assert fp.dtype == torch.int16
        np.testing.assert_array_equal(fp.numpy(), np.asarray(jfp))
        np.testing.assert_array_equal(merged.numpy(), np.asarray(jmerged))
        assert sorted(ex) == sorted(jex)
        for k in jex:
            np.testing.assert_array_equal(ex[k].numpy(), np.asarray(jex[k]),
                                          err_msg=k)
        # the batch exercises the gapped rescue and the int16 position wrap
        assert (merged[:, :, 2] & 2).any()
        assert int(merged[:, 0, 1].max()) > 32768


def test_sam_bytes_match(setup):
    jal, tal, jb, tb, ref = setup
    names = list(ref.names)
    tlens = [int(x) for x in ref.tlens]

    jbuf = io.StringIO()
    jst = jemit.align_and_emit_stream(
        jal, jb, jsam.SamWriter(jbuf, names, tlens, no_head=True))
    tbuf = io.StringIO()
    before = dp_cuda.launches["dp_score"]
    tst = temit.align_and_emit_stream(
        tal, tb, tsam.SamWriter(tbuf, names, tlens, no_head=True))
    # on the CPU the DP runs the plain version, never the kernel
    assert dp_cuda.launches["dp_score"] == before
    assert tst == jst
    jsam_text, tsam_text = jbuf.getvalue(), tbuf.getvalue()
    assert tsam_text == jsam_text
    lines = tsam_text.splitlines()
    # every read emitted, primaries in read order
    prim = [ln.split("\t")[0] for ln in lines
            if not int(ln.split("\t")[1]) & 256]
    assert prim == [n for b in tb for n in b.names]
    kinds = {ln.split("\t")[0].split("_")[1] for ln in lines
             if ln.split("\t")[5] not in ("*",)}
    assert {"del", "ins", "repeat", "mm", "n"} <= kinds
    assert any("D" in ln.split("\t")[5] or "I" in ln.split("\t")[5]
               for ln in lines)
    assert any(int(ln.split("\t")[1]) & 256 for ln in lines)


def _bucket_case(ref, rng, n, indel_at):
    """n error-prone reads (1% mismatches, constant quality 40) and one
    read with a 2 bp deletion after 50 bases, at index `indel_at`; no read
    covers an N or the chromosome boundary. Also returns how many reads
    carry two or more mismatches."""
    joined = ref.joined
    na = int(ref.frag_joined[-1])
    seqs, n_two = [], 0
    while len(seqs) < n:
        s = int(rng.integers(0, joined.size - 110))
        win = joined[s:s + 102]
        if (win > 3).any() or s < na < s + 102:
            continue
        seq = win[:RDLEN].astype(np.uint8).copy()
        m = rng.random(RDLEN) < 0.01
        seq[m] = (seq[m] + rng.integers(1, 4, int(m.sum()))) % 4
        n_two += len(seqs) > 0 and int(m.sum()) >= 2
        seqs.append(seq)
        if len(seqs) == 1:
            deleted = np.concatenate([win[:50], win[52:102]]).astype(
                np.uint8)
    order = seqs[1:]
    order.insert(indel_at, deleted)
    q = np.full(RDLEN, 40, np.int8)
    names = [f"b{i}" for i in range(n)]
    return (jbatchify([JRead(names[i], s, q, i) for i, s in
                       enumerate(order)], pad_to=104),
            tbatchify([TRead(names[i], s, q, i) for i, s in
                       enumerate(order)], pad_to=104), n_two)


def test_dp_bucket_drops_the_last_indel_read(setup):
    """ROADMAP Queue C 5, both packages: the packed step's DP bucket holds
    max(32, B / 8) reads and admits every read whose best ungapped score
    one gap could beat (two mismatches are enough), so at 1% mismatches it
    fills before the end of a 256-read batch and drops the highest-index
    reads. The indel read at index 255 comes out unaligned; at index 0 it
    takes the bucket's first slot and aligns with its deletion. The bytes are
    the JAX package's in both orders."""
    jal, tal, _, _, ref = setup
    names = list(ref.names)
    tlens = [int(x) for x in ref.tlens]
    cigars = {}
    for at in (255, 0):
        jb, tb, n_two = _bucket_case(ref, np.random.default_rng(55), 256,
                                     at)
        # more reads with two or more mismatches than the bucket holds
        assert n_two > max(32, 256 // 8)
        jbuf, tbuf = io.StringIO(), io.StringIO()
        jst = jemit.align_and_emit_stream(
            jal, [jb], jsam.SamWriter(jbuf, names, tlens, no_head=True))
        tst = temit.align_and_emit_stream(
            tal, [tb], tsam.SamWriter(tbuf, names, tlens, no_head=True))
        assert tbuf.getvalue() == jbuf.getvalue()
        assert tst == jst
        rec = [ln.split("\t") for ln in tbuf.getvalue().splitlines()
               if ln.startswith(f"b{at}\t") and not int(ln.split("\t")[1])
               & 256]
        cigars[at] = rec[0][5]
    assert cigars[255] == "*"
    assert cigars[0] == "50M2D50M"
