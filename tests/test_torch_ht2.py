"""The port's readers of reference-built `.ht2` index files against the
JAX package's, on the checked-in fixtures tests/golden/ht2fix/lin (a
linear index) and snp (a graph index with SNVs, a deletion, an insertion,
a phased pair, splice sites and exons): header fields, reference text, SA
sample, ALTs and haplotypes, the stored-BWT cross-check and the rebuilt
index, field by field; and FMIndex.load of either prefix aligns reads
drawn from g.fa to the same SAM bytes as the JAX package on that prefix."""

import io
import os

import numpy as np
import pytest
import torch

import test_torch_native_cache  # noqa: F401  (JAX native libs, built once under a lock)
from hisat2_tpu.align import emit as jemit
from hisat2_tpu.align.pipeline import Aligner as JAligner
from hisat2_tpu.index.fm_index import FMIndex as JFMIndex
from hisat2_tpu.io import ht2 as jht2
from hisat2_tpu.io import sam as jsam
from hisat2_tpu.io.reads import Read as JRead, batchify as jbatchify
from hisat2_tpu.utils import alphabet as jalphabet

from test_torch_graph_index import same_index, same_snps, FM_FIELDS
from hisat2_tpu_torch.align import emit as temit
from hisat2_tpu_torch.align.pipeline import Aligner as TAligner
from hisat2_tpu_torch.align.pipeline import AlignerOpts as TOpts
from hisat2_tpu_torch.index.fm_index import FMIndex
from hisat2_tpu_torch.index.graph_index import GraphFMIndex
from hisat2_tpu_torch.io import ht2 as tht2
from hisat2_tpu_torch.io import sam as tsam
from hisat2_tpu_torch.io.reads import Read as TRead, batchify as tbatchify

torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), "golden", "ht2fix")


def _same(a, b, what):
    if isinstance(b, np.ndarray):
        assert a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif isinstance(b, dict):
        assert sorted(a) == sorted(b), what
        for k in b:
            _same(a[k], b[k], f"{what}.{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    else:
        assert a == b, what


@pytest.mark.parametrize("name", ["lin", "snp"])
def test_header_offs_and_reference(name):
    prefix = os.path.join(FIX, name)
    th, jh = tht2.read_ht2_primary(prefix), jht2.read_ht2_primary(prefix)
    _same(th, jh, "header")
    assert th["linear"] == (name == "lin")
    assert th["names"] == ["chrA", "chrB"] and th["length"] == 10000
    _same(tht2.read_ht2_offs(prefix), jht2.read_ht2_offs(prefix), "offs")
    tr = tht2.read_ht2_reference(prefix, th["names"], th["plens"])
    jr = jht2.read_ht2_reference(prefix, jh["names"], jh["plens"])
    for f in ("joined", "tlens", "frag_joined", "frag_toff", "frag_tidx",
              "frag_len"):
        _same(getattr(tr, f), getattr(jr, f), f)
    assert list(tr.names) == list(jr.names)
    # and the text is g.fa's
    seqs, cur = {}, None
    with open(os.path.join(FIX, "g.fa")) as fh:
        for line in fh:
            if line.startswith(">"):
                cur = line[1:].strip()
                seqs[cur] = ""
            else:
                seqs[cur] += line.strip()
    want = np.concatenate([jalphabet.encode(v) for v in seqs.values()])
    np.testing.assert_array_equal(tr.joined, want)


def test_restore_text_from_the_stored_bwt():
    prefix = os.path.join(FIX, "lin")
    th, jh = tht2.read_ht2_primary(prefix), jht2.read_ht2_primary(prefix)
    for steps in (None, 500):
        got = tht2.restore_text(th, steps)
        np.testing.assert_array_equal(got, jht2.restore_text(jh, steps))
    ref = tht2.read_ht2_reference(prefix, th["names"], th["plens"])
    np.testing.assert_array_equal(tht2.restore_text(th), ref.joined)


def test_alts_and_annotations():
    prefix = os.path.join(FIX, "snp")
    traw, jraw = tht2.read_ht2_alts(prefix), jht2.read_ht2_alts(prefix)
    _same(traw, jraw, "alts")
    th = tht2.read_ht2_primary(prefix)
    tref = tht2.read_ht2_reference(prefix, th["names"], th["plens"])
    jref = jht2.read_ht2_reference(prefix, th["names"], th["plens"])
    t = tht2.alts_to_annotations(traw, tref)
    j = jht2.alts_to_annotations(jraw, jref)
    same_snps(t[0], j[0])
    for a, b, what in zip(t[1:4], j[1:4], ("ss", "exons", "ss_excl")):
        _same(a, b, what)
    assert t[4] == j[4] == [[0, 1]]
    assert t[0].jpos.tolist() == [500, 1200, 2500, 3300, 4000, 4500]
    assert t[0].types.tolist() == [0, 0, 0, 0, 1, 2]
    assert t[1].tolist() == [[7000, 7500, 1], [8200, 8900, -1]]
    # a linear index has an empty ALT file
    assert tht2.read_ht2_alts(os.path.join(FIX, "lin"))["alts"].size == 0


@pytest.mark.parametrize("name", ["lin", "snp"])
def test_load_ht2_rebuilds_the_same_index(name):
    prefix = os.path.join(FIX, name)
    t = FMIndex.load(prefix)               # no .meta.json: the .ht2 reader
    j = JFMIndex.load(prefix)
    assert not os.path.exists(prefix + ".meta.json")
    if name == "snp":
        assert isinstance(t, GraphFMIndex) and t.is_graph
        same_index(t, j)
        assert t.patch_start.size == 7     # six variants + the phased pair
        # splice sites and exons stay on the index; the DNA aligner
        # ignores them
        for f in ("known_ss", "known_exons"):
            _same(getattr(t, f), getattr(j, f), f)
        assert t.known_ss.shape == (2, 3) and t.excluded_ss is None
    else:
        assert not isinstance(t, GraphFMIndex)
        for f in FM_FIELDS:
            _same(getattr(t, f), getattr(j, f), f)
        assert t.known_ss is None
    assert t.st_k > 0 and t.n >= 10000     # the default seed table: table path
    np.testing.assert_array_equal(t.ref.joined, j.ref.joined)


def test_load_refuses_a_misparsed_bwt(tmp_path, monkeypatch):
    """The cross-check of the stored BWT against the text: a corrupted BWT
    must raise."""
    real = tht2.read_ht2_primary

    def corrupt(prefix):
        h = real(prefix)
        h["bwt"] = h["bwt"].copy()
        h["bwt"][-40:] = (h["bwt"][-40:] + 1) % 4
        return h
    monkeypatch.setattr(tht2, "read_ht2_primary", corrupt)
    with pytest.raises(ValueError, match="cross-check"):
        tht2.load_ht2(os.path.join(FIX, "lin"))


def test_load_without_any_index_files(tmp_path):
    with pytest.raises(FileNotFoundError):
        FMIndex.load(str(tmp_path / "nothing"))


def _reads(joined, mod_read, rng_seed=4):
    """80 and 100 bp reads drawn from g.fa's text: exact, with mismatches,
    reverse-complemented, carrying the ALT alleles of g.snp (the SNV at
    chrA:500, the 3 bp deletion at 4000, the ACGT insertion at 4500, the
    phased pair 500 + 1200 is too far apart for one read)."""
    rng = np.random.default_rng(rng_seed)
    out = []
    for i in range(96):
        ln = 100 if i % 3 else 80
        st = int(rng.integers(0, joined.size - ln))
        s = joined[st:st + ln].copy()
        if i % 4 == 1:
            m = rng.random(ln) < 0.02
            s[m] = (s[m] + rng.integers(1, 4, int(m.sum()))) % 4
        out.append(s)
    for p in (500, 1200, 2500, 3300):
        a = joined[p - 40:p + 60].copy()
        a[40] = {500: 0, 1200: 0, 2500: 0, 3300: 1}[p]     # g.snp's alleles
        out.append(a)
    out.append(np.concatenate([joined[3950:4000], joined[4003:4053]]))
    out.append(np.concatenate([joined[4450:4500], [0, 1, 2, 3],
                               joined[4500:4546]]).astype(np.uint8))
    out = [jalphabet.revcomp(s) if i % 2 else s for i, s in enumerate(out)]
    return [mod_read(f"h{i}", s, np.full(s.size, 40, np.int8), i)
            for i, s in enumerate(out)]


@pytest.mark.parametrize("name,opts", [("lin", {}), ("snp", {}),
                                       ("snp", dict(zs_tags=True)),
                                       ("snp", dict(seed_mode=False))],
                         ids=["lin", "snp", "snp-zs", "snp-per-read"])
def test_alignments_on_a_loaded_prefix_match_jax(name, opts):
    prefix = os.path.join(FIX, name)
    tfm, jfm = FMIndex.load(prefix), JFMIndex.load(prefix)
    from hisat2_tpu.align.pipeline import AlignerOpts as JOpts
    jal = JAligner(jfm, opts=JOpts(**opts))
    tal = TAligner(tfm, opts=TOpts(**opts), device="cpu")
    jb = [jbatchify(_reads(jfm.ref.joined, JRead), pad_to=104)]
    tb = [tbatchify(_reads(tfm.ref.joined, TRead), pad_to=104)]
    out = []
    for mod, sammod, al, b, ref in ((jemit, jsam, jal, jb, jfm.ref),
                                    (temit, tsam, tal, tb, tfm.ref)):
        buf = io.StringIO()
        st = mod.align_and_emit_stream(al, b, sammod.SamWriter(
            buf, list(ref.names), [int(x) for x in ref.tlens],
            no_head=True))
        out.append((buf.getvalue(), st))
    (jtext, jst), (ttext, tst) = out
    assert tst == jst and ttext == jtext
    assert tst["unal"] <= 8
    recs = {ln.split("\t")[0]: ln.split("\t") for ln in ttext.splitlines()}
    alt = recs["h96"]                      # the ALT allele at chrA:500
    assert alt[2] == "chrA" and alt[3] == "461" and alt[5] == "100M"
    assert ("AS:i:0" in alt) == (name == "snp")
    if name == "snp":
        assert recs["h100"][5] == "50M3D50M" and "NM:i:0" in recs["h100"]
        assert recs["h101"][5] == "50M4I46M" and "AS:i:0" in recs["h101"]
        zs = any(f.startswith("Zs:Z:") for f in alt)
        assert zs == bool(opts.get("zs_tags"))
        if zs:
            assert "Zs:Z:40|S|snv0" in alt
