"""The reference check of SAM records: right records pass, altered ones
fail, placement follows the truth."""

import numpy as np
import pytest

from reference import samcheck

RNG = np.random.default_rng(3)
GENOME = RNG.integers(0, 4, 2000).astype(np.uint8)
LET = "ACGT"


def s(codes):
    return "".join(LET[c] for c in codes)


def rec(line):
    return samcheck.parse(line)


def make(flag, pos, cigar, seq, qual, tags):
    t = "\t".join(f"{k}:{'Z' if isinstance(v, str) else 'i'}:{v}"
                  for k, v in tags.items())
    return rec(f"r1\t{flag}\tc\t{pos}\t60\t{cigar}\t*\t0\t0\t{seq}\t{qual}"
               f"\t{t}")


def base_case():
    """A 20 bp read at 101 (1-based) with one mismatch at its 6th base
    (quality 37: penalty 5) and a 2 bp deletion after its 12th base."""
    read = np.concatenate([GENOME[100:112], GENOME[114:122]]).copy()
    read[5] = (read[5] + 1) % 4
    qual = np.full(20, 37, np.uint8)
    md = f"5{LET[GENOME[105]]}6^{s(GENOME[112:114])}8"
    tags = {"AS": -5 - (5 + 3 * 2), "XM": 1, "XO": 1, "XG": 1, "NM": 3,
            "MD": md}
    r = make(0, 101, "12M2D8M", s(read), "F" * 20, tags)
    return r, read, qual


def test_right_record_passes():
    r, read, qual = base_case()
    known = samcheck.Known()
    assert samcheck.check_record(r, read, qual, GENOME, known) is None
    # the same read reverse-complemented, as sequenced, under flag 16
    rr = dict(r, flag=16)
    assert samcheck.check_record(rr, samcheck.COMP[read[::-1]], qual[::-1],
                                 GENOME, known) is None


@pytest.mark.parametrize("field,value", [
    ("pos", 102), ("cigar", "12M1D9M"), ("flag", 16)])
def test_altered_record_fails(field, value):
    r, read, qual = base_case()
    bad = dict(r, **{field: value})
    assert samcheck.check_record(bad, read, qual, GENOME,
                                 samcheck.Known()) is not None


@pytest.mark.parametrize("tag,delta", [("AS", 1), ("NM", 1), ("XM", -1),
                                       ("XO", 1), ("XG", 1)])
def test_altered_tag_fails(tag, delta):
    r, read, qual = base_case()
    tags = dict(r["tags"])
    tags[tag] += delta
    assert samcheck.check_record(dict(r, tags=tags), read, qual, GENOME,
                                 samcheck.Known()) is not None


def test_altered_seq_or_md_fails():
    r, read, qual = base_case()
    other = read.copy()
    other[0] = (other[0] + 1) % 4
    assert samcheck.check_record(r, other, qual, GENOME,
                                 samcheck.Known()) == "SEQ is not the read"
    tags = dict(r["tags"], MD="20")
    assert "MD" in samcheck.check_record(dict(r, tags=tags), read, qual,
                                         GENOME, samcheck.Known())


def test_known_variants_and_introns():
    g = GENOME.copy()
    g[300:302] = [2, 3]               # GT ... AG intron of 500 bp
    g[798:800] = [0, 2]
    read = np.concatenate([g[290:300], g[800:810]]).copy()
    read[3] = (g[293] + 1) % 4        # a known SNV's alternative allele
    qual = np.full(20, 37, np.uint8)
    variants = {"pos": np.array([293]), "type": np.array([0]),
                "len": np.array([1]), "alt": np.array([int(read[3])]),
                "ins": [np.zeros(0, np.uint8)]}
    known = samcheck.Known(variants, [("+", [(250, 300), (800, 900)])])
    md = f"3{LET[g[293]]}16"
    ok = make(0, 291, "10M500N10M", s(read), "F" * 20,
              {"AS": 0, "XM": 0, "XO": 0, "XG": 0, "NM": 0, "MD": md,
               "XS": "+"})
    assert samcheck.check_record(ok, read, qual, g, known) is None
    # without the variant the base is a mismatch (penalty 5, one in NM)
    assert samcheck.check_record(ok, read, qual, g,
                                 samcheck.Known(None, None)) is not None
    assert samcheck.check_record(dict(ok, tags=dict(ok["tags"], XS="-")),
                                 read, qual, g, known) is not None
    assert samcheck.intron_pen(8103) == 0 and samcheck.intron_pen(8104) == 1
    assert samcheck.intron_pen(50000) == 2


def test_known_deletion_either_way():
    read = np.concatenate([GENOME[500:510], GENOME[512:522]])
    qual = np.full(20, 37, np.uint8)
    variants = {"pos": np.array([510]), "type": np.array([1]),
                "len": np.array([2]), "alt": np.array([-1]),
                "ins": [np.zeros(0, np.uint8)]}
    known = samcheck.Known(variants, None)
    md = f"10^{s(GENOME[510:512])}10"
    edge = {"AS": 0, "XM": 0, "XO": 0, "XG": 0, "NM": 0, "MD": md}
    gap = {"AS": -11, "XM": 0, "XO": 1, "XG": 1, "NM": 2, "MD": md}
    for tags in (edge, gap):
        r = make(0, 501, "10M2D10M", s(read), "F" * 20, tags)
        assert samcheck.check_record(r, read, qual, GENOME, known) is None
    mixed = make(0, 501, "10M2D10M", s(read), "F" * 20, dict(edge, XO=1))
    assert samcheck.check_record(mixed, read, qual, GENOME, known)


def test_soft_clip_and_placement():
    read = GENOME[700:720].copy()
    read[:2] = (read[:2] + 2) % 4
    qual = np.array([2, 11] + [37] * 18, np.uint8)
    r = make(0, 703, "2S18M", s(read), "#," + "F" * 18,
             {"AS": -2, "XM": 0, "XO": 0, "XG": 0, "NM": 0, "MD": "18"})
    assert samcheck.check_record(r, read, qual, GENOME,
                                 samcheck.Known()) is None
    gpos = np.arange(700, 720)
    assert samcheck.placed_right(r, gpos, False)
    assert not samcheck.placed_right(r, gpos, True)
    assert not samcheck.placed_right(dict(r, pos=704), gpos, False)
    assert not samcheck.placed_right(None, gpos, False)
