"""The traffic generator: repeatable from a seed, binned qualities, errors
that follow the qualities, and truth that matches the genome."""

import json
import os

import numpy as np
import pytest

from harness import deploy, traffic

TESTS = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(TESTS)


def tdict(name):
    return json.load(open(os.path.join(BENCH, "traffic", f"{name}.json")))


@pytest.fixture(scope="module")
def deps(tiny_cache):
    return {n: deploy.load(n, os.path.join(TESTS, "configs", f"{n}.json"),
                           tiny_cache) for n in ("tiny_dna", "tiny_rna")}


MIXES = [("tiny_dna", "se100"), ("tiny_dna", "pe100"),
         ("tiny_rna", "rna_pe100")]


@pytest.mark.parametrize("dep_name,mix", MIXES)
def test_pool_repeats_from_seed(deps, dep_name, mix):
    t = tdict(mix)
    a = traffic.make_pool(t, deps[dep_name], 300, 2**40 + 7)
    b = traffic.make_pool(t, deps[dep_name], 300, 2**40 + 7)
    c = traffic.make_pool(t, deps[dep_name], 300, 2**40 + 8)
    for x in ("seqs", "quals", "gpos", "rev"):
        assert np.array_equal(getattr(a, x), getattr(b, x))
    assert not np.array_equal(a.seqs, c.seqs)
    assert a.names == b.names and len(set(a.names)) == len(a.names)
    assert traffic.gzip_members(a, 0, 64) == traffic.gzip_members(b, 0, 64)


@pytest.mark.parametrize("dep_name,mix", MIXES)
def test_truth_matches_genome(deps, dep_name, mix):
    """Every base read at Q37 sits on its genome base (or the variant the
    haplotype carries), seen from the strand it was read."""
    dep = deps[dep_name]
    pool = traffic.make_pool(tdict(mix), dep, 400, 99)
    snv = {}
    if dep.variants is not None:
        v = dep.variants
        snv = {int(p): int(a) for p, t, a in zip(v["pos"], v["type"],
                                                 v["alt"]) if t == 0}
    agree = total = 0
    for m in range(pool.mates):
        for i in range(len(pool)):
            fwd = pool.seqs[m, i]
            q = pool.quals[m, i]
            gp = pool.gpos[m, i]
            if pool.rev[m, i]:
                fwd, q = traffic.COMP[fwd[::-1]], q[::-1]
            ok = (gp >= 0) & (q == 37)
            want = dep.genome[gp[ok]]
            alt = np.array([snv.get(int(p), -1) for p in gp[ok]])
            agree += int(((fwd[ok] == want) | (fwd[ok] == alt)).sum())
            total += int(ok.sum())
    assert agree / total > 0.998


def test_quality_profile_and_errors():
    t = tdict("se100")
    q = t["quality"]
    rng = np.random.default_rng(5)
    quals = traffic.draw_quals(rng, (20000, 100), q)
    assert set(np.unique(quals)) <= set(q["bins"])
    low = (quals < 37).mean(axis=0)
    assert low[-10:].mean() > low[:10].mean() + 0.05      # 3' end worse
    assert abs(low[0] - (1 - q["start"][0])) < 0.01
    assert abs(low[-1] - (1 - q["end"][0])) < 0.01
    seqs = np.zeros((20000, 100), np.uint8)
    traffic.add_errors(rng, seqs, quals)
    err = seqs != 0
    assert 0.007 < err.mean() < 0.014                     # about 1%
    rate = {b: err[quals == b].mean() for b in q["bins"]}
    assert rate[2] > 0.5 and rate[11] > 0.05
    assert rate[37] < 0.001 and rate[25] < 0.006


def test_fastq_text_and_members():
    pool = traffic.Pool(["a", "b"], np.array([[[0, 1, 2, 3], [3, 3, 0, 1]]],
                                             np.uint8),
                        np.array([[[37, 25, 11, 2], [2, 2, 37, 37]]],
                                 np.uint8),
                        np.zeros((1, 2, 4), np.int32),
                        np.zeros((1, 2), bool))
    assert traffic.fastq_text(pool, 0, 0, 2) == (
        b"@a\nACGT\n+\nF:,#\n@b\nTTAC\n+\n##FF\n")
    import gzip
    mem = traffic.gzip_members(pool, 0, 1)
    assert len(mem) == 2
    assert gzip.decompress(b"".join(mem)) == traffic.fastq_text(pool, 0, 0, 2)
