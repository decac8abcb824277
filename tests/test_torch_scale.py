"""The port's human-scale validation tools against the JAX package's
scripts: hisat2_tpu_torch.tools.scale_validate and .scale_rna_validate
against scripts/scale_validate.py and scripts/scale_rna_validate.py, each
run once in process at a small size, their JSON fields that do not depend
on the clock or the machine equal; the genome, read and gene generators
against the JAX scripts' lines on the same default_rng stream; the
sh.known_ss the RNA run sets is read by nothing (the JAX script's
defect, kept); the shard cache, the placement split at 2^31 and the
host-memory refusal."""

import argparse
import contextlib
import glob
import io
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

import test_torch_native_cache  # noqa: F401  (JAX native libs, built once under a lock)
from hisat2_tpu.io.reads import Read as JRead, batchify as jbatchify
from hisat2_tpu.utils import alphabet as jalphabet

from hisat2_tpu_torch.tools import scale_rna_validate as trna
from hisat2_tpu_torch.tools import scale_validate as tse

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX SE script caches its shards at /tmp/scale_shards_{bases}_*.npz:
# the tests load it with that prefix moved into their own tmp_path
SE_ARGS = ["--bases", "1600000", "--reads", "512", "--batch", "256"]
RNA_ARGS = ["--bases", "3200000", "--pairs", "512", "--batch", "256"]
SE_KEYS = ("shards", "kt", "stats", "pct_aligned", "pct_correct_of_primary")
RNA_KEYS = ("stats", "pct_concordant", "exonic_correct", "exonic_wrong",
            "junction_correct", "junction_wrong", "mate1_unaligned", "snps",
            "genes", "ss_baked")
CLOCK_KEYS = ("gen_s", "build_s", "align_s", "reads_per_s",
              "steady_reads_per_s", "host_rss_gb", "host_peak_rss_bytes",
              "upload_s")


def jax_script(name, subs=()):
    """scripts/{name}.py as a module, each (old, new) of `subs` replaced
    in its source before it is compiled; the file itself is untouched.
    The RNA script's JAX compile cache under HOME is left off."""
    path = os.path.join(ROOT, "scripts", f"{name}.py")
    with open(path) as f:
        src = f.read()
    for a, b in subs:
        assert a in src, a
        src = src.replace(a, b)
    mod = types.ModuleType(f"_jax_{name}")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    if hasattr(mod, "_bench"):
        mod._bench = types.SimpleNamespace(_enable_compile_cache=lambda: None)
    return mod


def last_json(text: str) -> dict:
    line = text.strip().splitlines()[-1]
    return json.loads(line[line.index("{"):])


def run_jax_main(name, argv, subs=()) -> dict:
    """The JAX script's main() in this process, its last JSON line."""
    mod = jax_script(name, subs)
    out = io.StringIO()
    old = sys.argv
    sys.argv = [name] + argv
    try:
        with contextlib.redirect_stdout(out):
            assert mod.main() == 0
    finally:
        sys.argv = old
    return last_json(out.getvalue())


def run_port(mod, argv) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert mod.main(argv + ["--device", "cpu"]) == 0
    return last_json(out.getvalue())


# ---- the generators against the JAX scripts' lines ------------------------

def jax_genome_lines(bases, rng):
    """scripts/scale_validate.py:52-74, as written there."""
    nchrom = 16
    clen = bases // nchrom
    joined = rng.integers(0, 4, bases, dtype=np.uint8)
    unit = joined[1000:1300].copy()
    sites = rng.integers(0, bases - 300, 2000)
    for s in sites:
        joined[s:s + 300] = unit
    names = [f"chr{i+1}" for i in range(nchrom)]
    tlens = np.full(nchrom, clen, np.int64)
    return dict(names=names, tlens=tlens, joined=joined,
                frag_joined=np.arange(nchrom, dtype=np.int64) * clen,
                frag_toff=np.zeros(nchrom, np.int64),
                frag_tidx=np.arange(nchrom, dtype=np.int64),
                frag_len=np.full(nchrom, clen, np.int64))


def jax_read_lines(joined, reads, rdlen, batch, rng):
    """scripts/scale_validate.py:121-136, as written there."""
    starts = rng.integers(0, joined.size - rdlen, reads)
    batches = []
    for b0 in range(0, reads, batch):
        rr = []
        for i in range(b0, min(b0 + batch, reads)):
            st = int(starts[i])
            s = joined[st:st + rdlen].copy()
            mm = rng.random(rdlen) < 0.01
            s[mm] = (s[mm] + rng.integers(1, 4, int(mm.sum()))) % 4
            if i % 2:
                s = jalphabet.revcomp(s)
            rr.append(JRead(f"r{i}_{st}", s,
                            np.full(rdlen, 40, np.int8), i))
        batches.append(jbatchify(rr, pad_to=rdlen + 4))
    return batches


def test_make_genome_and_sample_reads_equal_jax_lines():
    want = jax_genome_lines(160_000, np.random.default_rng(0))
    rng = np.random.default_rng(0)
    ref = tse.make_genome(160_000, rng)
    for k, v in want.items():
        got = getattr(ref, k)
        if isinstance(v, np.ndarray):
            assert got.dtype == v.dtype, k
        np.testing.assert_array_equal(got, v, err_msg=k)
    jrng = np.random.default_rng(0)
    jax_genome_lines(160_000, jrng)
    jb = jax_read_lines(want["joined"], 300, 100, 128, jrng)
    tb = tse.sample_reads(ref.joined, 300, 100, 128, rng)
    assert [len(b) for b in tb] == [128, 128, 44]
    for j, t in zip(jb, tb):
        assert t.names == j.names
        for k in ("seqs", "quals", "lens", "rdids"):
            np.testing.assert_array_equal(getattr(t, k), getattr(j, k),
                                          err_msg=k)
    # both streams were left at the same state
    assert rng.integers(0, 1 << 30) == jrng.integers(0, 1 << 30)


def test_plant_genes_equals_jax():
    jmod = jax_script("scale_rna_validate")
    base = np.random.default_rng(7).integers(0, 4, 400_000, dtype=np.uint8)
    jj, tj = base.copy(), base.copy()
    jr, tr = np.random.default_rng(8), np.random.default_rng(8)
    for lo, hi in ((0, 200_000), (200_000, 400_000)):
        assert (trna.plant_genes(tj, tr, 6, lo, hi)
                == jmod.plant_genes(jj, jr, 6, lo, hi))
    np.testing.assert_array_equal(tj, jj)
    assert not np.array_equal(tj, base)


# ---- the runs ----------------------------------------------------------------

@pytest.fixture(scope="module")
def se_runs(tmp_path_factory):
    cache = tmp_path_factory.mktemp("jax_scale_shards")
    jres = run_jax_main("scale_validate", SE_ARGS + ["--out", os.devnull],
                        subs=[("/tmp/scale_shards_",
                               f"{cache}/scale_shards_")])
    # the JAX run built its shards and saved them in the test's own dir
    assert glob.glob(str(cache / "scale_shards_1600000_*.npz"))
    return jres, run_port(tse, SE_ARGS)


@pytest.fixture(scope="module")
def rna_runs():
    return (run_jax_main("scale_rna_validate", RNA_ARGS + [
        "--out", os.devnull]), run_port(trna, RNA_ARGS))


@pytest.mark.parametrize("key", SE_KEYS)
def test_scale_validate_equals_jax(key, se_runs):
    jres, tres = se_runs
    assert tres[key] == jres[key]


def test_scale_validate_port_fields(se_runs):
    _, t = se_runs
    assert t["device"] == "cpu" and t["card"] is None
    assert t["max_memory_allocated"] is None
    assert t["uploads"] == t["shards"] and t["evictions"] == 0
    assert len(t["bundle_nbytes"]) == t["shards"]
    assert t["placement"]["prim"] == 512
    assert t["placement"]["unal"] == t["stats"]["unal"]
    # on the CPU the plain versions run: no kernel launch is counted
    assert t["launches"] and not any(t["launches"].values())


@pytest.mark.parametrize("key", RNA_KEYS)
def test_scale_rna_validate_equals_jax(key, rna_runs):
    jres, tres = rna_runs
    assert tres[key] == jres[key]


def test_known_ss_is_read_by_nothing():
    """The JAX script sets sh.known_ss, and neither package's
    ShardedAligner reads it: the port's result is the same without it
    (at 16 pairs: the spliced step's CPU cost grows with the rows)."""
    args = argparse.Namespace(
        bases=3_200_000, pairs=16, batch=16, snp_rate=0.001,
        genes_per_gbp=6000, cache=None, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        baked = trna.run(args)
        unset = trna.run(args, bake_ss=False)
    assert baked["ss_baked"] > 0 and baked["stats"]["pairs"] == 16
    assert baked["junction_correct"] > 0
    for k in baked:
        if k not in CLOCK_KEYS:
            assert unset[k] == baked[k], k


def test_shard_cache_round_trip(tmp_path, se_runs):
    """--cache saves the shards with ShardedIndex.save and the next run
    loads them: the same result."""
    argv = ["--bases", "160000", "--reads", "256", "--batch", "128",
            "--cache", str(tmp_path)]
    first = run_port(tse, argv)
    assert glob.glob(str(tmp_path / "scale_se_160000*.sharded.json"))
    second = run_port(tse, argv)
    for k in first:
        if k not in CLOCK_KEYS:
            assert second[k] == first[k], k


def test_placement_splits_at_2_31():
    hi = 1 << 31
    clen = 200_000_000
    names = [f"chr{i + 1}" for i in range(16)]
    t = hi + 5
    c, off = divmod(t, clen)
    lines = [
        f"r0_{t}\t0\tchr{c + 1}\t{off + 1}",          # placed exactly
        f"r1_{t}\t16\tchr{c + 1}\t{off + 5}",         # 4 bp off
        f"r1_{t}\t256\tchr{c + 1}\t{off + 1}",        # secondary: skipped
        f"r2_{t}\t4\t*\t0",
        f"r3_100\t0\tchr1\t99",                       # 2 bp off, below 2^31
    ]
    got = tse.placement("\n".join(lines), names, clen)
    assert got == dict(prim=4, unal=1, ok=2, high_prim=3, high_unal=1,
                       high_ok=1)


def test_host_memory_refusal(monkeypatch):
    monkeypatch.setattr(tse, "host_available", lambda: (1 << 30, "test"))
    with pytest.raises(SystemExit, match=r"needs an estimated \d+ bytes"):
        tse.main(["--device", "cpu"])
    with pytest.raises(SystemExit, match=r"1073741824 bytes"):
        trna.main(["--device", "cpu"])
    # the defaults' estimates, printed in the tools' docstrings
    assert 37e9 < tse.host_need_se(3_200_000_000, 1879048192) < 37.5e9
    assert 44e9 < trna.host_need_rna(3_200_000_000, 3_200_000,
                                     1879048192) < 44.5e9


@pytest.mark.parametrize("max_bases", [5_000, 22_000, 45_000, 1 << 20])
def test_shard_spans_match_jax_cut(max_bases):
    """index.sharded.shard_spans, which build_sharded and the tools'
    memory estimates share, cuts where hisat2_tpu's build_sharded does."""
    from hisat2_tpu.index.sharded import build_sharded as jbuild
    from hisat2_tpu.io.reference import JoinedReference as JRef
    from hisat2_tpu_torch.index.sharded import build_sharded, shard_spans
    ref = tse.make_genome(80_000, np.random.default_rng(3))
    jref = JRef(**{k: getattr(ref, k) for k in (
        "names", "tlens", "joined", "frag_joined", "frag_toff", "frag_tidx",
        "frag_len")})
    spans = shard_spans(ref.frag_len, max_bases)
    want = jbuild(jref, max_bases=max_bases).bases
    assert [int(ref.frag_joined[s]) for s, _ in spans] == list(want)
    assert list(build_sharded(ref, max_bases=max_bases).bases) == list(want)
    assert spans[-1][1] == len(ref.frag_len)
    assert sum(tse.shard_sizes(80_000, max_bases)) == 80_000


def test_shard_sizes_at_human_size():
    from hisat2_tpu_torch.index.sharded import MAX_SHARD_BASES
    assert tse.shard_sizes(3_200_000_000, MAX_SHARD_BASES) == [
        1_800_000_000, 1_400_000_000]
