"""The port's command-line drivers against hisat2_tpu's: each test of
tests/test_cli.py run through both packages' mains on the same files, with
SAM, stdout, stderr and every written file compared byte for byte
(tests/torch_cli_common.py: the port's align gets `--device cpu` last, and
its @PG CL may differ by exactly that). Also: an index either package's
cli.build writes aligns the same through the other's cli.align, and the
port's align parser takes exactly hisat2_tpu's options plus --device."""

import os

import numpy as np
import pytest
import torch

from hisat2_tpu.utils import alphabet
from torch_cli_common import (both, build_both, index_files, mains,
                              write_fastq, write_genome)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """tests/test_cli.py's files: a 40 kb genome, 50 reads, one SNP; `idx`
    built by both packages (byte-equal), the port's build on disk."""
    d = tmp_path_factory.mktemp("tcli")
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, 40000).astype(np.uint8)
    write_genome(d / "g.fa", codes)
    reads = []
    for i in range(50):
        p = int(rng.integers(0, 39000))
        reads.append((f"c{i}_{p}", alphabet.decode(codes[p:p + 100])))
    write_fastq(d / "r.fq", reads)
    (d / "g.snp").write_text(f"rs1\tsingle\tchrC\t5000\t"
                             f"{alphabet.decode([(int(codes[5000]) + 1) % 4])}"
                             f"\n")
    files = build_both([str(d / "g.fa"), str(d / "idx"), "--quiet"],
                       str(d / "idx"))
    return d, codes, files


def test_build_align_inspect(workdir, capsys):
    d, codes, files = workdir
    assert set(files) == {"idx.npz", "idx.meta.json"}
    out = str(d / "out.sam")
    t = both("align", ["-x", str(d / "idx"), "-U", str(d / "r.fq"), "-S",
                       out, "--quiet", "--no-spliced-alignment"], [out],
             capsys)
    recs = [ln.split("\t") for ln in t["files"]["out.sam"].decode()
            .splitlines() if not ln.startswith("@")]
    assert len(recs) == 50
    assert sum(int(f[3]) - 1 == int(f[0].split("_")[1]) for f in recs) >= 49
    assert "chrC" in both("inspect", [str(d / "idx"), "-n"], [],
                          capsys)["out"]
    assert "Sequence-1" in both("inspect", [str(d / "idx"), "-s"], [],
                                capsys)["out"]
    fasta = both("inspect", [str(d / "idx")], [], capsys)["out"]
    assert "".join(fasta.splitlines()[1:]) == alphabet.decode(codes)
    fasta = both("inspect", [str(d / "idx"), "-a", "33"], [], capsys)["out"]
    assert "".join(fasta.splitlines()[1:]) == alphabet.decode(codes)


def test_build_snp_and_inspect_snp(workdir, capsys):
    d, codes, _ = workdir
    build_both(["--snp", str(d / "g.snp"), str(d / "g.fa"), str(d / "gidx"),
                "--quiet"], str(d / "gidx"))
    t = both("inspect", [str(d / "gidx"), "--snp"], [], capsys)
    assert t["out"].startswith("rs1\tsingle\tchrC\t5000")


def test_repeat_cli(workdir, capsys):
    d, _, _ = workdir
    rng = np.random.default_rng(8)
    codes2 = rng.integers(0, 4, 30000).astype(np.uint8)
    unit = codes2[100:300].copy()
    for p in (1000, 4000, 9000, 14000, 20000):
        codes2[p:p + 200] = unit
    (d / "rep.fa").write_text(">chrR\n" + alphabet.decode(codes2) + "\n")
    base = str(d / "rp")
    outs = [base + s for s in (".rep.fa", ".rep.info", ".rep.npz",
                               ".rep.meta.json", ".rep.kmer.npy")]
    t = both("repeat", [str(d / "rep.fa"), base, "--repeat-length", "100",
                        "--repeat-count", "4", "--quiet"], outs, capsys)
    assert all(t["files"][os.path.basename(p)] is not None for p in outs)
    # --save-sa, then --load-sa and --no-index, and --forward-only
    sa = str(d / "rp_sa.npz")
    both("repeat", [str(d / "rep.fa"), base, "--repeat-length", "100",
                    "--repeat-count", "4", "--save-sa", sa], outs + [sa],
         capsys)
    t = both("repeat", [str(d / "rep.fa"), base, "--repeat-length", "100",
                        "--repeat-count", "4", "--load-sa", sa,
                        "--no-index"], outs, capsys)
    assert t["files"]["rp.rep.npz"] is None
    both("repeat", [str(d / "rep.fa"), base, "--repeat-length", "100",
                    "--repeat-count", "4", "--forward-only", "--quiet"],
         outs, capsys)


def test_flag_surface(workdir, capsys):
    d, _, _ = workdir
    out = str(d / "flags.sam")
    t = both("align", ["-x", str(d / "idx"), "-U", str(d / "r.fq"), "-S",
                       out, "--quiet", "--no-spliced-alignment", "--norc",
                       "-u", "10", "-s", "5", "-5", "2", "-3", "3", "--rg-id",
                       "grp1", "--rg", "SM:sample1"], [out], capsys)
    lines = t["files"]["flags.sam"].decode().splitlines()
    assert any(ln.startswith("@RG\tID:grp1\tSM:sample1") for ln in lines)
    assert len([ln for ln in lines if not ln.startswith("@")]) == 10


def test_repeat_mode_align(tmp_path, capsys):
    rng = np.random.default_rng(12)
    codes = rng.integers(0, 4, 40000).astype(np.uint8)
    unit = codes[200:400].copy()
    for p in (2000, 8000, 15000, 22000, 30000, 36000):
        codes[p:p + 200] = unit
    fa = tmp_path / "rg.fa"
    fa.write_text(">chrRp\n" + alphabet.decode(codes) + "\n")
    idx = str(tmp_path / "rgidx")
    build_both([str(fa), idx, "--quiet"], idx)
    both("repeat", [str(fa), idx, "--repeat-length", "100",
                    "--repeat-count", "4", "--quiet"], [], capsys)
    fq = tmp_path / "rg.fq"
    write_fastq(fq, [("rep", alphabet.decode(codes[2020:2120])),
                     ("uni", alphabet.decode(codes[5000:5100]))])
    out = str(tmp_path / "rg.sam")
    for extra in (["--repeat"], []):
        # with --repeat: repeat-space records; without: the placements
        # expanded to genomic records (the repeat pass on the per-read
        # path); stderr carries the repeat index's line (no --quiet)
        t = both("align", ["-x", idx, "-U", str(fq), "-S", out,
                           "--no-spliced-alignment"] + extra, [out], capsys)
        recs = {ln.split("\t")[0]: ln.split("\t") for ln in
                t["files"]["rg.sam"].decode().splitlines()
                if not ln.startswith("@")}
        assert recs["uni"][2] == "chrRp"
        assert recs["rep"][2].startswith("rpt_") == bool(extra)


def test_build_ss_exon_inspect_roundtrip(workdir, capsys):
    d, _, _ = workdir
    ss = d / "g.ss"
    ss.write_text("chrC\t1999\t2500\t+\nchrC\t7000\t7600\t-\n")
    exon = d / "g.exon"
    exon.write_text("chrC\t1500\t1999\t+\nchrC\t2501\t2800\t+\n")
    build_both(["--ss", str(ss), "--exon", str(exon), str(d / "g.fa"),
                str(d / "tidx"), "--quiet"], str(d / "tidx"))
    assert both("inspect", [str(d / "tidx"), "--ss"], [],
                capsys)["out"] == ss.read_text()
    assert both("inspect", [str(d / "tidx"), "--ss-all"], [],
                capsys)["out"] == ss.read_text()
    assert both("inspect", [str(d / "tidx"), "--exon"], [],
                capsys)["out"] == exon.read_text()


def test_tmo_cli(workdir, capsys):
    d, _, _ = workdir
    out = str(d / "tmo.sam")
    t = both("align", ["-x", str(d / "idx"), "-U", str(d / "r.fq"), "-S",
                       out, "--quiet", "--tmo"], [out], capsys)
    recs = [ln.split("\t") for ln in t["files"]["tmo.sam"].decode()
            .splitlines() if not ln.startswith("@")]
    assert len(recs) == 50 and all(int(f[1]) & 4 for f in recs)


def test_tmo_cli_pe(workdir, capsys):
    d, codes, _ = workdir
    rng = np.random.default_rng(11)
    m1, m2 = [], []
    for i in range(30):
        p = int(rng.integers(0, 38000))
        frag = codes[p:p + 300]
        m1.append((f"p{i}", alphabet.decode(frag[:100])))
        m2.append((f"p{i}", alphabet.decode(3 - frag[-100:][::-1])))
    write_fastq(d / "p1.fq", m1)
    write_fastq(d / "p2.fq", m2)
    out = str(d / "tmo_pe.sam")
    t = both("align", ["-x", str(d / "idx"), "-1", str(d / "p1.fq"), "-2",
                       str(d / "p2.fq"), "-S", out, "--quiet", "--tmo"],
             [out], capsys)
    recs = [ln.split("\t") for ln in t["files"]["tmo_pe.sam"].decode()
            .splitlines() if not ln.startswith("@")]
    assert len(recs) == 60 and all(int(f[1]) & 4 for f in recs)


@pytest.mark.parametrize("built_by", ["jax", "port"])
def test_index_crosses_packages(workdir, tmp_path, capsys, built_by):
    """An index built by one package's cli.build aligns to the same SAM
    through either package's cli.align (SE and PE)."""
    d, codes, _ = workdir
    jb, tb = mains("build")
    idx = str(tmp_path / "x")
    build = jb if built_by == "jax" else tb
    assert build([str(d / "g.fa"), idx, "--quiet"]) == 0
    assert list(index_files(idx).values()) == \
        list(index_files(str(d / "idx")).values())
    rng = np.random.default_rng(21)
    m1, m2 = [], []
    for i in range(20):
        p = int(rng.integers(0, 39000 - 300))
        frag = codes[p:p + 300]
        m1.append((f"q{i}", alphabet.decode(frag[:100])))
        m2.append((f"q{i}", alphabet.decode(3 - frag[-100:][::-1])))
    write_fastq(tmp_path / "q1.fq", m1)
    write_fastq(tmp_path / "q2.fq", m2)
    out = str(tmp_path / "x.sam")
    both("align", ["-x", idx, "-U", str(d / "r.fq"), "-S", out, "--quiet",
                   "--no-spliced-alignment"], [out], capsys)
    both("align", ["-x", idx, "-1", str(tmp_path / "q1.fq"), "-2",
                   str(tmp_path / "q2.fq"), "-S", out, "--quiet"], [out],
         capsys)


def _options(ap):
    return {repr((sorted(a.option_strings), a.dest, a.nargs, a.const,
                  a.default, a.type, a.required, a.choices))
            for a in ap._actions if a.option_strings and a.dest != "help"}


def test_align_options_are_jaxs_plus_device():
    from hisat2_tpu.cli.align import build_argparser as jparser
    from hisat2_tpu_torch.cli.align import build_argparser as tparser
    j, t = _options(jparser()), _options(tparser())
    assert t - j == {repr((["--device"], "device", None, None, "cuda",
                           None, False, ("cuda", "cpu")))}
    assert j - t == set()
    jp = {a.dest for a in jparser()._actions if not a.option_strings}
    tp = {a.dest for a in tparser()._actions if not a.option_strings}
    assert tp == jp


def test_device_cuda_without_a_card_fails(workdir, capsys):
    """No fallback: --device cuda (the default) with no CUDA device is a
    non-zero exit with a message, and writes no SAM."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    d, _, _ = workdir
    _, tmain = mains("align")
    out = d / "nocuda.sam"
    for extra in ([], ["--device", "cuda"]):
        rc = tmain(["-x", str(d / "idx"), "-U", str(d / "r.fq"), "-S",
                    str(out), "--no-spliced-alignment"] + extra)
        err = capsys.readouterr().err
        assert rc != 0 and "no CUDA device" in err
        assert not out.exists()
