"""The port's tools, policy strings and embedding API against
hisat2_tpu's: every tool's output on the same inputs (GTF -> .ss/.exon,
VCF and UCSC -> .snp/.haplotype, the read simulators with the same seed,
read statistics), apply_policy on every preset and component, and
api.init(..., device="cpu") field by field."""

import dataclasses
import io

import numpy as np
import pytest
import torch

from torch_cli_common import both, write_fastq
from hisat2_tpu.utils import alphabet

torch.set_num_threads(1)

GTF = """\
chr1\thavana\tgene\t100\t900\t.\t+\t.\tgene_id "G1"; transcript_id "T0";
chr1\thavana\texon\t100\t200\t.\t+\t.\tgene_id "G1"; transcript_id "T1";
chr1\thavana\texon\t300\t400\t.\t+\t.\tgene_id "G1"; transcript_id "T1";
chr1\thavana\texon\t600\t700\t.\t+\t.\tgene_id "G1"; transcript_id "T1";
chr1\thavana\texon\t100\t200\t.\t+\t.\tgene_id "G1"; transcript_id "T2";
chr1\thavana\texon\t600\t700\t.\t+\t.\tgene_id "G1"; transcript_id "T2";
chr1\thavana\texon\t650\t820\t.\t+\t.\tgene_id "G1"; transcript_id "T5";
chr1\thavana\texon\t1200\t1300\t.\t+\t.\tgene_id "G1"; transcript_id "T5";
chr2\thavana\texon\t50\t80\t.\t-\t.\tgene_id "G2"; transcript_id "T3";
chr2\thavana\texon\t90\t120\t.\t-\t.\tgene_id "G2"; transcript_id "T3";
chr2\thavana\texon\t122\t160\t.\t-\t.\tgene_id "G2"; transcript_id "T3";
chr2\thavana\texon\t400\t480\t.\t.\t.\tgene_id "G3"; transcript_id "T4"; # x
chr2\thavana\texon\t700\t650\t.\t-\t.\tgene_id "G3"; transcript_id "T6";
chr2\thavana\texon\t800\t900\t.\t-\t.\tgene_id "G3";
# a comment
chr2\thavana\texon\t800\t900
"""

VCF = ("##fileformat=VCFv4.2\n"
       "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
       "chr1\t100\trs1\tA\tG\t.\t.\t.\n"
       "chr1\t150\trs2\tAT\tA\t.\t.\t.\n"
       "chr1\t170\trs3\tA\tACC\t.\t.\t.\n"
       "chr1\t500\trs4\tA\tG,C\t.\t.\t.\n"
       "chr1\t520\t.\tC\tT\t.\t.\t.\n"
       "chr1\t530\tesv7\tG\tA\t.\t.\t.\n"
       "chr1\t900\trs8\tAC\tGT\t.\t.\t.\n"
       "chr1\t950\trs9\tA\t<DEL>\t.\t.\t.\n"
       "chr2\t10\trs10\tC\tA\t.\t.\t.\n"
       "chr2\t60\trs11\tCAA\tC\t.\t.\t.\n"
       "short\tline\n")

UCSC = ("585\tchr1\t99\t100\trs1\t0\t+\tA\tA\tA/G\tgenomic\tsingle\n"
        "585\tchr1\t200\t201\trs2\t0\t-\tA\tA\tT/C\tgenomic\tsingle\n"
        "585\tchr1\t300\t303\trs3\t0\t+\tACG\tACG\t-/ACG\tgenomic\t"
        "deletion\n"
        "585\tchr1\t400\t400\trs4\t0\t-\t-\t-\t-/AC\tgenomic\tinsertion\n"
        "585\tchr1\t500\t501\trs5\t0\t+\tA\tA\tA/N\tgenomic\tsingle\n"
        "585\tchr1\t600\t601\trs6\t0\t+\tA\tA\tlengthTooLong\tgenomic\t"
        "mixed\n"
        "short\n")


def _pair(mod: str):
    import importlib
    return [importlib.import_module(f"{p}.tools.{mod}")
            for p in ("hisat2_tpu", "hisat2_tpu_torch")]


@pytest.mark.parametrize("tool,fn", [("extract_splice_sites",
                                      "extract_splice_sites"),
                                     ("extract_exons", "extract_exons")])
def test_gtf_tools(tool, fn, tmp_path, capsys):
    outs = []
    for mod in _pair(tool):
        out = io.StringIO()
        n = getattr(mod, fn)(io.StringIO(GTF), out)
        outs.append((n, out.getvalue()))
    assert outs[1] == outs[0] and outs[0][0] > 0
    (tmp_path / "a.gtf").write_text(GTF)
    t = both(f"tools.{tool}", [str(tmp_path / "a.gtf")], [], capsys)
    assert t["out"] == outs[0][1]


def test_parse_transcripts():
    j, t = _pair("gtf")
    assert t.parse_transcripts(io.StringIO(GTF)) == \
        j.parse_transcripts(io.StringIO(GTF))


@pytest.mark.parametrize("form", ["vcf", "vcf_non_rs", "ucsc"])
def test_extract_snps(form, tmp_path, capsys):
    src = tmp_path / ("in.txt" if form == "ucsc" else "in.vcf")
    src.write_text(UCSC if form == "ucsc" else VCF)
    base = str(tmp_path / "out")
    argv = [str(src), base] + {"vcf": [], "vcf_non_rs": ["--non-rs"],
                               "ucsc": ["--ucsc"]}[form]
    outs = [base + ".snp"] + ([] if form == "ucsc" else [base + ".haplotype"])
    t = both("tools.extract_snps", argv, outs, capsys)
    assert t["files"]["out.snp"]
    j, p = _pair("extract_snps")
    if form == "ucsc":
        n = [m.extract_snps_ucsc(str(src), base) for m in (j, p)]
    else:
        n = [m.extract_snps_vcf(str(src), base, form == "vcf_non_rs")
             for m in (j, p)]
    assert n[1] == n[0] > 0


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    d = tmp_path_factory.mktemp("ttools")
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 4, 20000).astype(np.uint8)
    codes2 = rng.integers(0, 4, 6000).astype(np.uint8)
    with open(d / "g.fa", "w") as fh:
        for name, c in (("chrA", codes), ("chrB", codes2)):
            fh.write(f">{name}\n{alphabet.decode(c)}\n")
    (d / "g.snp").write_text("".join(
        f"s{k}\tsingle\tchrA\t{p}\t{alphabet.decode([(int(codes[p]) + 1) % 4])}"
        f"\n" for k, p in enumerate(range(300, 19000, 97))))
    (d / "g.gtf").write_text(
        'chrA\tsim\texon\t1001\t1300\t.\t+\t.\tgene_id "g"; transcript_id "t";\n'
        'chrA\tsim\texon\t2001\t2250\t.\t+\t.\tgene_id "g"; transcript_id "t";\n'
        'chrA\tsim\texon\t4001\t4400\t.\t+\t.\tgene_id "g"; transcript_id "t";\n'
        'chrB\tsim\texon\t101\t900\t.\t-\t.\tgene_id "h"; transcript_id "u";\n'
        'chrB\tsim\texon\t1501\t1700\t.\t-\t.\tgene_id "h"; transcript_id "u";\n')
    return d, codes


@pytest.mark.parametrize("opts", [
    dict(), dict(error_rate=0.02), dict(paired=True, frag_len=300),
    dict(paired=True, frag_len=300, error_rate=0.01), dict(snp=True)])
def test_simulate(genome, opts):
    d, _ = genome
    opts = dict(opts)
    use_snp = opts.pop("snp", False)
    got = []
    for mod, p in zip(_pair("simulate_reads"), ("hisat2_tpu",
                                                "hisat2_tpu_torch")):
        import importlib
        ref = importlib.import_module(f"{p}.io.reference").load_reference(
            [str(d / "g.fa")])
        snps = (importlib.import_module(f"{p}.io.annotations").read_snps(
            str(d / "g.snp"), ref) if use_snp else None)
        got.append([(n, s1.tolist(), None if s2 is None else s2.tolist(), t)
                    for n, s1, s2, t in mod.simulate(
                        ref, np.random.default_rng(9), 40, 100,
                        snp_db=snps, **opts)])
    assert got[1] == got[0]


@pytest.mark.parametrize("paired", [False, True])
def test_simulate_rna(genome, paired):
    d, _ = genome
    got = []
    for p in ("hisat2_tpu", "hisat2_tpu_torch"):
        import importlib
        ref = importlib.import_module(f"{p}.io.reference").load_reference(
            [str(d / "g.fa")])
        gtf = importlib.import_module(f"{p}.tools.gtf")
        sim = importlib.import_module(f"{p}.tools.simulate_reads")
        trans = gtf.parse_transcripts(open(d / "g.gtf"))
        got.append([(n, s1.tolist(), None if s2 is None else s2.tolist(), t)
                    for n, s1, s2, t in sim.simulate_rna(
                        ref, trans, np.random.default_rng(4), 30, 100,
                        paired=paired, frag_len=250, error_rate=0.01)])
        assert sim._cigar_str([("M", 40), ("N", 700), ("M", 60)]) == \
            "40M700N60M"
    assert got[1] == got[0]


@pytest.mark.parametrize("extra", [
    [], ["--paired", "--fragment-length", "300", "--fasta"],
    ["--error-rate", "0.02", "--snp", "{d}/g.snp", "--seed", "3"]],
    ids=["se", "pe_fasta", "errors_snp"])
def test_simulate_main(genome, capsys, extra):
    d, _ = genome
    base = str(d / "sim")
    fasta = "--fasta" in extra
    ext = ".fa" if fasta else ".fq"
    outs = [base + ".truth.sam"] + (
        [base + "_1" + ext, base + "_2" + ext] if "--paired" in extra
        else [base + ext])
    t = both("tools.simulate_reads",
             [str(d / "g.fa"), base, "--num-reads", "25"]
             + [a.format(d=d) for a in extra], outs, capsys)
    assert all(t["files"].values())


@pytest.mark.parametrize("paired", [False, True])
def test_simulate_main_gtf_exits(genome, paired):
    """Reference defect, matched: main() hands parse_transcripts the --gtf
    path where it wants an open file, so it iterates the path's characters,
    finds no transcript, and simulate_rna exits."""
    d, _ = genome
    msgs = []
    for mod in _pair("simulate_reads"):
        with pytest.raises(SystemExit) as e:
            mod.main([str(d / "g.fa"), str(d / "sim"), "--gtf",
                      str(d / "g.gtf")] + (["--paired"] if paired else []))
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0] == "no usable transcripts for the given genome"


def test_read_statistics(tmp_path, capsys):
    write_fastq(tmp_path / "a.fq", [(f"r{i}", "ACGT" * (20 + i % 7))
                                    for i in range(40)])
    (tmp_path / "b.fa").write_text("".join(f">s{i}\n{'ACG' * (30 + i)}\n"
                                           for i in range(12)))
    j, t = _pair("read_statistics")
    for paths, sample in (([str(tmp_path / "a.fq")], 10000),
                          ([str(tmp_path / "a.fq"), str(tmp_path / "b.fa")],
                           45)):
        assert t.read_stats(paths, sample=sample) == \
            j.read_stats(paths, sample=sample)
    t = both("tools.read_statistics",
             [f"{tmp_path / 'a.fq'},{tmp_path / 'b.fa'}", "-n", "47"], [],
             capsys)
    assert t["out"].startswith("reads: 47")
    (tmp_path / "e.fq").write_text("")
    assert both("tools.read_statistics", [str(tmp_path / "e.fq")], [],
                capsys)["out"] == "0 reads\n"
@pytest.mark.parametrize("polstr", [
    "very-sensitive", "sensitive", "fast", "very-fast",
    "MA=2;MMP=C3;RDG=4,2;RFG=6,3;MIN=L,0,-0.3;NCEIL=C,5;NP=C2",
    "SEED=1;SEEDLEN=18;IVAL=L,1,0.2;DPS=40;ROUNDS=4;MMP=5,1;MMP=Q;NP=3;"
    "RDG=6;RFG=7;MIN=-0.6,-0.6;NCEIL=0,0.15",
    "SEED=0,25;IVAL=C,3;DPS=2;ROUNDS=9",
    "IVAL=G,1,2;SEEDLEN=30", "IVAL=S,1;MIN=G,20,8", ";;SEED=2;",
])
def test_policy_string(polstr):
    """apply_policy on every preset and component: the same opts and
    scoring out of both packages."""
    import dataclasses
    from hisat2_tpu.align import policy as jpol
    from hisat2_tpu.align.pipeline import AlignerOpts as JOpts
    from hisat2_tpu.align.scoring import DEFAULT_SCORING as JSC
    from hisat2_tpu_torch.align import policy as tpol
    from hisat2_tpu_torch.align.pipeline import AlignerOpts as TOpts
    from hisat2_tpu_torch.align.scoring import DEFAULT_SCORING as TSC

    assert tpol.PRESETS == jpol.PRESETS
    pol = jpol.PRESETS.get(polstr, polstr)
    jo, to = JOpts(), TOpts()
    jsc = jpol.apply_policy(pol, jo, JSC)
    tsc = tpol.apply_policy(pol, to, TSC)
    assert dataclasses.asdict(to) == dataclasses.asdict(jo)
    assert dataclasses.asdict(tsc) == dataclasses.asdict(jsc)


@pytest.mark.parametrize("polstr", ["BOGUS=1", "SEED", "IVAL=X,1,1",
                                    "MIN=Q,1,1"])
def test_policy_string_errors(polstr):
    from hisat2_tpu.align import policy as jpol
    from hisat2_tpu.align.pipeline import AlignerOpts as JOpts
    from hisat2_tpu.align.scoring import DEFAULT_SCORING as JSC
    from hisat2_tpu_torch.align import policy as tpol
    from hisat2_tpu_torch.align.pipeline import AlignerOpts as TOpts
    from hisat2_tpu_torch.align.scoring import DEFAULT_SCORING as TSC

    errs = []
    for pol, opts, sc in ((jpol, JOpts(), JSC), (tpol, TOpts(), TSC)):
        try:
            pol.apply_policy(polstr, opts, sc)
            errs.append(None)
        except ValueError as e:
            errs.append(str(e))
    assert errs[1] == errs[0]




@pytest.fixture(scope="module")
def api_index(tmp_path_factory):
    from hisat2_tpu.index.fm_index import build_fm_index
    from hisat2_tpu.io.reference import reference_from_seqs
    d = tmp_path_factory.mktemp("tapi")
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 4, 20000).astype(np.uint8)
    ref = reference_from_seqs({"chrA": alphabet.decode(codes),
                               "chrB": alphabet.decode(codes[::-1][:5000])})
    build_fm_index(ref, ftab_k=6).save(str(d / "apidx"))
    return d, codes


def _results(res):
    return [dataclasses.asdict(r) for r in res]


@pytest.mark.parametrize("opts", [dict(), dict(khits=2, nofw=True),
                                  dict(no_spliced_alignment=True)])
def test_api_handle(api_index, opts):
    """init(device="cpu"): names, lengths and align() results field by
    field against hisat2_tpu's handle."""
    import hisat2_tpu.api as jht2
    import hisat2_tpu_torch.api as tht2
    d, codes = api_index
    init_kw = {k: v for k, v in opts.items() if k == "no_spliced_alignment"}
    al_kw = {k: v for k, v in opts.items() if k != "no_spliced_alignment"}
    jh = jht2.init(str(d / "apidx"), sanity_check=True, **init_kw)
    th = tht2.init(str(d / "apidx"), sanity_check=True, device="cpu",
                   **init_kw)
    assert th.get_refnames() == jh.get_refnames() == ["chrA", "chrB"]
    assert th.get_reflens() == jh.get_reflens() == [20000, 5000]
    assert th.options == {**jh.options}
    rng = np.random.default_rng(5)
    seqs = [alphabet.decode(codes[p:p + 100]) for p in
            rng.integers(0, 19900, 12)]
    seqs.append(alphabet.decode(3 - codes[700:800][::-1]))
    seqs.append("ACGT" * 25)
    names = [f"q{i}" for i in range(len(seqs))]
    got = [_results(h.align(seqs, names, **al_kw)) for h in (jh, th)]
    assert got[1] == got[0]
    assert got[0][0]["alns"]
    # a second call reuses the handle's aligner
    assert _results(th.align(seqs[:3], **al_kw)) == \
        _results(jh.align(seqs[:3], **al_kw))
    with pytest.raises(TypeError):
        th.align(seqs[:1], not_an_option=1)


def test_api_reference_defects(api_index):
    """As in hisat2_tpu: repeat_expand raises ValueError (no loader sets
    repeat_db), and off_rate changes nothing."""
    import hisat2_tpu.api as jht2
    import hisat2_tpu_torch.api as tht2
    d, codes = api_index
    for h in (jht2.init(str(d / "apidx")),
              tht2.init(str(d / "apidx"), device="cpu")):
        with pytest.raises(ValueError, match="no repeat database"):
            h.repeat_expand("chrA", 10, 100)
    jh = jht2.init(str(d / "apidx"), off_rate=5)
    th = tht2.init(str(d / "apidx"), off_rate=5, device="cpu")
    plain = tht2.init(str(d / "apidx"), device="cpu")
    assert th.fm.offrate == plain.fm.offrate == jh.fm.offrate == 0
    assert np.array_equal(th.fm.sa, plain.fm.sa)
    seq = [alphabet.decode(codes[500:600])]
    assert _results(th.align(seq)) == _results(jh.align(seq))
    assert th.align(seq)[0].alns[0].joined_pos == 500


def test_api_init_without_a_card_raises(api_index):
    """device="cuda" (the default) with no CUDA device raises at init."""
    import hisat2_tpu_torch.api as tht2
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    d, _ = api_index
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tht2.init(str(d / "apidx"))
