"""The port's cli.align against hisat2_tpu's, flag set by flag set, single
end: input formats, quality encodings, reporting, scoring, presets and
policy strings, and the --un/--al side files. Every case runs one command
line through both packages' mains on the same files and compares SAM,
stdout, stderr and side files byte for byte (tests/torch_cli_common.py).
Paired-end flags are in test_torch_cli_flags_pe.py; spliced alignment,
other indexes, the drivers' own options and the refusals in
test_torch_cli_flags_idx.py."""

import gzip
import shlex

import pytest
import torch

from hisat2_tpu_torch.io import reads as treads
from torch_cli_common import both, flag_data

torch.set_num_threads(1)

BASE = "-x {d}/idx -S {d}/o.sam --no-spliced-alignment "
FQ = BASE + "-U {d}/r.fq "
QFQ = BASE + "-U {d}/r.q.fq "

# (case, command line after BASE with {d} the data directory, files
# written besides the SAM)
CASES = [
    ("fasta", BASE + "-f -U {d}/r.fa", []),
    ("fasta_by_extension", BASE + "-U {d}/r.fa", []),
    ("raw", BASE + "-r -U {d}/r.raw", []),
    ("cmdline", BASE + "-c -U {cmd}", []),
    ("fasta_continuous", BASE + "-F k:32,i:8 -U {d}/small.fa", []),
    ("qseq_qc_filter", BASE + "--qseq --qc-filter -U {d}/r.qseq", []),
    ("qseq", BASE + "--qseq -U {d}/r.qseq", []),
    ("tab6", BASE + "--12 {d}/r.tab6", []),
    ("fastq_q", BASE + "-q -U {d}/r.q.fq", []),
    ("two_files", BASE + "-U {d}/r.fq,{d}/r.q.fq", []),
    ("phred64", BASE + "--phred64 -U {d}/r.p64.fq", []),
    ("solexa", BASE + "--solexa-quals -U {d}/r.sol.fq", []),
    ("int_quals", BASE + "--int-quals -U {d}/r.int.fq", []),
    ("ignore_quals", QFQ + "--ignore-quals", []),
    ("k1", FQ + "-k 1", []),
    ("all", FQ + "-a", []),
    ("omit_sec_seq", FQ + "--omit-sec-seq", []),
    ("no_head", FQ + "--no-head", []),
    ("reorder_batches", FQ + "--reorder --batch-size 16", []),
    ("remove_chrname", FQ + "--remove-chrname", []),
    ("add_chrname", FQ + "--add-chrname", []),
    ("scoring", QFQ + "--mp 4,2 --sp 2,1 --np 2 --rdg 4,2 --rfg 6,2 "
     "--score-min L,0,-0.4 --n-ceil L,0,0.2", []),
    ("no_softclip", FQ + "--no-softclip", []),
    ("nofw_trim", FQ + "--nofw -5 4 -3 2 -s 3 -u 40 -p 4", []),
    ("fast", FQ + "--fast", []),
    ("sensitive", FQ + "--sensitive", []),
    ("very_sensitive", FQ + "--very-sensitive", []),
    ("seed_flags", FQ + "-N 1 -L 20 -i S,1,0.5 -D 20 -R 3", []),
    ("policy", FQ + "--policy SEED=0,20;DPS=30;MMP=C5;RDG=6,2", []),
    ("un_al", QFQ + "--un {d}/un.fq --al {d}/al.fq", ["un.fq", "al.fq"]),
    ("un_only_summary", FQ + "--un {d}/un.fq -t", ["un.fq"]),
    ("fastq_gz_members", BASE + "-U {d}/r.q.fq.gz --batch-size 24", []),
]
# cases run with the read layer's FASTQ block size cut to these bytes, so
# that records and CRLF line ends straddle blocks
BLOCKS = {"fastq_gz_members": 333}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """flag_data's files, and r.q.fq with CRLF line ends as a gzip file
    of 5-record members."""
    got = flag_data(tmp_path_factory.mktemp("tflags"))
    d = got["dir"]
    lines = (d / "r.q.fq").read_bytes().replace(b"\n", b"\r\n").splitlines(
        keepends=True)
    (d / "r.q.fq.gz").write_bytes(b"".join(
        gzip.compress(b"".join(lines[i:i + 20]))
        for i in range(0, len(lines), 20)))
    return got


@pytest.mark.parametrize("case,cmd,side", CASES, ids=[c[0] for c in CASES])
def test_se_flags(data, capsys, monkeypatch, case, cmd, side):
    if case in BLOCKS:
        monkeypatch.setattr(treads, "BLOCK", BLOCKS[case])
    d = data["dir"]
    argv = shlex.split(cmd.format(d=d, cmd=data["cmdline"]))
    t = both("align", argv, [str(d / "o.sam")] + [str(d / s) for s in side],
             capsys)
    assert t["rc"] == 0
    sam = t["files"]["o.sam"].decode()
    recs = [ln for ln in sam.splitlines() if not ln.startswith("@")]
    assert recs and any(not int(ln.split("\t")[1]) & 4 for ln in recs)
