"""The port's cli.align against hisat2_tpu's in spliced mode (the CLI's
default): known and novel splice-site files, --dta, --tmo SE and PE,
--no-temp-splicesite, intron lengths and splice penalties, and an index
with its sites baked in at build (--ss). Both packages' mains run on the
same files; SAM, stdout, stderr and the novel-site files are compared
byte for byte (tests/torch_cli_common.py)."""

import shlex

import pytest
import torch

from torch_cli_common import both, flag_data

torch.set_num_threads(1)

SE = "-x {d}/idx -S {d}/o.sam -U {d}/r.fq "
KNOWN = "--known-splicesite-infile {d}/g.ss "

CASES = [
    ("novel_out", SE + "--novel-splicesite-outfile {d}/novel.ss",
     ["novel.ss"]),
    ("known_and_novel_out", SE + KNOWN + "--novel-splicesite-outfile "
     "{d}/novel.ss", ["novel.ss"]),
    ("novel_infile_dta", SE + "--novel-splicesite-infile {d}/g.ss --dta",
     []),
    ("tmo_se", SE + KNOWN + "--tmo", []),
    ("tmo_pe", "-x {d}/idx -S {d}/o.sam -1 {d}/pt1.fq -2 {d}/pt2.fq "
     + KNOWN + "--tmo", []),
    ("no_temp_splicesite_introns", SE + "--no-temp-splicesite "
     "--min-intronlen 50 --max-intronlen 5000 --pen-cansplice 2 "
     "--pen-noncansplice 10", []),
    ("ss_index", "-x {d}/ssidx -S {d}/o.sam -U {d}/r.fq "
     "--novel-splicesite-outfile {d}/novel.ss", ["novel.ss"]),
]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return flag_data(tmp_path_factory.mktemp("tflags_rna"),
                     indexes=("idx", "ssidx"))


@pytest.mark.parametrize("case,cmd,side", CASES, ids=[c[0] for c in CASES])
def test_spliced_flags(data, capsys, case, cmd, side):
    d = data["dir"]
    argv = shlex.split(cmd.format(d=d))
    t = both("align", argv, [str(d / "o.sam")] + [str(d / s) for s in side],
             capsys)
    assert t["rc"] == 0
    recs = [ln.split("\t") for ln in t["files"]["o.sam"].decode()
            .splitlines() if not ln.startswith("@")]
    spliced = [f for f in recs if "N" in f[5]]
    assert spliced
    if case.startswith("tmo"):
        assert all("N" in f[5] for f in recs if not int(f[1]) & 4)
    for s in side:
        assert t["files"][s] is not None
    if case == "novel_out":
        assert t["files"]["novel.ss"]        # the gene's two introns
