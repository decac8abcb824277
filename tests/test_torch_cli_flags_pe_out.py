"""The port's cli.align against hisat2_tpu's on pairs: insert sizes,
reporting, trimming, scoring, batch size and order, and the
--un-conc/--al-conc side files with the summaries. Both packages' mains
run on the same files; SAM, stdout, stderr and side files are compared
byte for byte (tests/torch_cli_common.py)."""

import shlex

import pytest
import torch

from torch_cli_common import both, flag_data

torch.set_num_threads(1)

PE = ("-x {d}/idx -S {d}/o.sam --no-spliced-alignment "
      "-1 {d}/p1.fq -2 {d}/p2.fq ")

CASES = [
    ("insert_sizes_k1_omit_sec_seq", PE + "-I 200 -X 350 -k 1 "
     "--omit-sec-seq", []),
    ("trim_skip_upto_scoring", PE + "-5 3 -3 5 -s 2 -u 20 --ignore-quals "
     "--mp 5,1 --rdg 6,2 --score-min L,0,-0.3 --no-softclip", []),
    ("batches_reorder", PE + "--batch-size 8 --reorder", []),
    ("un_al_conc", PE + "--un-conc {d}/uc.fq --al-conc {d}/ac.fq",
     ["uc.1.fq", "uc.2.fq", "ac.1.fq", "ac.2.fq"]),
    ("un_conc_pattern_summary", PE + "--un-conc {d}/u%.fq --new-summary -t",
     ["u1.fq", "u2.fq"]),
]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return flag_data(tmp_path_factory.mktemp("tflags_pe_out"))


@pytest.mark.parametrize("case,cmd,side", CASES, ids=[c[0] for c in CASES])
def test_pe_output_flags(data, capsys, case, cmd, side):
    d = data["dir"]
    argv = shlex.split(cmd.format(d=d))
    t = both("align", argv, [str(d / "o.sam")] + [str(d / s) for s in side],
             capsys)
    assert t["rc"] == 0
    recs = [ln.split("\t") for ln in t["files"]["o.sam"].decode()
            .splitlines() if not ln.startswith("@")]
    assert any(int(f[1]) & 2 for f in recs)
    for s in side:
        assert t["files"][s] is not None
