"""The port's cli.align against hisat2_tpu's, flag set by flag set, paired
end: orientation, mixed/discordant and dovetail/contain/overlap (insert
sizes, reporting, scoring, batches and --un-conc/--al-conc are in
test_torch_cli_flags_pe_out.py). Both packages' mains run on the same
files; SAM, stdout, stderr and side files are compared byte for byte
(tests/torch_cli_common.py). Each flag set that the JAX package compiles
anew costs about 17 s of XLA compile here, so the file holds few of
them."""

import shlex

import pytest
import torch

from torch_cli_common import both, flag_data

torch.set_num_threads(1)

PE = ("-x {d}/idx -S {d}/o.sam --no-spliced-alignment "
      "-1 {d}/p1.fq -2 {d}/p2.fq ")

CASES = [
    ("default", PE),
    ("rf", PE + "--rf"),
    ("ff", PE + "--ff"),
    ("fr_explicit", PE + "--fr"),
    ("no_mixed", PE + "--no-mixed"),
    ("no_discordant", PE + "--no-discordant"),
    ("dovetail", PE + "--dovetail"),
    ("no_contain_no_overlap", PE + "--no-contain --no-overlap"),
    ("fasta_pairs", "-x {d}/idx -S {d}/o.sam --no-spliced-alignment "
     "-f -1 {d}/p1.fa -2 {d}/p2.fa"),
]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    out = flag_data(tmp_path_factory.mktemp("tflags_pe"))
    d = out["dir"]
    for k in (1, 2):
        lines = (d / f"p{k}.fq").read_text().splitlines()
        (d / f"p{k}.fa").write_text("".join(
            f">{lines[i][1:]}\n{lines[i + 1]}\n"
            for i in range(0, len(lines), 4)))
    return out


@pytest.mark.parametrize("case,cmd", CASES, ids=[c[0] for c in CASES])
def test_pe_flags(data, capsys, case, cmd):
    d = data["dir"]
    argv = shlex.split(cmd.format(d=d))
    t = both("align", argv, [str(d / "o.sam")], capsys)
    assert t["rc"] == 0
    recs = [ln.split("\t") for ln in t["files"]["o.sam"].decode()
            .splitlines() if not ln.startswith("@")]
    assert any(int(f[1]) & 2 for f in recs) or case in ("rf", "ff")
