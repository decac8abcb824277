"""The port's cli.align against hisat2_tpu's on other indexes and through
the drivers' own options: a graph (--snp) index with Zs:Z tags, a
genome-sharded index (--shard-bases) SE and PE with side files,
reference-built .ht2 prefixes, -A argument files, HISAT2_INDEXES,
--summary-file/--new-summary, --met-file/--met-stderr, and the refusals
(--sra-acc, --repeat on a sharded index, no reads). Both packages' mains
run on the same files; SAM, stdout, stderr and side files are compared
byte for byte (tests/torch_cli_common.py)."""

import shlex

import pytest
import torch

from torch_cli_common import (DEVICE, HT2FIX, assert_same, both, flag_data,
                              mains, run_one)

torch.set_num_threads(1)

NS = "-S {d}/o.sam --no-spliced-alignment "
SE = NS + "-U {d}/r.fq "
PE = NS + "-1 {d}/p1.fq -2 {d}/p2.fq "

# (case, command line with {d} the data directory and {h} ht2fix, side
# files, expected return code)
CASES = [
    ("graph_zs_tags", "-x {d}/gidx " + SE + "--zs-tags", [], 0),
    ("graph_pe", "-x {d}/gidx " + PE, [], 0),
    ("sharded_se", "-x {d}/shidx " + SE, [], 0),
    ("sharded_se_un_al", "-x {d}/shidx " + SE + "--un {d}/un.fq --al "
     "{d}/al.fq", ["un.fq", "al.fq"], 0),
    ("sharded_pe", "-x {d}/shidx " + PE, [], 0),
    ("sharded_pe_un_al_conc", "-x {d}/shidx " + PE + "--un-conc {d}/uc.fq "
     "--al-conc {d}/ac.fq", ["uc.1.fq", "uc.2.fq", "ac.1.fq", "ac.2.fq"], 0),
    ("ht2_linear", "-x {h}/lin -S {d}/o.sam --no-spliced-alignment "
     "-U {d}/h.fq", [], 0),
    ("ht2_graph", "-x {h}/snp -S {d}/o.sam --no-spliced-alignment "
     "-U {d}/h.fq", [], 0),
    ("new_summary_file", "-x {d}/idx " + SE + "--new-summary "
     "--summary-file {d}/sum.txt -t", ["sum.txt"], 0),
    ("summary_file", "-x {d}/idx " + SE + "--summary-file {d}/sum.txt",
     ["sum.txt"], 0),
    ("met_file", "-x {d}/idx " + SE + "--met-file {d}/met.tsv --met 100000",
     ["met.tsv"], 0),
    ("met_stderr", "-x {d}/idx " + SE + "--met-stderr --met 100000", [], 0),
    ("sam_to_stdout", "-x {d}/idx --no-spliced-alignment -U {d}/r.fq -t",
     [], 0),
    ("sra_acc", "-x {d}/idx " + SE + "--sra-acc SRR000001", [], 2),
    ("repeat_on_sharded", "-x {d}/shidx " + SE + "--repeat", [], 2),
    ("no_reads", "-x {d}/idx " + NS, [], 1),
]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return flag_data(tmp_path_factory.mktemp("tflags_idx"),
                     indexes=("idx", "gidx", "shidx"))


@pytest.mark.parametrize("case,cmd,side,rc", CASES,
                         ids=[c[0] for c in CASES])
def test_index_and_driver_flags(data, capsys, case, cmd, side, rc):
    d = data["dir"]
    argv = shlex.split(cmd.format(d=d, h=HT2FIX))
    t = both("align", argv, [str(d / "o.sam")] + [str(d / s) for s in side],
             capsys)
    assert t["rc"] == rc
    if rc == 0 and case != "sam_to_stdout":
        recs = [ln for ln in t["files"]["o.sam"].decode().splitlines()
                if not ln.startswith("@")]
        assert any(not int(ln.split("\t")[1]) & 4 for ln in recs)
    if case == "graph_zs_tags":
        assert "Zs:Z:" in t["files"]["o.sam"].decode()
    for s in side:
        assert t["files"][s] is not None


def test_arg_file(data, capsys):
    """-A: one invocation a line (the port's lines end in --device cpu)."""
    d = data["dir"]
    lines = [f"-x {d}/idx -U {d}/r.fq -S {d}/a1.sam --no-spliced-alignment "
             f"--quiet",
             "# a comment line",
             f"-x {d}/idx -1 {d}/p1.fq -2 {d}/p2.fq -S {d}/a2.sam "
             f"--no-spliced-alignment --quiet"]
    jmain, tmain = mains("align")
    (d / "args_j.txt").write_text("\n".join(lines) + "\n")
    (d / "args_t.txt").write_text("\n".join(
        ln if ln.startswith("#") else ln + " " + " ".join(DEVICE)
        for ln in lines) + "\n")
    outs = [str(d / "a1.sam"), str(d / "a2.sam")]
    j = run_one(jmain, ["-A", str(d / "args_j.txt")], outs, capsys)
    t = run_one(tmain, ["-A", str(d / "args_t.txt")], outs, capsys)
    assert_same(j, t)
    assert t["rc"] == 0 and all(t["files"].values())


def test_hisat2_indexes(data, capsys, monkeypatch):
    """HISAT2_INDEXES names the directory of an -x given without one."""
    d = data["dir"]
    monkeypatch.setenv("HISAT2_INDEXES", str(d))
    t = both("align", ["-x", "idx", "-U", str(d / "r.fq"), "-S",
                       str(d / "o.sam"), "--no-spliced-alignment"],
             [str(d / "o.sam")], capsys)
    assert t["rc"] == 0 and t["files"]["o.sam"]
