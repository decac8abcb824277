"""Shared by the port's CLI parity tests (tests/test_torch_cli*.py): one
command line through hisat2_tpu's main and then hisat2_tpu_torch's, on the
same input and output paths, and a comparison of everything each wrote.

The port's align runs get `--device cpu` as their last two arguments. Its
SAM header's @PG line carries the command line as given (CL:), so that
suffix is the one difference allowed there; `-t`'s `Time:` and the
timing and memory columns of `--met-file` lines are masked in both."""

from __future__ import annotations

import contextlib
import glob
import importlib
import os
import re

import numpy as np

import test_torch_native_cache  # noqa: F401  (JAX native libs, built once under a lock)
from hisat2_tpu.utils import alphabet

DEVICE = ["--device", "cpu"]
HT2FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "ht2fix")
_TIME = re.compile(r"Time: \d+\.\d+s")
# the "(N.Ns)" build clock that cli.build and cli.repeat print to stderr
_CLOCK = re.compile(r"\(\d+\.\d+s\)")
# MetricsSink columns that hold a clock, a rate or a memory size
_MET_MASKED = ("elapsed", "reads_per_sec", "bases_per_sec", "t_pack",
               "t_fetch", "t_gather", "t_host", "t_rescue", "dev_mb",
               "host_rss_mb")


def mains(tool: str):
    """(hisat2_tpu's main, hisat2_tpu_torch's main) of cli.<tool> or, for
    tools.<name>, of that tool."""
    pkg = "tools" if tool.startswith("tools.") else "cli"
    name = tool.split(".", 1)[-1]
    return tuple(importlib.import_module(f"{p}.{pkg}.{name}").main
                 for p in ("hisat2_tpu", "hisat2_tpu_torch"))


def _read(path):
    if not os.path.exists(path):
        return None
    with open(path, "rb") as fh:
        return fh.read()


@contextlib.contextmanager
def _one_finish_thread():
    """hisat2_tpu's streamed finishes on one worker thread. Its SE native
    finish reuses one scratch buffer per aligner (`_fin_scratch`), so two
    batches finishing at once on its three threads can swap their SAM
    text; the records a batch gets do not depend on the thread count.
    The port allocates its buffers per call and keeps its threads."""
    from hisat2_tpu.align import emit
    stream = emit._stream

    def one(al, items, writer, submit_fn, finish_fn, on_batch, depth,
            workers):
        return stream(al, items, writer, submit_fn, finish_fn, on_batch,
                      depth, min(workers, 1))

    emit._stream = one
    try:
        yield
    finally:
        emit._stream = stream


def run_one(main, argv, outs, capsys) -> dict:
    """main(argv) with the files `outs` removed first: its return code,
    stdout, stderr, and the bytes of each of `outs` (None if not
    written). hisat2_tpu's main runs with one finish thread."""
    for p in outs:
        if os.path.exists(p):
            os.remove(p)
    with (_one_finish_thread() if main.__module__.startswith("hisat2_tpu.")
          else contextlib.nullcontext()):
        rc = main(list(argv))
    cap = capsys.readouterr()
    return dict(rc=rc, out=cap.out, err=cap.err,
                files={os.path.basename(p): _read(p) for p in outs})


def _unpg(text: str) -> str:
    """The port's @PG line without its `--device cpu` suffix in CL."""
    return "".join(
        ln.replace(' --device cpu"', '"', 1) if ln.startswith("@PG\t")
        else ln for ln in text.splitlines(keepends=True))


def _mask_met(text: str) -> str:
    """MetricsSink lines (--met-file, or inside stderr with --met-stderr)
    with their clock, rate and memory columns masked."""
    cols = None
    drop = set()
    out = []
    for ln in text.splitlines(keepends=True):
        f = ln.rstrip("\n").split("\t")
        if f[0] == "elapsed":
            cols = f
            drop = {cols.index(c) for c in _MET_MASKED}
        elif cols is not None and len(f) == len(cols):
            ln = "\t".join("*" if i in drop else v
                           for i, v in enumerate(f)) + "\n"
        out.append(ln)
    return "".join(out)


def masked(text: str, port: bool) -> str:
    text = _mask_met(_CLOCK.sub("(*s)", _TIME.sub("Time: *", text)))
    return _unpg(text) if port else text


def _text_or_bytes(b):
    if b is None:
        return None
    try:
        return b.decode()
    except UnicodeDecodeError:
        return b


def assert_same(j: dict, t: dict) -> None:
    """Equal return codes, stdout, stderr and written files, under the
    @PG and timing rules above."""
    assert t["rc"] == j["rc"], (j["err"], t["err"])
    assert masked(t["out"], True) == masked(j["out"], False)
    assert masked(t["err"], True) == masked(j["err"], False)
    assert t["files"].keys() == j["files"].keys()
    for name, jb in j["files"].items():
        tb = t["files"][name]
        assert (tb is None) == (jb is None), name
        jt, tt = _text_or_bytes(jb), _text_or_bytes(tb)
        if isinstance(jt, str) and isinstance(tt, str):
            assert masked(tt, True) == masked(jt, False), name
        else:
            assert tb == jb, name


def both(tool: str, argv, outs, capsys):
    """Run argv through both packages' `tool` (the port's align with
    `--device cpu` appended), assert everything they wrote is the same,
    and return the port's result."""
    jmain, tmain = mains(tool)
    j = run_one(jmain, argv, outs, capsys)
    t = run_one(tmain, list(argv) + (DEVICE if tool == "align" else []),
                outs, capsys)
    assert_same(j, t)
    return t


def index_files(prefix: str) -> dict:
    """{file name: bytes} of every file an index build wrote at prefix."""
    return {os.path.basename(p): _read(p)
            for p in sorted(glob.glob(glob.escape(prefix) + ".*"))}


def build_both(argv, prefix: str, capsys=None) -> dict:
    """cli.build argv through hisat2_tpu, then hisat2_tpu_torch, into the
    same prefix; asserts both wrote the same files byte for byte (the
    port's build is left on disk) and returns them."""
    jmain, tmain = mains("build")
    got = []
    for main in (jmain, tmain):
        for p in glob.glob(glob.escape(prefix) + ".*"):
            os.remove(p)
        assert main(list(argv)) == 0
        if capsys is not None:
            capsys.readouterr()
        got.append(index_files(prefix))
    assert got[1].keys() == got[0].keys()
    for name in got[0]:
        assert got[1][name] == got[0][name], name
    return got[1]


def write_genome(path, codes, name="chrC", width=70) -> None:
    s = alphabet.decode(codes)
    with open(path, "w") as fh:
        fh.write(f">{name}\n")
        for i in range(0, len(s), width):
            fh.write(s[i:i + width] + "\n")


def write_fastq(path, reads) -> None:
    """reads: (name, sequence string[, quality string])."""
    with open(path, "w") as fh:
        for r in reads:
            q = r[2] if len(r) > 2 else "I" * len(r[1])
            fh.write(f"@{r[0]}\n{r[1]}\n+\n{q}\n")


def revcomp(codes: np.ndarray) -> np.ndarray:
    return 3 - codes[::-1]


# ---------------------------------------------------------------------------
# the flag tests' data (tests/test_torch_cli_flags*.py)
# ---------------------------------------------------------------------------

REPEAT_AT = (3000, 9000, 15000)       # one 300 bp unit copied three times
EXONS = ((20000, 20150), (20600, 20750), (21500, 21700))   # + strand gene


def flag_data(d, indexes=("idx",)) -> dict:
    """Genome, reads in every input format, and the indexes in `indexes`
    (each built by both packages, byte-equal) under directory d.

    Genome: chrF (32 kb; a 300 bp unit at REPEAT_AT, a three-exon gene
    with GT..AG introns at EXONS) and F2 (8 kb). SE reads (r.fq, quality
    I): 30 genomic reads with ~1% mismatches (3 with a 2 bp deletion), 6
    from the repeat, 4 carrying a g.snp alt allele, 12 across the gene's
    junctions, 2 random and 2 with Ns; the same reads as FASTA, raw, QSEQ (every fifth failing the
    filter), per-base qualities in phred33, phred64, Solexa and integer
    form, and 12 of the genomic pairs as tab6. Pairs (p1.fq/p2.fq): 16 FR
    pairs of 250-400 bp fragments, 2 overlapping, 2 containing, 2
    dovetailing, 2 with a random mate 2, and 6 from the spliced
    transcript (pt1.fq/pt2.fq)."""
    rng = np.random.default_rng(5)
    g = rng.integers(0, 4, 32000).astype(np.uint8)
    unit = g[100:400].copy()
    for p in REPEAT_AT:
        g[p:p + 300] = unit
    for (_, e), (a, _) in zip(EXONS, EXONS[1:]):
        g[e:e + 2] = (2, 3)           # GT
        g[a - 2:a] = (0, 2)           # AG
    g2 = rng.integers(0, 4, 8000).astype(np.uint8)
    with open(d / "g.fa", "w") as fh:
        for name, c in (("chrF", g), ("F2", g2)):
            s = alphabet.decode(c)
            fh.write(f">{name}\n")
            for i in range(0, len(s), 60):
                fh.write(s[i:i + 60] + "\n")
    tx = np.concatenate([g[s:e] for s, e in EXONS])
    (d / "g.ss").write_text("".join(
        f"chrF\t{e - 1}\t{a}\t+\n" for (_, e), (a, _) in zip(EXONS,
                                                            EXONS[1:])))
    (d / "g.snp").write_text("".join(
        f"rs{k}\tsingle\tchrF\t{p}\t{alphabet.decode([(int(g[p]) + 1) % 4])}"
        f"\n" for k, p in enumerate(range(1000, 31000, 700))))

    def mutate(c):
        c = c.copy()
        m = rng.random(c.size) < 0.01
        c[m] = (c[m] + rng.integers(1, 4, int(m.sum()))) % 4
        return c

    reads = []
    for i in range(30):
        p = int(rng.integers(0, 31000 - 110))
        c = g[p:p + 102]
        if i % 10 == 3:
            c = np.concatenate([c[:50], c[52:]])
        c = mutate(c[:100])
        if i % 2:
            c = revcomp(c)
        reads.append((f"g{i}_{p}", c))
    for i in range(6):
        off = int(rng.integers(0, 200))
        reads.append((f"rep{i}", unit[off:off + 100].copy()))
    for i, p in enumerate((1700, 5200, 11500, 24800)):
        c = g[p - 40:p + 60].copy()            # carries g.snp's alt at p
        c[40] = (c[40] + 1) % 4
        reads.append((f"alt{i}_{p - 40}", c))
    for i in range(12):
        off = int(rng.integers(60, tx.size - 160))
        c = mutate(tx[off:off + 100])
        reads.append((f"spl{i}_{off}", revcomp(c) if i % 3 == 0 else c))
    for i in range(2):
        reads.append((f"rnd{i}", rng.integers(0, 4, 100).astype(np.uint8)))
    for i in range(2):
        p = int(rng.integers(0, 7800))
        c = g2[p:p + 100].copy()
        c[[10, 40, 77]] = 4
        reads.append((f"n{i}_{p}", c))
    seqs = [(n, alphabet.decode(c)) for n, c in reads]
    write_fastq(d / "r.fq", seqs)
    with open(d / "r.fa", "w") as fh:
        fh.writelines(f">{n}\n{s}\n" for n, s in seqs)
    (d / "r.raw").write_text("".join(s + "\n" for _, s in seqs))
    quals = [rng.integers(2, 41, len(s)) for _, s in seqs]
    write_fastq(d / "r.q.fq", [(n, s, "".join(chr(33 + q) for q in qs))
                               for (n, s), qs in zip(seqs, quals)])
    write_fastq(d / "r.p64.fq", [(n, s, "".join(chr(64 + q) for q in qs))
                                 for (n, s), qs in zip(seqs, quals)])
    write_fastq(d / "r.sol.fq", [(n, s, "".join(chr(64 + q - 5) for q in qs))
                                 for (n, s), qs in zip(seqs, quals)])
    write_fastq(d / "r.int.fq", [(n, s, " ".join(str(q) for q in qs))
                                 for (n, s), qs in zip(seqs, quals)])
    with open(d / "r.qseq", "w") as fh:
        for k, ((n, s), qs) in enumerate(zip(seqs, quals)):
            q = "".join(chr(64 + x) for x in qs)
            fh.write(f"M1\t7\t1\t1\t{k}\t{k * 3}\t0\t1\t{s.replace('N', '.')}"
                     f"\t{q}\t{0 if k % 5 == 4 else 1}\n")
    (d / "small.fa").write_text(">chunk\n" + alphabet.decode(g[5000:6000])
                                + "\n")
    d_cmd = ",".join(s for _, s in seqs[:6])

    def pair(name, a, b):
        return ((name, alphabet.decode(a)), (name, alphabet.decode(b)))

    pairs = []
    for i in range(16):
        flen = int(rng.integers(250, 401))
        p = int(rng.integers(0, 31000 - flen))
        f = g[p:p + flen]
        m1, m2 = mutate(f[:100]), revcomp(mutate(f[-100:]))
        pairs.append(pair(f"pr{i}_{p}", *((m1, m2) if i % 2 else (m2, m1))))
    for i, (flen, shift) in enumerate(((150, 0), (130, 0), (100, 0),
                                       (100, 0), (100, 20), (100, 30))):
        p = int(rng.integers(0, 31000 - 300))
        f = g[p:p + flen + shift]
        if shift:                 # dovetail: mate 2 starts before mate 1
            a, b = f[shift:shift + 100], revcomp(f[:100])
        else:
            a, b = f[:100], revcomp(f[-100:])
        pairs.append(pair(f"ov{i}_{p}", a, b))
    for i in range(2):
        p = int(rng.integers(0, 31000 - 300))
        pairs.append(pair(f"dis{i}_{p}", g[p:p + 100],
                          rng.integers(0, 4, 100).astype(np.uint8)))
    write_fastq(d / "p1.fq", [a for a, _ in pairs])
    write_fastq(d / "p2.fq", [b for _, b in pairs])
    with open(d / "r.tab6", "w") as fh:
        for (n1, s1), (n2, s2) in pairs[:12]:
            fh.write(f"{n1}\t{s1}\t{'I' * len(s1)}\t{n2}\t{s2}\t"
                     f"{'I' * len(s2)}\n")
    tpairs = []
    for i in range(6):
        off = int(rng.integers(0, tx.size - 260))
        f = tx[off:off + 260]
        tpairs.append(pair(f"tp{i}_{off}", f[:100], revcomp(f[-100:])))
    write_fastq(d / "pt1.fq", [a for a, _ in tpairs])
    write_fastq(d / "pt2.fq", [b for _, b in tpairs])
    # ht2fix's genome: reads cut from it for the .ht2 prefixes
    from hisat2_tpu.io.reference import load_reference
    href = load_reference([os.path.join(HT2FIX, "g.fa")])
    hj = href.joined
    write_fastq(d / "h.fq", [(f"h{i}", alphabet.decode(
        hj[p:p + 100])) for i, p in enumerate(
            rng.integers(0, hj.size - 100, 20))])

    builds = {
        "idx": [],
        "gidx": ["--snp", str(d / "g.snp")],
        "ssidx": ["--ss", str(d / "g.ss")],
        "shidx": ["--shard-bases", "20000"],
    }
    for name in indexes:
        build_both(builds[name] + [str(d / "g.fa"), str(d / name),
                                   "--quiet"], str(d / name))
    return {"dir": d, "cmdline": d_cmd}

