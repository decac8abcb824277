"""The feeder's concatenated gzip through named pipes, read back by the
program's own read layer, and the sink's counts."""

import json
import os
import subprocess
import sys
import threading

import numpy as np

from harness import deploy, traffic

HARNESS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "harness")


def small_pool(mates, n=320):
    rng = np.random.default_rng(1)
    g = rng.integers(0, 4, 5000).astype(np.uint8)
    t = {"mix": "se_dna" if mates == 1 else "pe_dna", "read_len": 50, "indel_read_rate": 0.0, "indel_mate_rate": 0.0,
         "revcomp_rate": 0.5, "swap_rate": 0.5, "fragment": [120, 200],
         "quality": {"bins": [37, 25, 11, 2], "start": [0.9, 0.05, 0.03, 0.02],
                     "end": [0.8, 0.1, 0.05, 0.05]}}
    return (traffic.se_dna if mates == 1 else traffic.pe_dna)(g, n, 3, t)


def test_feeder_pipes_read_by_the_program(tmp_path):
    from hisat2_tpu_torch.io.reads import read_reads
    pool = small_pool(2)
    files = deploy.write_members(str(tmp_path), pool, 32)
    fifos = [str(tmp_path / f"r{m}.fq.gz") for m in (1, 2)]
    for f in fifos:
        os.mkfifo(f)
    res = str(tmp_path / "feed.json")
    p = subprocess.Popen([sys.executable, os.path.join(HARNESS, "feeder.py"),
                          "0.5", res, files[0], fifos[0],
                          files[1], fifos[1]])
    got = {}

    def read(m):
        got[m] = list(read_reads(fifos[m]))
    ts = [threading.Thread(target=read, args=(m,)) for m in (0, 1)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert p.wait(timeout=60) == 0
    r = json.load(open(res))
    assert r["reads"][0] == r["reads"][1] == len(got[0]) == len(got[1])
    assert r["members"] % 1 == 0 and len(got[0]) >= len(pool)   # cycled
    n = len(pool)
    for m in (0, 1):
        for k in (0, 31, 32, n - 1, n, len(got[m]) - 1):   # in order, cycled
            rd = got[m][k]
            i = k % n
            assert rd.name == pool.names[i]
            assert np.array_equal(rd.seq, pool.seqs[m, i])
            assert np.array_equal(rd.qual, pool.quals[m, i])


def test_sink_counts_and_keeps_first_appearance(tmp_path):
    fifo = str(tmp_path / "out.sam")
    os.mkfifo(fifo)
    names = tmp_path / "names.txt"
    names.write_text("a\nc\n")
    res = str(tmp_path / "sink.json")
    p = subprocess.Popen([sys.executable, os.path.join(HARNESS, "sink.py"),
                          fifo, str(names), res])
    lines = ["@HD\tVN:1.0", "a\t0\tc\t1", "a\t256\tc\t9", "b\t4\t*\t0",
             "c\t99\tc\t5", "c\t147\tc\t50", "a\t0\tc\t1", "c\t2048\tc\t3"]
    with open(fifo, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    assert p.wait(timeout=60) == 0
    r = json.load(open(res))
    assert r["records"] == 7 and r["primary"] == 5
    assert [ln.split("\t")[1] for ln in r["kept"]["a"]] == ["0", "256"]
    assert [ln.split("\t")[1] for ln in r["kept"]["c"]] == ["99", "147"]
    assert "b" not in r["kept"]
