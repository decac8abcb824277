"""One of two gloo processes for tests/test_torch_multihost.py: the
protocol of tests/_multihost_worker.py through the port
(hisat2_tpu_torch.parallel.multihost) on the CPU.

    python tests/torch_multihost_worker.py RANK 2 INIT_URL PREFIX OUT

Round-based spliced alignment over a shared 60 kb genome (the index at
PREFIX) with one planted junction per process:
  round 1 — reads across this process's own junction (long anchors,
            discoverable without help);
  sync    — novel sites exchanged (multihost.sync_splice_sites);
  round 2 — short-anchor reads across the OTHER process's junction,
            placeable only through the site it published.
Then the fused SE step once over the world-spanning mesh, 32 exact reads
from each process, its aligned count summed over both. Writes
OUT/rank<RANK>.json (SAM texts, adopted count, site table, totals) and
OUT/rank<RANK>.npz (the step's outputs)."""

import io
import json
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from hisat2_tpu_torch.align import emit  # noqa: E402
from hisat2_tpu_torch.align.pipeline import Aligner, AlignerOpts  # noqa: E402
from hisat2_tpu_torch.index.fm_index import FMIndex  # noqa: E402
from hisat2_tpu_torch.io import sam as samio  # noqa: E402
from hisat2_tpu_torch.io.reads import Read, batchify  # noqa: E402
from hisat2_tpu_torch.parallel import mesh as pm  # noqa: E402
from hisat2_tpu_torch.parallel import multihost as mh  # noqa: E402

IE = {0: 20000, 1: 40000}
ILEN = 900
GLOBAL_B, GLOBAL_L = 64, 64


def genome():
    """The shared genome, and the generator positioned after it (both
    processes then draw the same global-step reads, as the JAX worker
    does)."""
    rng = np.random.default_rng(5)
    g = rng.integers(0, 4, 60000).astype(np.uint8)
    for e in IE.values():
        g[e:e + 2] = [2, 3]
        g[e + ILEN - 2:e + ILEN] = [0, 2]
    return g, rng


def junction_seq(g, ie, far):
    return np.concatenate([g[ie - (100 - far):ie],
                           g[ie + ILEN:ie + ILEN + far]]).copy()


def round_seqs(g, pid):
    """(name, codes) of round 1's and round 2's reads of process pid."""
    r1 = [(f"p{pid}r1_{i}", junction_seq(g, IE[pid], 40 + i))
          for i in range(8)]
    r2 = [(f"p{pid}r2_{i}", junction_seq(g, IE[1 - pid], 2))
          for i in range(4)]
    return r1, r2


def global_seqs(g, rng, pid):
    """(name, codes) of process pid's reads of the global step."""
    out = []
    for i in range(GLOBAL_B // 2):
        st = int(rng.integers(0, g.size - GLOBAL_L))
        out.append((f"g{pid}_{i}", g[st:st + GLOBAL_L].copy()))
    return out


def make_batch(read_cls, batchify_fn, seqs, pad_to):
    return batchify_fn([read_cls(n, s, np.full(s.size, 40, np.int8), i)
                        for i, (n, s) in enumerate(seqs)], pad_to=pad_to)


def run_batch(al, seqs):
    b = make_batch(Read, batchify, seqs, 104)
    buf = io.StringIO()
    ref = al.fm.ref
    w = samio.SamWriter(buf, ref.names, [int(x) for x in ref.tlens],
                        no_head=True)
    emit.align_and_emit(al, b, w)
    w.flush()
    return buf.getvalue()


def main():
    pid, world, init, prefix, out = sys.argv[1:6]
    pid, world = int(pid), int(world)
    mh.init_distributed(init, world, pid, device="cpu")
    g, rng = genome()
    fm = FMIndex.load(prefix)
    assert np.array_equal(fm.ref.joined, g)
    al = Aligner(fm, opts=AlignerOpts(spliced=True), device="cpu")
    r1, r2 = round_seqs(g, pid)
    sam1 = run_batch(al, r1)
    adopted = mh.sync_splice_sites(al.ssdb)
    sam2 = run_batch(al, r2)

    mesh = mh.global_mesh(n_shards=1, device_type="cpu")
    b = make_batch(Read, batchify, global_seqs(g, rng, pid), GLOBAL_L)
    seq_w, n_w, _q, qconst, lens = b.packed()
    fn = pm.fused_se_sharded(mesh, al, [0], pm.replicate_index(al.idx, mesh),
                             GLOBAL_B, GLOBAL_L)
    sw, nw, ls = mh.shard_batch_global(mesh, seq_w, n_w, lens)
    fp, multi, mall, tot, mtot = fn(al.sctab, sw, nw, qconst, ls)
    sites = [[k[0], k[1], al.ssdb.strands.get(k, ".")]
             for k in sorted(al.ssdb.novel)]
    with open(os.path.join(out, f"rank{pid}.json"), "w") as fh:
        json.dump(dict(sam1=sam1, sam2=sam2, adopted=adopted, sites=sites,
                       global_aligned=int(tot), global_multi=int(mtot),
                       dp=mesh.get_local_rank("dp")), fh)
    np.savez(os.path.join(out, f"rank{pid}.npz"), fp=fp.numpy(),
             multi=multi.numpy(), mall=mall.numpy())
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
