"""The port's multi-host path (hisat2_tpu_torch.parallel.multihost) in a
2-process gloo world on the CPU, against hisat2_tpu in this process.

Each rank runs tests/_multihost_worker.py's protocol through the port
(tests/torch_multihost_worker.py): spliced round 1 over its own planted
junction, sync_splice_sites, round 2 over the other rank's junction with
2 bp far anchors, then the fused SE step over the world-spanning mesh
with 32 reads a rank. The oracle runs hisat2_tpu's aligner through the
same rounds for each rank, with the union of both ranks' round-1 sites
applied in sync_splice_sites' order (sorted by left, then right; sites
already held skipped), and hisat2_tpu's fused SE step on a (2, 1) mesh
over both ranks' reads. Checks: each rank's SAM bytes equal the oracle's,
both ranks end with the oracle's site table, each adopts at least one
site and places a round-2 read spliced, the step's dp blocks equal
hisat2_tpu's and the summed aligned count is 64 on both ranks."""

import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_native_cache  # noqa: F401  (JAX native libs, built once under a lock)
import torch_multihost_worker as wk
from torch_world import World
from hisat2_tpu.align import emit as jemit
from hisat2_tpu.align.pipeline import Aligner as JAligner
from hisat2_tpu.index.fm_index import build_fm_index
from hisat2_tpu.io import sam as jsam
from hisat2_tpu.io.reads import Read as JRead, batchify as jbatchify
from hisat2_tpu.io.reference import reference_from_seqs
from hisat2_tpu.parallel import mesh as jmesh
from hisat2_tpu.utils import alphabet

torch.set_num_threads(1)

WORLD_TIMEOUT = 600


def _jax_round(al, seqs):
    b = wk.make_batch(JRead, jbatchify, seqs, 104)
    buf = io.StringIO()
    ref = al.fm.ref
    w = jsam.SamWriter(buf, ref.names, [int(x) for x in ref.tlens],
                       no_head=True)
    jemit.align_and_emit(al, b, w)
    w.flush()
    return buf.getvalue()


def _jax_sync(dbs):
    """sync_splice_sites' union over every process's table, applied to
    each: rows of (left, right, strand) in lexsort order, held sites
    skipped. Returns the adopted count of each."""
    rows = [(k[0], k[1], db.strands.get(k, "."))
            for db in dbs for k in sorted(db.novel)]
    rows.sort(key=lambda r: r[:2])            # stable, as np.lexsort
    adopted = []
    for db in dbs:
        n = 0
        for left, right, strand in rows:
            if (left, right) in db.novel or (left, right) in db.known:
                continue
            db.add_novel(left, right, strand)
            n += 1
        adopted.append(n)
    return adopted


@pytest.fixture(scope="module")
def hosts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multihost")
    g, _rng = wk.genome()
    fm = build_fm_index(reference_from_seqs({"chrM": alphabet.decode(g)}))
    prefix = str(tmp / "idx")
    fm.save(prefix)
    world = World("torch_multihost_worker.py", 2, tmp, [prefix, tmp])

    # hisat2_tpu through the same rounds, one aligner per process
    als = []
    for _pid in (0, 1):
        al = JAligner(fm)
        al.opts.spliced = True
        als.append(al)
    rounds = [wk.round_seqs(g, pid) for pid in (0, 1)]
    sam1 = [_jax_round(al, r[0]) for al, r in zip(als, rounds)]
    adopted = _jax_sync([al.ssdb for al in als])
    sam2 = [_jax_round(al, r[1]) for al, r in zip(als, rounds)]
    sites = [[[k[0], k[1], al.ssdb.strands.get(k, ".")]
              for k in sorted(al.ssdb.novel)] for al in als]
    # each process draws its reads from its own generator, positioned
    # after the genome: the same starts on both
    gseqs = [s for pid in (0, 1)
             for s in wk.global_seqs(g, wk.genome()[1], pid)]
    b = wk.make_batch(JRead, jbatchify, gseqs, wk.GLOBAL_L)
    mesh = jmesh.make_mesh(2, n_shards=1)
    fn = jmesh.fused_se_sharded(mesh, als[0], [0],
                                jmesh.stack_shard_indexes([fm], mesh),
                                wk.GLOBAL_B, wk.GLOBAL_L)
    seq_w, n_w, _q, qc, lens = b.packed()
    sw, nw, ls = jmesh.shard_batch(mesh, seq_w, n_w, lens)
    step = [np.asarray(o) for o in fn(als[0].sctab, sw, nw, jnp.int32(qc),
                                      ls)]

    world.join(WORLD_TIMEOUT)
    ranks = []
    for pid in (0, 1):
        with open(tmp / f"rank{pid}.json") as fh:
            r = json.load(fh)
        r.update(np.load(tmp / f"rank{pid}.npz"))
        ranks.append(r)
    return dict(ranks=ranks, sam1=sam1, sam2=sam2, adopted=adopted,
                sites=sites, step=step)


@pytest.mark.parametrize("pid", [0, 1])
def test_rank_sam_bytes(hosts, pid):
    r = hosts["ranks"][pid]
    assert r["sam1"] == hosts["sam1"][pid]
    assert r["sam2"] == hosts["sam2"][pid]
    # round 2 places reads through the other process's junction
    assert sum(f"{wk.ILEN}N" in ln.split("\t")[5]
               for ln in r["sam2"].splitlines()) >= 1


@pytest.mark.parametrize("pid", [0, 1])
def test_rank_site_tables(hosts, pid):
    r = hosts["ranks"][pid]
    assert r["adopted"] == hosts["adopted"][pid] >= 1
    assert r["sites"] == hosts["sites"][pid] == hosts["sites"][1 - pid]


@pytest.mark.parametrize("pid", [0, 1])
def test_global_mesh_step(hosts, pid):
    r = hosts["ranks"][pid]
    fp, multi, mall, tot, mtot = hosts["step"]
    assert r["dp"] == pid
    Bl = wk.GLOBAL_B // 2
    rows = slice(pid * Bl, (pid + 1) * Bl)
    for k, want in (("fp", fp), ("multi", multi), ("mall", mall)):
        assert r[k].dtype == want.dtype
        np.testing.assert_array_equal(r[k], want[rows], err_msg=k)
    assert r["global_aligned"] == int(tot) == wk.GLOBAL_B
    assert r["global_multi"] == int(mtot)
