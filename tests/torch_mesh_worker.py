"""One rank of a gloo world on the CPU for tests/test_torch_mesh.py: runs
the port's fused mesh steps (hisat2_tpu_torch.parallel.mesh) on every
case of a spec file and saves this rank's outputs.

    python tests/torch_mesh_worker.py RANK WORLD INIT_URL N_SHARDS SPEC OUT

SPEC is a JSON list of cases {"name", "kind" (se, pe or rna), "index" (a
.sharded.json prefix), "arrays" (an .npz of the packed batch), "B", "L",
"known" ([left, right, strand] global sites, rna only)}. Writes
OUT/rank<RANK>.npz holding "<name>/<output>" arrays."""

import json
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from hisat2_tpu_torch.align.pipeline import AlignerOpts  # noqa: E402
from hisat2_tpu_torch.align.splice_db import SpliceSiteDB  # noqa: E402
from hisat2_tpu_torch.index.sharded import ShardedIndex  # noqa: E402
from hisat2_tpu_torch.parallel import mesh as pm  # noqa: E402
from hisat2_tpu_torch.parallel import multihost as mh  # noqa: E402

OUTPUTS = {
    "se": ("fp", "multi", "mall", "aligned_total", "multi_total"),
    "pe": ("pack", "force_slow", "m1_all", "m2_all", "pt_all", "conc_total"),
    "rna": ("fp", "multi", "l32", "l16", "cov", "aligned_total"),
}


def run_case(mesh, case):
    sh = ShardedIndex.load(case["index"])
    kind = case["kind"]
    # this rank's own shard, with shard 0's statics as hisat2_tpu's mesh
    # tests take them (ShardedAligner._activate(0)); its bundle is the
    # step's index, and stack_shard_indexes must give the same dict
    al0 = pm.shard_aligner(sh.shards, mesh,
                           opts=AlignerOpts(spliced=kind == "rna"))
    idx = al0.idx
    again = pm.stack_shard_indexes(sh.shards, mesh)
    assert again.keys() == idx.keys()
    for k, v in idx.items():
        assert (torch.equal(v, again[k]) if torch.is_tensor(v)
                else v == again[k]), k
    a = np.load(case["arrays"])
    B, L = case["B"], case["L"]
    if kind == "se":
        fn = pm.fused_se_sharded(mesh, al0, sh.bases, idx, B, L)
        outs = fn(al0.sctab, *pm.shard_batch(mesh, a["seq_w"], a["n_w"]),
                  int(a["qconst"]), *pm.shard_batch(mesh, a["lens"]))
    elif kind == "pe":
        fn = pm.fused_pe_sharded(mesh, al0, sh.bases, idx, B, L)
        outs = fn(al0.sctab, *pm.shard_batch(
            mesh, a["sw1"], a["nw1"], a["l1"], a["sw2"], a["nw2"], a["l2"]),
            int(a["qconst"]))
    else:
        db = SpliceSiteDB()
        for left, right, strand in case["known"]:
            db.add_known(left, right, strand)
        fn = pm.fused_rna_sharded(mesh, al0, sh.bases, idx, B, L,
                                  db.device_arrays4(pm.mesh_device(mesh)))
        outs = fn(al0.sctab, *pm.shard_batch(mesh, a["seq_w"], a["n_w"]),
                  int(a["qconst"]), *pm.shard_batch(mesh, a["lens"]))
    return {f"{case['name']}/{k}": v.cpu().numpy()
            for k, v in zip(OUTPUTS[kind], outs)}


def main():
    rank, world, init, n_shards, spec, out = sys.argv[1:7]
    rank, world, n_shards = int(rank), int(world), int(n_shards)
    mh.init_distributed(init, world, rank, device="cpu")
    mesh = pm.make_mesh(world, n_shards=n_shards, device_type="cpu")
    res = {"coord": np.asarray([mesh.get_local_rank("dp"),
                                mesh.get_local_rank("shard")])}
    with open(spec) as fh:
        for case in json.load(fh):
            res.update(run_case(mesh, case))
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
