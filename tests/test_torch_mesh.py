"""The port's device mesh (hisat2_tpu_torch.parallel.mesh) against
hisat2_tpu.parallel.mesh, exactly.

The merges run in this process on seeded random int16 packs: ties between
shards, reads that no shard places, -32768 sentinels, and positions whose
rebase carries across bit 16 and past 2^31 (int32-wrapped shard bases).

The fused steps run in gloo worlds on the CPU, one process a rank (as on
several GPUs), one world per mesh shape: 2 x 2 (dp x shard) on two-shard
genomes and 4 x 1 on the same genomes in one shard. Each world runs the
cases of hisat2_tpu's own mesh tests: SE on test_mesh_full's genome (two
15 kb chromosomes, 64 reads of 80 bp at 2% mismatches), PE on
test_mesh_pe's _make_pairs (32 pairs) on the same genome, and RNA on
test_mesh_rna's planted junctions (32 reads; one junction given as a
known site). The oracle is hisat2_tpu's fused step on the same mesh shape
(the first 4 of conftest's 8 virtual CPU devices), since every bucket
depends on the rows a rank holds. Ranks of one dp row must hold identical
blocks; the dp blocks, in dp order, must equal JAX's dp-sharded arrays;
the sums equal its psums. Then the port's finish of the port's outputs
must give the SAM bytes and stats of hisat2_tpu's finish of its own."""

import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_native_cache  # noqa: F401  (JAX native libs, built once under a lock)
from test_mesh_pe import _make_pairs
from test_mesh_rna import _plant_junction
from torch_world import World
from hisat2_tpu.align.emit import (_finish_fastpack as j_finish_se,
                                   _finish_pe_pack as j_finish_pe)
from hisat2_tpu.align.pipeline import FASTPACK_REP
from hisat2_tpu.align.sharded import ShardedAligner as JShardedAligner
from hisat2_tpu.index.sharded import build_sharded
from hisat2_tpu.io import sam as jsam
from hisat2_tpu.io.reads import Read as JRead, batchify as jbatchify
from hisat2_tpu.io.reference import reference_from_seqs
from hisat2_tpu.parallel import mesh as jmesh
from hisat2_tpu.utils import alphabet

from hisat2_tpu_torch.align.emit import (_finish_fastpack as t_finish_se,
                                         _finish_pe_pack as t_finish_pe)
from hisat2_tpu_torch.align.sharded import ShardedAligner as TShardedAligner
from hisat2_tpu_torch.index.sharded import ShardedIndex as TShardedIndex
from hisat2_tpu_torch.io import sam as tsam
from hisat2_tpu_torch.io.reads import Read as TRead, batchify as tbatchify
from hisat2_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

WORLD = 4
SHAPES = {"2x2": 2, "4x1": 1}            # name -> n_shards
KINDS = ("se", "pe", "rna")
WORLD_TIMEOUT = 600
RNA_KNOWN = [(12000 + 5000 - 1, 12000 + 5000 + 700, "+")]   # chr2's junction


# ---------------------------------------------------------------------------
# the merges, in process
# ---------------------------------------------------------------------------

def _packs(seed, S, B, W, flag_lanes, pos_lanes):
    """Random (S, B, W) int16 packs: nv 0-2 (no shard places the first
    eighth of the reads), best scores with cross-shard ties, -32768
    sentinels in best and secbest, 4-bit flag lanes, and (lo, hi)
    position lanes anywhere in 16 bits, lo within 64 of 0xFFFF on a
    quarter of the reads (the rebase carries into hi)."""
    rng = np.random.default_rng(seed)
    p = rng.integers(-32768, 32768, (S, B, W)).astype(np.int16)
    p[:, :, 0] = rng.integers(0, 3, (S, B))
    p[:, :B // 8, 0] = 0
    p[:, :, 1] = rng.integers(-40, 1, (S, B))
    tie = rng.random(B) < 0.3
    p[:, tie, 1] = p[0, tie, 1]
    p[:, rng.random(B) < 0.1, 1] = -32768
    p[:, :, 2] = np.where(rng.random((S, B)) < 0.3, -32768,
                          rng.integers(-60, 1, (S, B)))
    for c in flag_lanes:
        p[:, :, c] = rng.integers(0, 16, (S, B))
    for lo, _hi in pos_lanes:
        p[:, B // 4:B // 2, lo] = -1 - rng.integers(0, 64, (S, B // 4))
    return p


BASES = {
    "small": [0, 15000, 30000],
    "carry16": [0, 65000, 131000],
    "past2e31": [0, (1 << 31) - 100, (1 << 31) + 70000],
    "past2e32wrap": [0, (1 << 32) - 50, 3_000_000_000],
}


def _bases32(b):
    return np.asarray(b, np.int64).astype(np.int32)


@pytest.mark.parametrize("bases", list(BASES))
def test_merge_fp_device_matches_jax(bases):
    KF = 5
    W = 4 + FASTPACK_REP * KF
    pos = [(4 + FASTPACK_REP * k, 5 + FASTPACK_REP * k) for k in range(KF)]
    p = _packs(1, 3, 64, W, [3], pos)
    b32 = _bases32(BASES[bases])
    want = jmesh._merge_fp_device(jnp.asarray(p), jnp.asarray(b32), KF)
    got = tmesh._merge_fp_device(torch.from_numpy(p), torch.from_numpy(b32),
                                 KF)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
    # int32-widened packs (what the mesh gathers) merge the same
    got32 = tmesh._merge_fp_device(torch.from_numpy(p.astype(np.int32)),
                                   torch.from_numpy(b32), KF)
    assert torch.equal(got32[0], got[0]) and torch.equal(got32[1], got[1])


@pytest.mark.parametrize("bases", list(BASES))
def test_merge_pe_pack_device_matches_jax(bases):
    from hisat2_tpu.align.paired import (PEPACK_HDR, PEPACK_MATE,
                                         PEPACK_REP)
    NR = 2
    W = PEPACK_HDR + NR * PEPACK_REP + 1
    pos = [(b, b + 1) for b in (PEPACK_HDR + PEPACK_REP * k + 1
                                 + m * PEPACK_MATE
                                 for k in range(NR) for m in (0, 1))]
    p = _packs(2, 3, 64, W, [PEPACK_HDR + PEPACK_REP * k
                             for k in range(NR)] + [W - 1], pos)
    b32 = _bases32(BASES[bases])
    want = jmesh._merge_pe_pack_device(jnp.asarray(p), jnp.asarray(b32))
    got = tmesh._merge_pe_pack_device(torch.from_numpy(p),
                                      torch.from_numpy(b32))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# the fused steps, in gloo worlds
# ---------------------------------------------------------------------------

def _dna_genome():
    """test_mesh_full's genome and SE reads; test_mesh_pe's pairs on it."""
    rng = np.random.default_rng(33)
    chroms = {f"chr{k}": alphabet.decode(
        rng.integers(0, 4, 15000).astype(np.uint8)) for k in (1, 2)}
    ref = reference_from_seqs(chroms)
    joined = ref.joined
    reads = []
    for i in range(64):
        st = int(rng.integers(0, joined.size - 80))
        s = joined[st:st + 80].copy()
        mm = rng.random(80) < 0.02
        s[mm] = (s[mm] + rng.integers(1, 4, int(mm.sum()))) % 4
        if rng.random() < 0.5:
            s = alphabet.revcomp(s)
        reads.append((f"m{i}_{st}", s))
    b1, b2 = _make_pairs(np.random.default_rng(45), joined, 32, frag=200)
    return ref, reads, (b1, b2)


def _rna_genome():
    """test_mesh_rna's genome with its planted junctions and reads."""
    rng = np.random.default_rng(3)
    chroms, raw = {}, {}
    for k in (1, 2):
        g = rng.integers(0, 4, 12000).astype(np.uint8)
        _plant_junction(g, 5000, 700)
        chroms[f"chr{k}"] = alphabet.decode(g)
        raw[k] = g
    ref = reference_from_seqs(chroms)
    reads = []
    for i in range(32):
        g = raw[1 + i % 2]
        if i < 16:
            s = np.concatenate([g[5000 - 32:5000], g[5700:5700 + 32]])
        else:
            st = int(rng.integers(0, 8000))
            s = g[st:st + 64].copy()
        reads.append((f"r{i}", s.copy()))
    return ref, reads


def _batches(reads, L):
    q = np.full(L, 40, np.int8)
    return (jbatchify([JRead(n, s, q[:s.size], i)
                       for i, (n, s) in enumerate(reads)], pad_to=L),
            tbatchify([TRead(n, s, q[:s.size], i)
                       for i, (n, s) in enumerate(reads)], pad_to=L))


def _tbatch(jb):
    """The port's batch of a JAX batch's reads."""
    return tbatchify([TRead(jb.names[i], jb.seqs[i, :jb.lens[i]].copy(),
                            jb.quals[i, :jb.lens[i]].copy(), i)
                      for i in range(len(jb))], pad_to=jb.seqs.shape[1])


def _jax_case(kind, sh, mesh, jb, n_shards):
    """hisat2_tpu's fused step on `mesh`, as its mesh tests drive it."""
    sa = JShardedAligner(sh)
    al0 = sa._activate(0)
    idx_stack = jmesh.stack_shard_indexes(sh.shards, mesh)
    if kind == "pe":
        b1, b2 = jb
        fn = jmesh.fused_pe_sharded(mesh, al0, sh.bases, idx_stack,
                                    len(b1), b1.seqs.shape[1])
        sw1, nw1, _q, qc, l1 = b1.packed()
        sw2, nw2, _q2, _qc2, l2 = b2.packed()
        outs = fn(al0.sctab, *jmesh.shard_batch(
            mesh, sw1, nw1, l1, sw2, nw2, l2), jnp.int32(qc))
    else:
        seq_w, n_w, _q, qc, lens = jb.packed()
        if kind == "se":
            fn = jmesh.fused_se_sharded(mesh, al0, sh.bases, idx_stack,
                                        len(jb), jb.seqs.shape[1])
        else:
            al0.opts.spliced = True
            for left, right, strand in RNA_KNOWN:
                al0.ssdb.add_known(left, right, strand)
            fn = jmesh.fused_rna_sharded(mesh, al0, sh.bases, idx_stack,
                                         len(jb), jb.seqs.shape[1],
                                         al0.ssdb.device_arrays4())
        sw, nw, ld = jmesh.shard_batch(mesh, seq_w, n_w, lens)
        outs = fn(al0.sctab, sw, nw, jnp.int32(qc), ld)
    return [np.asarray(o) for o in outs]


def _save_arrays(path, kind, jb):
    if kind == "pe":
        b1, b2 = jb
        sw1, nw1, _q, qc, l1 = b1.packed()
        sw2, nw2, _q2, _qc2, l2 = b2.packed()
        np.savez(path, sw1=sw1, nw1=nw1, l1=l1, sw2=sw2, nw2=nw2, l2=l2,
                 qconst=qc)
    else:
        seq_w, n_w, _q, qc, lens = jb.packed()
        np.savez(path, seq_w=seq_w, n_w=n_w, lens=lens, qconst=qc)


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """Both worlds' per-rank outputs beside hisat2_tpu's, and what the
    finishes need."""
    tmp = tmp_path_factory.mktemp("mesh")
    ref, se_reads, (pb1, pb2) = _dna_genome()
    rref, rna_reads = _rna_genome()
    jse, tse = _batches(se_reads, 80)
    jrna, _ = _batches(rna_reads, 64)
    jbs = {"se": jse, "pe": (pb1, pb2), "rna": jrna}
    tbs = {"se": tse, "pe": (_tbatch(pb1), _tbatch(pb2))}
    sh = {}
    for name, n_shards in SHAPES.items():
        # 2 x 2 takes the two-shard genomes, 4 x 1 the same in one shard
        mb = {2: (16000, 13000), 1: (1 << 30, 1 << 30)}[n_shards]
        sh[name, "dna"] = build_sharded(ref, max_bases=mb[0])
        sh[name, "rna"] = build_sharded(rref, max_bases=mb[1])
        assert len(sh[name, "dna"]) == len(sh[name, "rna"]) == n_shards
    worlds = {}
    for name, n_shards in SHAPES.items():
        d = tmp / name
        d.mkdir()
        for g in ("dna", "rna"):
            sh[name, g].save(str(d / f"idx_{g}"))
        spec = []
        for kind in KINDS:
            prefix = str(d / f"idx_{'rna' if kind == 'rna' else 'dna'}")
            _save_arrays(d / f"{kind}.npz", kind, jbs[kind])
            jb = jbs[kind][0] if kind == "pe" else jbs[kind]
            spec.append(dict(name=kind, kind=kind, index=prefix,
                             arrays=str(d / f"{kind}.npz"), B=len(jb),
                             L=int(jb.seqs.shape[1]), known=RNA_KNOWN))
        with open(d / "spec.json", "w") as fh:
            json.dump(spec, fh)
        worlds[name] = World("torch_mesh_worker.py", WORLD, d,
                             [n_shards, d / "spec.json", d])
    # hisat2_tpu's steps while the worlds run
    jax_out = {}
    for name, n_shards in SHAPES.items():
        mesh = jmesh.make_mesh(WORLD, n_shards=n_shards)
        for kind in KINDS:
            g = "rna" if kind == "rna" else "dna"
            jax_out[name, kind] = _jax_case(kind, sh[name, g], mesh,
                                            jbs[kind], n_shards)
    ranks = {}
    for name in SHAPES:
        worlds[name].join(WORLD_TIMEOUT)
        ranks[name] = [dict(np.load(tmp / name / f"rank{r}.npz"))
                       for r in range(WORLD)]
    return dict(jax=jax_out, ranks=ranks, sh=sh, jbs=jbs, tbs=tbs,
                tmp=tmp)


def _assembled(meshes, name, kind):
    """The port's outputs as hisat2_tpu returns them: dp blocks in dp
    order (the shard column of a dp row must agree), sums once."""
    S = SHAPES[name]
    ndp = WORLD // S
    ranks = meshes["ranks"][name]
    for r in range(WORLD):
        assert list(ranks[r]["coord"]) == [r // S, r % S]
    keys = [k for k in ranks[0] if k.startswith(kind + "/")]
    out = {}
    for k in keys:
        blocks = []
        for d in range(ndp):
            row = [ranks[d * S + s][k] for s in range(S)]
            for other in row[1:]:
                np.testing.assert_array_equal(other, row[0])
            blocks.append(row[0])
        if k.endswith("_total"):
            assert all(np.array_equal(b, blocks[0]) for b in blocks), k
            out[k.split("/")[1]] = blocks[0]
        else:
            out[k.split("/")[1]] = np.concatenate(blocks)
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", list(SHAPES))
def test_fused_step_matches_jax(meshes, name, kind):
    got = _assembled(meshes, name, kind)
    want = meshes["jax"][name, kind]
    from torch_mesh_worker import OUTPUTS
    assert list(got) == list(OUTPUTS[kind])
    for (k, g), w in zip(got.items(), want):
        if k.endswith("_total"):
            assert int(g) == int(w), k
        else:
            assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=k)
    if kind == "rna":
        # exonic exact reads all align through the merged fastpack, and
        # the lanes carry live junctions
        assert (got["fp"][16:, 0] >= 1).all()
        assert (got["l16"][:, 4] != 0).any()


def _sam_of(fn, sammod, host):
    ref = host.fm.ref
    buf = io.StringIO()
    w = sammod.SamWriter(buf, ref.names, [int(x) for x in ref.tlens],
                         no_head=True)
    st = fn(w)
    w.flush()
    return buf.getvalue(), st


def _merged_full(mall):
    return dict(score=mall[:, :, 0].astype(np.int64),
                pos=mall[:, :, 1].astype(np.int64),
                fw=(mall[:, :, 2] & 1) > 0, gapped=(mall[:, :, 2] & 2) > 0)


@pytest.mark.parametrize("kind", ["se", "pe"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_mesh_sam_matches_jax(meshes, name, kind):
    """The port's finish of the port's mesh outputs == hisat2_tpu's finish
    of its own: SAM bytes and stats."""
    got = _assembled(meshes, name, kind)
    want = meshes["jax"][name, kind]
    jsh = meshes["sh"][name, "dna"]
    tsh = TShardedIndex.load(str(meshes["tmp"] / name / "idx_dna"))
    jhost = JShardedAligner(jsh).host
    thost = TShardedAligner(tsh, device="cpu").host
    jb, tb = meshes["jbs"][kind], meshes["tbs"][kind]
    if kind == "se":
        fp, multi, mall, _, _ = want
        jt, js = _sam_of(lambda w: j_finish_se(
            jhost, jb, fp, None, w, force_slow=multi,
            merged_full=_merged_full(mall)), jsam, jhost)
        tt, ts = _sam_of(lambda w: t_finish_se(
            thost, tb, got["fp"], None, w, None, force_slow=got["multi"],
            merged_full=_merged_full(got["mall"])), tsam, thost)
        assert int(got["aligned_total"]) == len(jb) - ts["unal"]
    else:
        pack, fslow, m1, m2, pt, _ = want
        jt, js = _sam_of(lambda w: j_finish_pe(
            jhost, jb[0], jb[1], (pack, m1, m2, pt), w, force_slow=fslow),
            jsam, jhost)
        tt, ts = _sam_of(lambda w: t_finish_pe(
            thost, tb[0], tb[1], (got["pack"], got["m1_all"],
                                  got["m2_all"], got["pt_all"], None, None),
            w, force_slow=got["force_slow"]), tsam, thost)
        assert int(got["conc_total"]) == ts["conc_uniq"] + ts["conc_multi"]
    assert ts == js
    assert tt == jt
    assert len(tt.splitlines()) >= (2 if kind == "pe" else 1) * len(
        jb[0] if kind == "pe" else jb)


def test_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError):
        tmesh.make_mesh(1, device_type="cpu")


def test_mesh_pe_rescue_cap_matches_jax(tmp_path):
    """A reference behaviour, matched and pinned: the mesh PE step has no
    in-step mate rescue (hisat2_tpu passes RB = 0), so the finish cannot
    tell failed rescues from untried ones, and every pair with one mate
    aligned enters the ladder's rescue list, which rescues at most 512
    mates a batch in pair order. 640 pairs: the first 512 with a random
    mate 2 (no rescue can pass), the last 128 with a mate 2 that no seed
    places (an N every 8 bases) but whose window DP passes. The
    single-card packed step rescues the first 512 in the step, proves them
    failed, and the ladder rescues the 128; the mesh's ladder spends its
    512 on the hopeless ones. Both packages give the same bytes on both
    paths (ROADMAP Queue C)."""
    import torch.distributed as dist
    from hisat2_tpu.align import paired as jpaired
    from hisat2_tpu.align.pipeline import Aligner as JAligner
    from hisat2_tpu.index.fm_index import build_fm_index
    from hisat2_tpu_torch.align import paired as tpaired
    from hisat2_tpu_torch.align.pipeline import Aligner as TAligner
    from hisat2_tpu_torch.index.fm_index import FMIndex
    rng = np.random.default_rng(46)
    g = rng.integers(0, 4, 30000).astype(np.uint8)
    jfm = build_fm_index(reference_from_seqs({"chrR": alphabet.decode(g)}))
    n = 640
    pairs = []
    for i in range(n):
        st = int(rng.integers(0, g.size - 300))
        m2 = alphabet.revcomp(g[st + 200:st + 300]).copy()
        if i < 512:
            m2 = rng.integers(0, 4, 100).astype(np.uint8)
        else:
            m2[3::8] = 4
        pairs.append((f"q{i}", g[st:st + 100].copy(), m2))
    q = np.full(100, 40, np.int8)
    jb = [jbatchify([JRead(nm, p[m], q, i) for i, (nm, *p) in
                     enumerate(pairs)], pad_to=104) for m in (0, 1)]
    tb = [tbatchify([TRead(nm, p[m], q, i) for i, (nm, *p) in
                     enumerate(pairs)], pad_to=104) for m in (0, 1)]
    packed = [b.packed() for b in jb]
    sw1, nw1, _q, qc, l1 = packed[0]
    sw2, nw2, _q2, _qc2, l2 = packed[1]

    jal = JAligner(jfm)
    jm = jmesh.make_mesh(1, n_shards=1)
    pack, fs, m1, m2, pt, _ = (np.asarray(o) for o in jmesh.fused_pe_sharded(
        jm, jal, [0], jmesh.stack_shard_indexes([jfm], jm), n, 104)(
        jal.sctab, *jmesh.shard_batch(jm, sw1, nw1, l1, sw2, nw2, l2),
        jnp.int32(qc)))
    j_mesh = _sam_of(lambda w: j_finish_pe(jal, jb[0], jb[1],
                                           (pack, m1, m2, pt), w,
                                           force_slow=fs), jsam, jal)
    jout = jpaired.stage_pe_packed(jal, jb[0], jb[1],
                                   KP=max(8, jal.opts.khits + 3))
    j_single = _sam_of(lambda w: j_finish_pe(jal, jb[0], jb[1], jout, w),
                       jsam, jal)

    tal = TAligner(FMIndex.from_object(jfm), device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            world_size=1, rank=0)
    try:
        tm = tmesh.make_mesh(1, n_shards=1, device_type="cpu")
        out = tmesh.fused_pe_sharded(tm, tal, [0], tal.idx, n, 104)(
            tal.sctab, *tmesh.shard_batch(tm, sw1, nw1, l1, sw2, nw2, l2),
            int(qc))
    finally:
        dist.destroy_process_group()
    pack, fs, m1, m2, pt, _ = (o.numpy() for o in out)
    t_mesh = _sam_of(lambda w: t_finish_pe(
        tal, tb[0], tb[1], (pack, m1, m2, pt, None, None), w,
        force_slow=fs), tsam, tal)
    tout = tpaired.stage_pe_packed(tal, tb[0], tb[1],
                                   KP=max(8, tal.opts.khits + 3))
    t_single = _sam_of(lambda w: t_finish_pe(tal, tb[0], tb[1], tout, w),
                       tsam, tal)
    assert t_mesh == j_mesh and t_single == j_single
    assert t_single[1]["mixed_al"] == 512
    assert t_mesh[1]["mixed_al"] == n


def test_shard_aligner_takes_shard_0_statics():
    """A rank's aligner holds its own shard and only it, with the statics
    of shard 0 that hisat2_tpu's one mesh program takes: here shard 0 has
    70,000 bases (minimum anchor 9) and shard 1, this rank's, 20,000 (8)."""
    from hisat2_tpu.align.pipeline import Aligner as JAligner
    from hisat2_tpu.index.fm_index import build_fm_index
    from hisat2_tpu_torch.index.fm_index import FMIndex

    class RankOfShard1:
        device_type = "cpu"

        def get_local_rank(self, name):
            return {"dp": 0, "shard": 1}[name]
    rng = np.random.default_rng(47)
    jfms = [build_fm_index(reference_from_seqs(
        {f"c{i}": alphabet.decode(rng.integers(0, 4, n).astype(np.uint8))}))
        for i, n in enumerate((70000, 20000))]
    shards = [FMIndex.from_object(f) for f in jfms]
    al = tmesh.shard_aligner(shards, RankOfShard1())
    assert al.fm is shards[1] and al.device == torch.device("cpu")
    assert al.min_seg_len == JAligner(jfms[0]).min_seg_len == 9
    assert JAligner(jfms[1]).min_seg_len == 8
    idx = tmesh.stack_shard_indexes(shards, RankOfShard1())
    assert idx.keys() == al.idx.keys()
    for k, v in idx.items():
        assert (torch.equal(v, al.idx[k]) if torch.is_tensor(v)
                else v == al.idx[k]), k
