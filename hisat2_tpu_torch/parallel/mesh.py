"""Multi-device alignment: data-parallel reads x model-parallel genome
shards over a torch.distributed DeviceMesh (the PyTorch port of
hisat2_tpu's parallel/mesh.py).

The reference's unit of parallelism is a pthread pulling one read at a
time from a locked PatternSource (hisat2.cpp:3679-3696); its only
cross-thread state is the splice-site table and merged metrics. Here:

  * one process drives one device (multi-controller, as torchrun starts
    them); the mesh axes are ("dp", "shard") and rank d * n_shards + s
    sits at (d, s), the row-major order of hisat2_tpu's
    devices.reshape(n // n_shards, n_shards);
  * read batches split along dp: each rank takes its own block of rows
    (shard_batch); genome shards (index/sharded.py, shapes harmonized)
    split along shard: each rank holds only its own shard's index arrays
    (shard_aligner, stack_shard_indexes);
  * each rank runs the full fused step (pipeline._stage_align_packed or
    paired._stage_pe_packed_impl) on its (reads block, shard);
  * the per-shard packs all-gather over the shard group and merge to
    global coordinates on the device (the policy of the single-card
    shard-streaming merge, align/sharded.py);
  * the summary counters all-reduce over the dp group, so every rank sees
    whole-batch totals.

Collectives run on the mesh's device: NCCL for "cuda", gloo for "cpu".
Neither backend gathers int16, so the int16 packs travel widened to int32
(the merges widen them first anyway). Single-shard genomes degenerate to
pure data parallelism (shard axis 1).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..align.paired import (PEPACK_HDR, PEPACK_MATE, PEPACK_REP,
                            _stage_pe_packed_impl, pepack_nr)
from ..align.pipeline import (DEFAULT_SCORING, FASTPACK_REP, Aligner,
                              _stage_align_packed, min_anchor)
from ..ops.splice import MIN_ANCHOR_CANON

I32 = torch.int32
I64 = torch.int64
SENTINEL = 0x7FFFFFFF


def local_cuda_index(rank: int | None = None) -> int:
    """This process's card: LOCAL_RANK where torchrun set it, else the
    global rank (this process's in the group by default) modulo the cards
    of the host."""
    lr = os.environ.get("LOCAL_RANK")
    if lr is not None:
        return int(lr)
    if rank is None:
        rank = dist.get_rank()
    return rank % torch.cuda.device_count()


def make_mesh(n_devices: int | None = None, n_shards: int = 1,
              device_type: str = "cuda"):
    """The (dp, shard) DeviceMesh over every rank of the initialized
    process group (multihost.init_distributed, or torchrun's environment
    with dist.init_process_group). n_devices, where given, must be the
    world size. On "cuda" each rank takes its own card; a missing card
    raises, nothing falls back to the CPU."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel.multihost.init_distributed)")
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"a mesh of {n_devices} devices over a world of "
                         f"{n} ranks: one rank drives one device")
    if n % n_shards:
        raise ValueError(f"{n} ranks do not split into {n_shards} shards")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(device_type='cuda'): no CUDA "
                               "device")
        torch.cuda.set_device(local_cuda_index())
    return init_device_mesh(device_type, (n // n_shards, n_shards),
                            mesh_dim_names=("dp", "shard"))


def mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh, name: str) -> int:
    return int(mesh.shape[mesh.mesh_dim_names.index(name)])


def replicate_index(idx: dict, mesh) -> dict:
    """This rank's copy of an index dict, its tensors on the mesh's
    device (every rank holds the whole index)."""
    dev = mesh_device(mesh)
    return {k: v.to(dev) if torch.is_tensor(v) else v
            for k, v in idx.items()}


def stack_shard_indexes(shards, mesh) -> dict:
    """The device dict of this rank's own genome shard,
    shards[mesh.get_local_rank("shard")] (hisat2_tpu stacks every shard
    along a sharded leading axis; with one process a device each rank
    uploads only its own). The whole bundle is kept, config leaves
    included. A rank that built shard_aligner already holds this dict as
    its `idx`: pass that, not a second upload."""
    s = mesh.get_local_rank("shard")
    return shards[s].device_bundle(mesh_device(mesh))


def shard_aligner(shards, mesh, scoring=DEFAULT_SCORING,
                  opts=None) -> Aligner:
    """The aligner a rank hands the fused steps: built on this rank's own
    shard, on the mesh's device, so the one shard it uploads serves as the
    step's index (its `idx`). Its statics are those of shard 0, as
    hisat2_tpu's one program takes them: the shards are harmonized, and
    only the minimum anchor, ceil(log4 n), follows a shard's length."""
    al = Aligner(shards[mesh.get_local_rank("shard")], scoring=scoring,
                 opts=opts, device=mesh_device(mesh))
    al.min_seg_len = min_anchor(shards[0].n)
    return al


def shard_batch(mesh, *arrays):
    """This rank's dp block of host read-batch arrays, rows
    [d * Bl, (d + 1) * Bl), as tensors on its device (the batch must
    divide evenly; callers pad the final batch)."""
    ndp = axis_size(mesh, "dp")
    d = mesh.get_local_rank("dp")
    dev = mesh_device(mesh)
    out = []
    for a in arrays:
        a = np.asarray(a)
        B = a.shape[0]
        if B % ndp:
            raise ValueError(f"batch of {B} does not split over {ndp} dp "
                             f"ranks")
        Bl = B // ndp
        out.append(to_device(a[d * Bl:(d + 1) * Bl], dev))
    return tuple(out)


def to_device(a, dev: torch.device) -> torch.Tensor:
    """A host array as a tensor on `dev`; uint32 words widen to int64, as
    the steps take them."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(a).to(dev)


def gather(t: torch.Tensor, group) -> torch.Tensor:
    """(S, *t.shape): t of every rank of `group`, in group-rank order.
    The list form of all_gather, which both backends take."""
    n = dist.get_world_size(group)
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The int64 sum of a scalar over `group` (psum)."""
    x = x.to(I64).reshape(1)
    dist.all_reduce(x, group=group)
    return x[0]


def _wrap16(x: torch.Tensor) -> torch.Tensor:
    """int16 with the bits of x's low 16 (hisat2_tpu's (x << 16) >> 16)."""
    return (((x.to(I64) + 32768) & 0xFFFF) - 32768).to(torch.int16)


def _rebase(lo, hi, base_w):
    """Two 16-bit position lanes plus a shard base, as uint32 arithmetic
    in int64: the (lo, hi) lanes of the global position."""
    pos = (((lo.to(I64) & 0xFFFF) | ((hi.to(I64) & 0xFFFF) << 16))
           + base_w) & 0xFFFFFFFF
    return torch.stack([pos & 0xFFFF, (pos >> 16) & 0xFFFF], dim=1).to(I32)


def _pick_winner(pk: torch.Tensor, bases: torch.Tensor):
    """The shared head of both merges: the best-scoring shard of each
    read among those that place it (the first on ties), its row, its
    base (uint32, in int64), the shard hit counts and the scores with
    the winner's masked out."""
    S, B, _W = pk.shape
    nv = pk[:, :, 0]
    masked = torch.where(nv > 0, pk[:, :, 1], -32768)
    win = torch.argmax(masked, dim=0)
    hits = (nv > 0).sum(dim=0)
    ar = torch.arange(B, device=pk.device)
    fp = pk[win, ar]
    base_w = bases.to(pk.device).to(I64)[win] & 0xFFFFFFFF
    masked[win, ar] = -32768
    return fp, base_w, hits, masked


def _merge_fp_device(fps, bases, KF: int):
    """Device merge of per-shard SE fastpacks (align/sharded's host merge
    on tensors): fps (S, B, W) int16 or int32 -> (fp_global (B, W) int16,
    multi_hit (B,) bool)."""
    fpi = fps.to(I32)
    fp, base_w, hits, masked = _pick_winner(fpi, bases)
    cols = [fp[:, :4]]
    for k in range(KF):
        b0 = 4 + FASTPACK_REP * k
        cols.append(_rebase(fp[:, b0], fp[:, b0 + 1], base_w))
        cols.append(fp[:, b0 + 2:b0 + FASTPACK_REP])
    out = torch.cat(cols, dim=1)
    # cross-shard second best (beats the winner's in-shard secbest when a
    # different shard also places the read)
    out[:, 2] = torch.maximum(out[:, 2], masked.amax(dim=0))
    return _wrap16(out), hits >= 2


def _merge_pe_pack_device(packs, bases):
    """Device merge of per-shard PE packs (paired.PEPACK layout): packs
    (S, B, W) int16 or int32 -> (pack_global (B, W) int16, force_slow
    (B,) bool). Mates of a genuine pair share a chromosome, hence a
    shard, so each shard's concordance search is complete; the merge
    picks the best-total shard, rebases the 4 position lanes, folds other
    shards' best into secbest, and ORs the per-mate aux bits."""
    pk = packs.to(I32)
    W = pk.shape[2]
    fp, base_w, hits, masked = _pick_winner(pk, bases)
    cols = [fp[:, :PEPACK_HDR]]
    for k in range(pepack_nr(W)):
        rb = PEPACK_HDR + PEPACK_REP * k
        cols.append(fp[:, rb:rb + 1])          # per-report flag lane
        for m in range(2):
            b0 = rb + 1 + m * PEPACK_MATE
            cols.append(_rebase(fp[:, b0], fp[:, b0 + 1], base_w))
            cols.append(fp[:, b0 + 2:b0 + PEPACK_MATE])
    aux = pk[:, :, W - 1]
    cols.append(((aux & 1).amax(dim=0)
                 | (((aux >> 1) & 1).amax(dim=0) << 1))[:, None])
    out = torch.cat(cols, dim=1)
    out[:, 2] = torch.maximum(out[:, 2], masked.amax(dim=0))
    return _wrap16(out), hits >= 2


def _to_global(mg: torch.Tensor, bases: torch.Tensor, Bl: int):
    """(S, Bl, K, 3) per-shard [score, pos, flags] grids -> (Bl, S*K, 3)
    in global coordinates, shard-major along the second axis."""
    pos = mg[:, :, :, 1] + bases[:, None, None]
    g = torch.stack([mg[:, :, :, 0], pos, mg[:, :, :, 2]], dim=3)
    return g.movedim(0, 1).reshape(Bl, -1, 3)


def _sort_by_score(g: torch.Tensor) -> torch.Tensor:
    order = torch.argsort(-g[:, :, 0], dim=1, stable=True)
    return torch.take_along_dim(g, order[:, :, None], dim=1)


class _Step:
    """The statics one fused step shares with hisat2_tpu's call: every
    bucket and width derives from the rank's block of Bl reads."""

    def __init__(self, mesh, aligner, bases, B: int):
        o = aligner.opts
        self.al = aligner
        self.o = o
        self.sc = aligner.scoring
        self.K2 = min(2 * o.top_cands, max(8, o.khits + 3))
        self.ndp = axis_size(mesh, "dp")
        if B % self.ndp:
            raise ValueError(f"batch of {B} does not split over "
                             f"{self.ndp} dp ranks")
        self.Bl = B // self.ndp
        self.dev = mesh_device(mesh)
        b = np.asarray(bases, np.int64)
        if b.size != axis_size(mesh, "shard"):
            raise ValueError(f"{b.size} shard bases for a shard axis of "
                             f"{axis_size(mesh, 'shard')}")
        self.bases = torch.from_numpy(b.astype(np.int32)).to(self.dev)
        self.shard_g = mesh.get_group("shard")
        self.dp_g = mesh.get_group("dp")
        self.s = mesh.get_local_rank("shard")

    def score_args(self):
        """minsc_i, minsc_s and gap1, as the steps take them."""
        sc = self.sc
        return (float(sc.score_min.I), float(sc.score_min.S),
                min(sc.read_gap_open(), sc.ref_gap_open()))

    def seed_args(self, L: int):
        """B to ftab_k, in the steps' order."""
        o, al = self.o, self.al
        return (self.Bl, L, o.max_seeds, o.n_seeds, o.locs_per_seg,
                o.top_cands, al.min_seg_len, al.fm.ftab_k)

    def bucket_args(self):
        """fb_bucket to sc_const, in the steps' order."""
        o, al, Bl = self.o, self.al, self.Bl
        return (min(Bl, max(32, Bl // 8)), min(Bl, max(64, Bl // 8)),
                o.dp_pad, o.no_dp, o.nofw, o.norc, al.seeder, al.fb_seeder,
                al.sc_const)


def fused_se_sharded(mesh, aligner, bases, idx_stack: dict, B: int, L: int):
    """The FULL fused SE step over the (dp, shard) mesh.

    aligner: the statics of shard 0 (shard_aligner; all shards share
    shapes); idx_stack: this rank's shard (shard_aligner's `idx`, or
    stack_shard_indexes).
    Returns fn(sctab, seq_w, n_w, qconst, lens) on this rank's dp block
    (shard_batch) -> (fp_global (Bl, W) int16, multi (Bl,) bool,
    merged_all (Bl, S*K2, 3) int32 [global coords, score-sorted],
    aligned_total, multi_total [whole-batch sums over dp]).
    Constant-quality batches only."""
    st = _Step(mesh, aligner, bases, B)
    o = st.o
    KF = max(1, min(o.khits, 5))

    def fn(sctab, seq_w, n_w, qconst, lens):
        fp, merged = _stage_align_packed(
            idx_stack, sctab, seq_w, n_w, None, int(qconst), lens,
            *st.score_args(), *st.seed_args(L), st.K2, KF,
            *st.bucket_args())
        # record all-gather across genome shards
        fps = gather(fp.to(I32), st.shard_g)             # (S, Bl, W)
        mg = gather(merged, st.shard_g)                  # (S, Bl, K2, 3)
        fp_g, multi = _merge_fp_device(fps, st.bases, KF)
        mall = _sort_by_score(_to_global(mg, st.bases, st.Bl))
        # whole-batch summary counters: sums over the dp axis
        aligned_total = psum((fp_g[:, 0] >= 1).sum(), st.dp_g)
        multi_total = psum((fp_g[:, 0] >= 2).sum(), st.dp_g)
        return fp_g, multi, mall, aligned_total, multi_total
    return fn


def fused_rna_sharded(mesh, aligner, bases, idx_stack: dict, B: int, L: int,
                      kss):
    """The fused SPLICED SE step (SE core + device splice pass 1,
    _stage_align_packed with spliced=True) over the (dp, shard) mesh.
    Junction lanes all-gather across genome shards with posA/posB
    rebased to global coordinates, so the host splice rescue sees one
    global lane set per read (the reference's equivalent search is
    SplicedAligner::hybridSearch_recur, spliced_aligner.h:331).

    kss: the known-site tuple of SpliceSiteDB.device_arrays4(device) in
    global coordinates; each rank shifts it into its shard's frame.
    Returns fn(sctab, seq_w, n_w, qconst, lens) -> (fp_global, multi,
    lanes32 (S*NL, 2) int32 [global coords], lanes16 (S*NL, 5) int16
    [lane meta, row ids local to the dp block], cov (Bl,) int32,
    aligned_total)."""
    st = _Step(mesh, aligner, bases, B)
    o, sc, Bl = st.o, st.sc, st.Bl
    KF = max(1, min(o.khits, 5))
    TB = min(Bl, max(256, 5 * Bl // 8))
    SPL = (TB, o.pairs_per_read, min(TB, max(128, TB // 4)), 4,
           2 * TB, o.dta, max(1, min(8, -(-o.max_intron // 65536))))
    # splice-trigger margin for constant-quality-40 batches (the
    # aligner's _spl_margin with qmin = 40)
    margin = MIN_ANCHOR_CANON * min(int(sc.sc_pens()[40]),
                                    int(sc.mm_pens()[40]))
    base = st.bases[st.s]
    # known sites are global; shift them into this shard's local frame
    # (sentinel rows stay past any local position)
    kss_s = tuple(torch.where(a == SENTINEL, a, a - base) for a in kss)

    def fn(sctab, seq_w, n_w, qconst, lens):
        fp, _merged, extras = _stage_align_packed(
            idx_stack, sctab, seq_w, n_w, None, int(qconst), lens,
            *st.score_args(), *st.seed_args(L), st.K2, KF,
            *st.bucket_args(), SB=Bl, spliced=True, spl_margin=margin,
            spl_kss=kss_s,
            spl_nceil=(float(sc.n_ceil.I), float(sc.n_ceil.S)),
            spl_introns=(o.min_intron, o.max_intron), SPL=SPL)
        fps = gather(fp.to(I32), st.shard_g)
        fp_g, multi = _merge_fp_device(fps, st.bases, KF)
        sp32 = extras["splanes32"]            # (NL, 2) posA/posB local
        sp16 = extras["splanes16"]            # (NL, 5) row/fw/score/j/fl
        live = (sp16[:, 4] != 0)[:, None]
        sp32g = torch.where(live, sp32 + base, 0)
        l32 = gather(sp32g, st.shard_g).reshape(-1, 2)
        l16 = gather(sp16.to(I32), st.shard_g).reshape(-1, 5).to(
            torch.int16)
        cov = gather(extras["spl_cov"], st.shard_g)
        # a row is device-covered only if EVERY shard covered it (bit 0
        # set on all shards, overflow bit 1 on none)
        cov_all = ((cov & 1).amin(dim=0)
                   | (((cov >> 1) & 1).amax(dim=0) << 1))
        aligned_total = psum((fp_g[:, 0] >= 1).sum(), st.dp_g)
        return fp_g, multi, l32, l16, cov_all, aligned_total
    return fn


def fused_pe_sharded(mesh, aligner, bases, idx_stack: dict, B: int, L: int):
    """The FULL fused PE step over the (dp, shard) mesh (SE analogue:
    fused_se_sharded). Returns fn(sctab, sw1, nw1, l1, sw2, nw2, l2,
    qconst) -> (pack_global (Bl, PEPACK_W + 1) int16, force_slow (Bl,)
    bool, m1_all/m2_all (Bl, S*K2, 3) int32 [global coords, UNSORTED so
    pair_top indices stay valid], pt_all (Bl, S*KP, 3) [t1/t2 remapped
    into the concatenated grids, sorted by total], conc_total [sum over
    dp]). Constant-quality batches only."""
    st = _Step(mesh, aligner, bases, B)
    o, K2, Bl = st.o, st.K2, st.Bl
    KP = max(8, o.khits + 3)

    def fn(sctab, sw1, nw1, l1, sw2, nw2, l2, qconst):
        pack, m1, m2, pt, _extras = _stage_pe_packed_impl(
            idx_stack, sctab, sw1, nw1, l1, sw2, nw2, l2, int(qconst),
            *st.score_args(), o.minins, o.maxins, *st.seed_args(L), K2,
            KP, *st.bucket_args(), o.fr,
            (o.dovetail, o.no_contain, o.no_overlap), VC=0, khits=None,
            SB=0, RB=0, w_resc=0, omit_sec=False,
            n_rep=max(2, min(o.khits, 5)), MB=0, wire_nvbits=0)
        packs = gather(pack.to(I32), st.shard_g)         # (S, Bl, W+1)
        m1g = gather(m1, st.shard_g)                     # (S, Bl, K2, 3)
        m2g = gather(m2, st.shard_g)
        ptg = gather(pt, st.shard_g)                     # (S, Bl, KP, 3)
        pack_g, force_slow = _merge_pe_pack_device(packs, st.bases)
        S = ptg.shape[0]
        offs = torch.arange(S, dtype=ptg.dtype,
                            device=ptg.device)[:, None, None] * K2
        ptm = torch.stack([ptg[:, :, :, 0], ptg[:, :, :, 1] + offs,
                           ptg[:, :, :, 2] + offs], dim=3)
        ptm = _sort_by_score(ptm.movedim(0, 1).reshape(Bl, -1, 3))
        conc_total = psum((pack_g[:, 0] >= 1).sum(), st.dp_g)
        return (pack_g, force_slow, _to_global(m1g, st.bases, Bl),
                _to_global(m2g, st.bases, Bl), ptm, conc_total)
    return fn
