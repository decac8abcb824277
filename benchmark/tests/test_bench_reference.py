"""The kernels' references held to the program's plain versions: the
frozen DP against ops/sw.dp_fill_plain, the anchor scan worked out from
the genome against ops/splice.anchor_scan_plain_core on the program's
packed text; and the lower precisions of the control."""

import os

import numpy as np
import pytest
import torch

from harness import deploy
from reference import anchor as anchor_ref
from reference.dp import dp_fill

TESTS = os.path.dirname(os.path.abspath(__file__))
CONSTS = dict(match_bonus=0, n_pen=1, rd_open=8, rd_ext=3, rf_open=8,
              rf_ext=3)


def dp_case(seed, C=64, L=104, W=136, ov=False):
    g = torch.Generator().manual_seed(seed)
    ref = torch.randint(0, 4, (C, W), generator=g, dtype=torch.int32)
    rd = torch.randint(0, 4, (C, L), generator=g, dtype=torch.int32)
    off = torch.randint(0, W - L, (C,), generator=g)
    for c in range(C // 2):                  # half the reads from the window
        rd[c] = ref[c, off[c]:off[c] + L]
    rd[torch.rand((C, L), generator=g) < 0.02] = 4
    rdlens = torch.randint(L - 10, L + 1, (C,), generator=g,
                           dtype=torch.int32)
    pen = torch.randint(2, 7, (C, L), generator=g, dtype=torch.int32)
    scp = torch.randint(1, 3, (C, L), generator=g, dtype=torch.int32)
    scp = scp * (torch.arange(L)[None, :] < rdlens[:, None])
    scp_cum = torch.cat([torch.zeros((C, 1), dtype=torch.int32),
                         torch.cumsum(scp, 1, dtype=torch.int32)], 1)
    ovt = (torch.randint(0, 16, (C, W), generator=g, dtype=torch.int32)
           if ov else None)
    return rd, pen, rdlens, ref, scp_cum.contiguous(), ovt


@pytest.mark.parametrize("seed,W,ov", [(1, 136, False), (2, 136, True),
                                       (3, 400, False)])
def test_dp_reference_is_the_plain_fill(seed, W, ov):
    from hisat2_tpu_torch.ops.sw import dp_fill_plain
    rd, pen, rdlens, ref, scp_cum, ovt = dp_case(seed, W=W, ov=ov)
    want = dp_fill_plain(rd, pen, rdlens, ref, scp_cum, ov=ovt, **CONSTS)
    got = dp_fill(rd, pen, rdlens, ref, scp_cum, ov=ovt, **CONSTS)
    assert torch.equal(got, want)
    assert torch.equal(dp_fill(rd, pen, rdlens, ref, scp_cum, ov=ovt,
                               bits=16, **CONSTS), want)


def test_dp_lower_precisions_differ():
    """int16 holds these windows exactly; int8 and int4 saturate."""
    rd, pen, rdlens, ref, scp_cum, _ = dp_case(4)
    want = dp_fill(rd, pen, rdlens, ref, scp_cum, **CONSTS)
    for bits in (8, 4):
        got = dp_fill(rd, pen, rdlens, ref, scp_cum, bits=bits, **CONSTS)
        assert not torch.equal(got, want)


def test_anchor_reference_is_the_plain_core(tiny_cache):
    from hisat2_tpu_torch.index.fm_index import FMIndex
    from hisat2_tpu_torch.ops import splice
    dep = deploy.load("tiny_rna", os.path.join(TESTS, "configs",
                                               "tiny_rna.json"), tiny_cache)
    fm = FMIndex.load(dep.index)
    rows = fm.device_bundle("cpu")["text_rows"]
    rng = np.random.default_rng(8)
    S, A, W = 300, 8, 1024
    n = dep.genome.size
    pos = rng.integers(0, n - 60_000, S)
    down = rng.random(S) < 0.5
    rdlens = np.full(S, 100)
    # half the anchors copied from the genome a little way off
    far = pos + np.where(down, 500 + rng.integers(0, 3000, S),
                         -rng.integers(600, 3000, S))
    far = np.clip(far, 0, n - A)
    acode = np.array([sum(int(dep.genome[f + k]) << (2 * k)
                          for k in range(A)) for f in far])
    acode[::2] = rng.integers(0, 4 ** A, S)[::2]
    has_n = rng.random(S) < 0.05
    live = rng.random(S) < 0.9
    for tiles in (1, 4):
        t = {k: torch.as_tensor(v) for k, v in dict(
            pos=pos.astype(np.int32), down=down,
            rdlens=rdlens.astype(np.int32), acode=acode.astype(np.int64),
            has_n=has_n, live=live).items()}
        kv, mpos = splice.anchor_scan_plain_core(
            rows, t["pos"], t["down"], t["rdlens"], t["acode"], t["has_n"],
            t["live"], 60, W=W, A=A, NC=4, tiles=tiles)
        kx = anchor_ref.KmerIndex(dep.genome, A)
        ins = dict(pos=pos, down=down, rdlens=rdlens, acode=acode,
                   has_n=has_n, live=live, min_intron=60, W=W, A=A, NC=4,
                   tiles=tiles)
        wrong, compared = anchor_ref.count_wrong(kx, ins, kv.numpy(),
                                                 mpos.numpy())
        assert compared > 200 and wrong == 0
        # and a moved answer is caught
        bad = mpos.numpy() + 16 * kv.numpy()
        assert anchor_ref.count_wrong(kx, ins, kv.numpy(), bad)[0] > 0
