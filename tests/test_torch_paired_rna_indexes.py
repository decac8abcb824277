"""Spliced (RNA) paired-end alignment on other indexes and paths, the
port against the JAX package: SAM bytes, stats and the published novel
sites must be equal.

On the genome and pair sets of tests/test_torch_paired_rna_pipeline.py:
seed_mode=False with known sites (each mate's per-read path, then the
per-pair ladder) and FM seeding (the index without its k-mer table) with
dta. On the graph (SNP) index of tests/test_torch_graph_index.py with
known splice sites: 32 pairs cut from a haplotype with every variant
applied, mate 1 over a known junction, through the stream, and with Zs:Z
tags, which take the fused step, each mate's splice rescue and the
per-pair ladder."""

import numpy as np
import pytest
import torch

from test_torch_graph_index import graph_world
import test_torch_native_cache  # noqa: F401  (JAX native libs, built once under a lock)
from test_torch_graph_pipeline import haplotype
from test_torch_paired_rna_pipeline import L, PAIRS, both, sharded_world, \
    to_batches
from hisat2_tpu.utils import alphabet as jalphabet

torch.set_num_threads(1)

GRAPH_JUNCTIONS = [(2500, 400), (6000, 900), (11000, 1500), (17000, 250),
                   (23000, 700)]


def graph_pairs(codes, snps):
    """PAIRS pairs on the graph index: mate 1 over a known junction (one in
    three with a mismatch), mate 2 downstream, both from a haplotype with
    every variant applied."""
    rng = np.random.default_rng(909)
    pairs = []
    for k in range(PAIRS):
        s, il = GRAPH_JUNCTIONS[k % len(GRAPH_JUNCTIONS)]
        j = int(rng.integers(10, 90))
        m1 = np.concatenate([haplotype(codes, snps, s - j, j, rng, 1.0),
                             haplotype(codes, snps, s + il, L - j, rng,
                                       1.0)])
        s2 = s + il + (L - j) + int(rng.integers(30, 200))
        m2 = jalphabet.revcomp(haplotype(codes, snps, s2, L, rng, 1.0))
        if k % 3 == 0:
            m1[rng.integers(0, L)] ^= 1
        pairs.append((f"g{k}", m1, m2))
    return pairs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = sharded_world()
    gw = graph_world(tmp_path_factory.mktemp("graph_pe_rna"))
    w["jfms"]["graph"] = gw["jfm"]
    w["refs"]["graph"] = gw["ref"]
    w["sites"]["graph"] = [(s - 1, s + il) for s, il in GRAPH_JUNCTIONS]
    w["sets"]["graph"] = to_batches(graph_pairs(gw["codes"], gw["snps"]))
    return w


CASES = [
    ("seed_mode_false", "table", "mix0", True, dict(seed_mode=False)),
    ("fm_dta", "fm", "mix0", False, dict(dta=True)),
    ("graph_known", "graph", "graph", True, {}),
    ("graph_known_zs", "graph", "graph", True, dict(zs_tags=True)),
]


@pytest.mark.parametrize("name,index,pairs,known,opts", CASES,
                         ids=[c[0] for c in CASES])
def test_spliced_pe_sam_equals_jax(world, name, index, pairs, known, opts):
    _, aligned, spliced = both(world, "stream", index, pairs, known, **opts)
    assert len(spliced) >= 20
    assert len(aligned) >= 50
